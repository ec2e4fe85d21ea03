"""The plain reference against the port on the CPU: round for round, field
for field; optima against the port's solver; the payload checks.  (The
tests may import the port; the reference may not.)"""

from __future__ import annotations

import numpy as np
import pytest

from portbench import generate
from portbench.lanes import to_numpy
from portbench.reference import ds as rds
from portbench.reference import engine
from portbench.reference import vc as rvc
from portbench.reference.bits import pack, unpack


def _port_problem(family, dense):
    from repro_torch.problems.dominating_set import make_dominating_set
    from repro_torch.problems.graphs import Graph
    from repro_torch.problems.vertex_cover import make_vertex_cover
    make = make_vertex_cover if family == "vc" else make_dominating_set
    return make(Graph(n=dense.shape[0], adj=pack(dense)), device="cpu")


CASES = [("vc", generate.reg(40, 4, 3), 32, 8),
         ("ds", generate.gnp(30, 0.15, 2), 32, 8),
         ("vc", generate.gnp(50, 0.15, 7), 64, 16)]


@pytest.mark.parametrize("family,dense,lanes,steps", CASES)
def test_reference_follows_the_port_round_for_round(family, dense, lanes,
                                                    steps):
    from repro_torch.core.distributed import make_round
    from repro_torch.core.engine import init_lanes
    prob = _port_problem(family, dense)
    node = (rvc if family == "vc" else rds).NODE(dense)
    round_fn = make_round(prob, steps)
    lanes_t = init_lanes(prob, lanes)
    ref_lanes = engine.init_lanes(node, lanes)
    assert not any(engine.mismatches(ref_lanes, to_numpy(
        lanes_t, node.leaves)).values())
    for _ in range(200):
        before = to_numpy(lanes_t, node.leaves)
        lanes_t, work = round_fn(lanes_t)
        want, ref_work = engine.round_(node, before, steps)
        assert engine.mismatches(want, to_numpy(lanes_t, node.leaves)) == \
            dict.fromkeys(engine.mismatches(want, want), 0)
        assert int(work.sum()) == int(ref_work.sum())
        if int(work.sum()) == 0:
            break
    else:
        pytest.fail("no drain in 200 rounds")


@pytest.mark.parametrize("family,dense,lanes,steps", CASES)
def test_reference_solve_equals_the_port_solver(family, dense, lanes, steps):
    from repro_torch.solver import Solver, SolverConfig
    node = (rvc if family == "vc" else rds).NODE(dense)
    got = Solver(SolverConfig(lanes=lanes, steps_per_round=steps,
                              device="cpu")).solve(
        _port_problem(family, dense)).stats
    want, _ = engine.solve(node, lanes, steps)
    for c in ("best", "rounds", "nodes", "t_s", "t_r", "donated"):
        assert getattr(got, c) == want[c], c


@pytest.mark.parametrize("seed", [3, 11, 2 ** 31 + 9])
def test_serial_vc_optimum_equals_the_port_oracle(seed):
    from repro_torch import registry
    from repro_torch.problems.graphs import Graph
    from repro_torch.solver import Solver, SolverConfig
    dense = generate.gnp(30, 0.2, generate.instance_seed(seed, 0))
    handle = registry.problem("vc", Graph(n=30, adj=pack(dense)))
    ref = Solver(SolverConfig(device="cpu")).oracle(handle)
    assert rvc.optimum(dense) == ref.best
    assert rvc.optimum(dense, slack=1) >= ref.best


def test_payload_checks_catch_a_bad_answer():
    dense = generate.gnp(20, 0.3, 4)
    _, lanes = engine.solve(rvc.NODE(dense), 16, 8)
    best, payload = int(lanes["best"][0]), lanes["best_payload"][0]
    assert rvc.payload_faults(dense, payload, best) == 0
    bits = unpack(payload, 32)
    v = int(np.nonzero(bits[:20])[0][0])
    bits[v] = False
    assert rvc.payload_faults(dense, pack(bits), best) > 0
    assert rvc.payload_faults(dense, payload, best + 1) > 0
    _, lanes = engine.solve(rds.NODE(dense), 16, 8)
    best, payload = int(lanes["best"][0]), lanes["best_payload"][0]
    assert rds.payload_faults(dense, payload, best) == 0
    assert rds.payload_faults(dense, np.zeros_like(payload), 0) > 0


def test_the_reference_imports_nothing_of_the_program():
    import subprocess
    import sys
    code = ("import sys; import portbench.reference.engine, "
            "portbench.reference.vc, portbench.reference.ds; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('repro', 'repro_torch', 'torch', 'jax')); print(bad)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True,
                         cwd=str(__import__("pathlib").Path(
                             __file__).resolve().parent.parent))
    assert out.stdout.strip() == "[]"

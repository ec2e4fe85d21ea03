"""Subset sum in the port against the JAX reference's
``repro.problems.subset_sum``: the instance parser, ``NodeEval`` on random
states, ``Lanes`` after every round and ``SolveStats`` of whole solves,
bit for bit, and the CLI's result line."""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import registry as jregistry
from repro.core import distributed as jdist
from repro.core import engine as jengine
from repro.core.serial import serial_rb as j_serial_rb
from repro.launch import solve as j_solve
from repro.problems.subset_sum import SSState as JSS
from repro.problems.subset_sum import make_subset_sum as j_make_ss
from repro.problems.subset_sum import make_subset_sum_py as j_make_ss_py
from repro.problems.subset_sum import parse_ss_instance as j_parse
from repro.solver import Solver as JSolver
from repro.solver import SolverConfig as JConfig
from repro_torch import registry
from repro_torch.convert import to_torch
from repro_torch.core import distributed as tdist
from repro_torch.core import engine as tengine
from repro_torch.core.serial import serial_rb
from repro_torch.launch import solve
from repro_torch.problems.subset_sum import (SSState, make_subset_sum,
                                             make_subset_sum_py,
                                             parse_ss_instance)
from repro_torch.service import AdmissionError, SolveRequest
from repro_torch.solver import Solver, SolverConfig
from test_torch_engine import assert_lanes_equal
from test_torch_node_eval import assert_node_eval_equal

SPECS = ("ss:8:1", "ss:12:3", "ss:14:5", "ss:16:7")
BOOT = dict(bootstrap_rounds=4, bootstrap_steps=8, steps_per_round=64)


@pytest.mark.parametrize("spec", SPECS + ("ss:1:0", "ss:30:9", "ss:60:4"))
def test_parse_equals_reference(spec):
    got, want = parse_ss_instance(spec), j_parse(spec)
    assert tuple(got) == tuple(want)
    assert got.n == want.n


@pytest.mark.parametrize("spec", ["ss:0:1", "ss:5", "gnp:10:30:1",
                                  "ss:a:1"])
def test_parse_refuses_what_the_reference_refuses(spec):
    with pytest.raises(ValueError) as got:
        parse_ss_instance(spec)
    with pytest.raises(ValueError) as want:
        j_parse(spec)
    assert str(got.value) == str(want.value)


def random_states(rng, inst, lanes):
    """Random subset-sum states, with a solution, an overshoot, an
    unreachable target, a finished wrong sum and the root among them."""
    n, tgt = inst.n, inst.target
    pos = rng.randint(0, n + 2, size=lanes).astype(np.int32)
    mask = (rng.rand(lanes, n) < 0.4).astype(np.int32)
    vals = np.asarray(inst.values, np.int32)
    total = (mask * vals).sum(axis=1).astype(np.int32)
    count = mask.sum(axis=1).astype(np.int32)
    total[0], pos[0] = tgt, n                     # a solution leaf
    total[1] = tgt + 5                            # overshoot
    total[2], pos[2] = 0, n - 1                   # unreachable
    total[3], pos[3] = tgt - 1, n                 # finished, wrong sum
    pos[4] = total[4] = count[4] = 0              # the root
    mask[4] = 0
    return JSS(pos=pos, total=total, count=count, mask=mask)


@pytest.mark.parametrize("spec,lanes", [("ss:12:3", 16), ("ss:16:2", 9)])
def test_node_eval_equals_reference(spec, lanes):
    inst = parse_ss_instance(spec)
    rng = np.random.RandomState(lanes)
    states = random_states(rng, inst, lanes)
    best = rng.randint(0, inst.n + 1, size=lanes).astype(np.int32)
    best[0] = 2 ** 30
    jp = j_make_ss(inst.values, inst.target)
    want = jax.tree_util.tree_map(np.asarray, jax.vmap(jp.evaluate)(
        jax.tree_util.tree_map(jnp.asarray, states), jnp.asarray(best)))
    tp = make_subset_sum(inst.values, inst.target, device="cpu")
    like = tengine.init_lanes(tp, 1).stack
    got = tp.evaluate_batch(to_torch(states, like, "cpu"),
                            to_torch(best, None, "cpu"))
    assert_node_eval_equal(got, want, SSState)


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("lanes", [1, 4, 16])
def test_lanes_equal_after_every_round(spec, lanes):
    """``make_round`` until the solve drains: every Lanes array equal to
    the reference's after every round."""
    inst = parse_ss_instance(spec)
    jp = j_make_ss(inst.values, inst.target)
    tp = make_subset_sum(inst.values, inst.target, device="cpu")
    jl, tl = jengine.init_lanes(jp, lanes), tengine.init_lanes(tp, lanes)
    assert_lanes_equal(tl, jl, "init")
    j_round = jax.jit(jdist.make_round(jp, 64))
    t_round = tdist.make_round(tp, 64)
    for r in range(400):
        jl, j_open = j_round(jl)
        tl, t_open = t_round(tl)
        assert_lanes_equal(tl, jl, f"round {r}")
        np.testing.assert_array_equal(t_open.numpy(), np.asarray(j_open))
        if int(t_open.sum()) == 0:
            break
    else:
        pytest.fail("did not drain in 400 rounds")


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("lanes", [1, 4, 16])
def test_solve_stats_equal_reference(spec, lanes):
    want = JSolver(JConfig(lanes=lanes, **BOOT)).solve(
        jregistry.problem("ss", spec))
    got = Solver(SolverConfig(lanes=lanes, device="cpu", **BOOT)).solve(
        registry.problem("ss", spec))
    assert got.stats == want.stats
    np.testing.assert_array_equal(got.payload.numpy(), want.payload)
    oracle = Solver(SolverConfig(device="cpu")).oracle(
        registry.problem("ss", spec))
    assert got.stats.best == oracle.best
    inst = parse_ss_instance(spec)
    mask = got.payload.numpy()
    assert mask.sum() == oracle.best
    assert int((mask * np.asarray(inst.values)).sum()) == inst.target


@pytest.mark.parametrize("spec", SPECS)
def test_serial_oracle_equals_reference(spec):
    inst = parse_ss_instance(spec)
    got = serial_rb(make_subset_sum_py(inst.values, inst.target),
                    record_visits=True)
    want = j_serial_rb(j_make_ss_py(inst.values, inst.target),
                       record_visits=True)
    assert got == want


def test_cli_prints_the_reference_result_line(monkeypatch, capsys):
    argv = ["solve", "--problem", "ss", "--instance", "ss:16:2", "--lanes",
            "8"]
    lines = []
    for module, extra in ((j_solve, []), (solve, ["--device", "cpu"])):
        monkeypatch.setattr(sys, "argv", argv + extra)
        module.main()
        out = capsys.readouterr().out
        line = [l for l in out.splitlines() if l.startswith("optimum=")][0]
        lines.append(line.rsplit(" wall=", 1)[0])
    assert lines[0] == lines[1]
    assert lines[1].startswith("optimum=6 ")


def test_not_servable():
    """No service packing: the service refuses subset sum at submit()."""
    svc = Solver(SolverConfig(lanes=4, device="cpu")).serve(max_n=16,
                                                            slots=1)
    with pytest.raises(AdmissionError, match="not servable"):
        svc.submit(SolveRequest(rid=0, graph=parse_ss_instance("ss:8:1"),
                                family="ss"))

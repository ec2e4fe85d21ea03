"""Checkpoints of the port against the JAX reference's, both ways.

A single solve saved by one package resumes in the other at another lane
count to the same optimum and the same summed ``SolveStats`` as the
reference's own resume; the same holds for a service checkpoint taken
mid-run with queued requests, whose restored queue pops in saved order.
The ``.npz`` files of the two packages hold the same keys, dtypes and
values for the same state, and ``repartition`` / ``install_pending`` give
the reference's lanes and pending pool.  Tolerance: bitwise (0).
"""

import jax
import numpy as np

from repro.core import checkpoint as j_ckpt
from repro.core.serial import serial_rb as j_serial_rb
from repro.core import distributed as jdist
from repro.core import engine as jengine
from repro.problems import graphs as jgraphs
from repro.service import SolveRequest as JRequest
from repro.service import SolverService as JService
from repro.solver import Solver as JSolver
from repro.solver import SolverConfig as JConfig
from repro_torch import registry
from repro_torch.convert import lanes_from_numpy
from repro_torch.core import checkpoint as ckpt
from repro_torch.problems import graphs as tgraphs
from repro_torch.service import SolveRequest, SolverService
from repro_torch.solver import Solver, SolverConfig
from test_torch_engine import assert_lanes_equal, build, numpy_tree
from test_torch_service import assert_services_equal, oracle

SOLVE = ("vc", "gnp:30:25:4")


def solve_cfg(**kw):
    return dict(steps_per_round=8, bootstrap_rounds=2, bootstrap_steps=4,
                **kw)


def ref_solve(path=None, resume=None, lanes=8, max_rounds=100000,
              solve=SOLVE):
    cfg = JConfig(lanes=lanes, backend="jnp", max_rounds=max_rounds,
                  checkpoint_every=2 if path else 0, checkpoint_path=path,
                  resume_from=resume, **solve_cfg())
    return JSolver(cfg).solve(JSolverProblem(solve)).stats


def JSolverProblem(solve=SOLVE):
    from repro import registry as jregistry
    return jregistry.problem(*solve)


def port_solve(path=None, resume=None, lanes=8, max_rounds=100000,
               solve=SOLVE):
    cfg = SolverConfig(lanes=lanes, device="cpu", max_rounds=max_rounds,
                       checkpoint_every=2 if path else 0,
                       checkpoint_path=path, resume_from=resume,
                       **solve_cfg())
    return Solver(cfg).solve(registry.problem(*solve)).stats


def assert_npz_equal(a, b):
    with np.load(a) as za, np.load(b) as zb:
        assert sorted(za.files) == sorted(zb.files)
        for key in za.files:
            assert za[key].dtype == zb[key].dtype, key
            np.testing.assert_array_equal(za[key], zb[key], err_msg=key)


def test_solve_checkpoints_cross_both_ways(tmp_path):
    """vc (a uint32 bitset payload) on 8 lanes and subset sum (an int32
    payload, written as int32 by both packages) on 4."""
    for solve, lanes0 in ((SOLVE, 8), (("ss", "ss:12:0"), 4)):
        tag = solve[0]
        j_path = str(tmp_path / f"j_{tag}.ckpt")
        t_path = str(tmp_path / f"t_{tag}.ckpt")
        # Both stop mid-solve at round 6, the last checkpoint.
        j_mid = ref_solve(path=j_path, lanes=lanes0, max_rounds=6,
                          solve=solve)
        t_mid = port_solve(path=t_path, lanes=lanes0, max_rounds=6,
                           solve=solve)
        assert tuple(t_mid) == tuple(j_mid) and j_mid.rounds == 6, solve
        assert_npz_equal(t_path, j_path)
        want_best = j_serial_rb(JSolverProblem(solve).oracle())[0]
        for lanes in (5, 12):
            ref_resumed = ref_solve(resume=j_path, lanes=lanes, solve=solve)
            assert ref_resumed.best == want_best, solve
            # The reference's file resumed by the port, and the port's
            # file resumed by the reference: both equal the reference's
            # own resume.
            assert tuple(port_solve(resume=j_path, lanes=lanes,
                                    solve=solve)) == tuple(ref_resumed)
            assert tuple(ref_solve(resume=t_path, lanes=lanes,
                                   solve=solve)) == tuple(ref_resumed)


def test_restore_repartition_install_pending_equal_reference(tmp_path):
    jp, tp = build("ds", "gnp:25:20:6")
    jl = jengine.init_lanes(jp, 10)
    j_round = jax.jit(jdist.make_round(jp, 6))
    for _ in range(4):
        jl, _ = j_round(jl)
    assert int(np.asarray(jl.active).sum()) > 4
    tl = lanes_from_numpy(numpy_tree(jl), tp)
    path = str(tmp_path / "mid.ckpt")
    j_ckpt.save(path, jl)
    for lanes in (4, 16):
        j_new, j_pool = j_ckpt.restore(path, jp, lanes)
        t_new, t_pool = ckpt.restore(path, tp, lanes)
        assert_lanes_equal(t_new, j_new, f"restore {lanes}")
        assert_pools_equal(t_pool, j_pool)

        j_new, j_pool = j_ckpt.repartition(jp, jl, lanes)
        t_new, t_pool = ckpt.repartition(tp, tl, lanes)
        assert_lanes_equal(t_new, j_new, f"repartition {lanes}")
        assert_pools_equal(t_pool, j_pool)

    j_small, j_pool = j_ckpt.repartition(jp, jl, 3)
    t_small, t_pool = ckpt.repartition(tp, tl, 3)
    assert len(j_pool) > 1
    # Idle lanes appear after a round; feed the pool to them.
    j_small, _ = j_round(j_small)
    t_small = lanes_from_numpy(numpy_tree(j_small), tp)
    j_fed, j_rest = j_ckpt.install_pending(jp, j_small, j_pool)
    t_fed, t_rest = ckpt.install_pending(tp, t_small, t_pool)
    assert_lanes_equal(t_fed, j_fed, "install_pending")
    assert_pools_equal(t_rest, j_rest)


def assert_pools_equal(t_pool, j_pool):
    assert len(t_pool) == len(j_pool)
    for t, j in zip(t_pool, j_pool):
        np.testing.assert_array_equal(t.idx, j.idx)
        assert (t.depth, t.base, t.inst) == (j.depth, j.base, j.inst)


#: Six requests over two slots: four are still queued after round 1.
SVC_MIX = [("vc", "gnp:18:30:5", {}), ("ds", "gnp:16:30:7", {}),
           ("vc", "reg:18:3:2", {"priority": 2}), ("ds", "gnp:14:25:2", {}),
           ("vc", "gnp:16:35:9", {"deadline_rounds": 40}),
           ("ds", "gnp:15:30:3", {"priority": 1})]


def mid_run_services(tmp_path):
    """Reference and port services driven in lockstep for two rounds,
    then saved by each."""
    jsvc = JSolver(JConfig(lanes=12, steps_per_round=6, backend="jnp",
                           scheduler="priority")).serve(max_n=18, slots=2)
    tsvc = Solver(SolverConfig(lanes=12, steps_per_round=6, device="cpu")
                  ).serve(max_n=18, slots=2)
    for i, (f, s, kw) in enumerate(SVC_MIX):
        jsvc.submit(JRequest(rid=i, graph=jgraphs.parse_graph_instance(s),
                             family=f, **kw))
        tsvc.submit(SolveRequest(rid=i, graph=tgraphs.parse_graph_instance(s),
                                 family=f, **kw))
    for _ in range(2):
        jsvc.step_round()
        tsvc.step_round()
    assert len(jsvc.queue) >= 3
    paths = str(tmp_path / "j_svc.ckpt"), str(tmp_path / "t_svc.ckpt")
    jsvc.save(paths[0])
    tsvc.save(paths[1])
    return jsvc, tsvc, paths


def test_service_checkpoints_cross_both_ways(tmp_path):
    jsvc, tsvc, (j_path, t_path) = mid_run_services(tmp_path)
    assert_npz_equal(t_path, j_path)
    saved_order = [r.rid for r in jsvc.queue]
    for src in (j_path, t_path):
        # The reference's own restore at 7 lanes is the yardstick; the
        # port restores the same file at 7 lanes and must follow it round
        # for round, with the restored queue popping in saved order.
        ref = JService.restore(src, num_lanes=7, steps_per_round=6,
                               backend="jnp")
        port = SolverService.restore(src, num_lanes=7, steps_per_round=6,
                                     device="cpu")
        assert [r.rid for r in port.queue] == saved_order
        assert_services_equal(port, ref, "restored")
        admitted = []
        while ref._has_work():
            ref.step_round()
            port.step_round()
            assert_services_equal(port, ref, f"round {port.rounds}")
            admitted += [r for r in port.slot_rid
                         if r >= 0 and r not in admitted]
        assert not port._has_work()
        assert [r for r in admitted if r in saved_order] == saved_order
        for rid, (f, s, _) in enumerate(SVC_MIX):
            assert port.results[rid].status == "done"
            assert port.results[rid].optimum == oracle(f, s)

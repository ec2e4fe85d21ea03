"""Every placement replays only the lanes it wrote.

``SolverService._admit_and_place`` seeds fresh roots and installs
pending-pool tasks on idle lanes; ``checkpoint.restore``,
``repartition`` and ``install_pending`` place tasks on lanes too.  Each
then calls ``ckpt.rebuild_stacks`` with those lanes, which replays them in
as many passes as the deepest of them.  At every such rebuild, the
targeted replay's ``Lanes`` equal a whole-pool replay of the same input
(every active lane, IDX_LEN passes), bitwise.  That holds only because
replaying an untouched active lane gives back its stack (the determinism
contract, DESIGN.md §4).  ``checkpoint.REBUILDS`` counts 0 passes for an
admission of roots and the deepest placed task's depth otherwise.
Every request's optimum is the serial oracle's.

Pure PyTorch on the CPU: no ``jax``, no ``repro``.
"""

import numpy as np
import pytest
import torch

from repro_torch import registry
from repro_torch.core import checkpoint as ckpt
from repro_torch.core.api import tree_leaves, tree_map
from repro_torch.core.distributed import Mesh, make_round
from repro_torch.core.engine import init_lanes, replay_path
from repro_torch.core.serial import serial_rb
from repro_torch.problems.graphs import parse_graph_instance
from repro_torch.service import SolveRequest
from repro_torch.solver import Solver, SolverConfig

MIX = {
    "vc": ["gnp:30:20:3", "reg:28:4:2", "gnp:34:15:8", "gnp:24:25:1",
           "gnp:32:18:4", "reg:30:3:5"],
    "ds": ["gnp:22:20:6", "gnp:20:15:3", "gnp:24:18:2", "gnp:18:25:4",
           "gnp:21:20:7", "gnp:23:16:5"],
}


def assert_same_lanes(a, b, where):
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert x.dtype == y.dtype and torch.equal(x, y), where


def whole_pool_rebuild(problem, lanes):
    """CONVERTINDEX of every lane in IDX_LEN passes, the replay's rows
    kept for the active lanes: the oracle a targeted rebuild must equal."""
    bits = torch.where(lanes.idx < 0, 0, lanes.idx).to(torch.int8)
    inst = lanes.inst.clamp(0, lanes.best.shape[0] - 1)
    stacks = replay_path(problem, bits, lanes.depth, lanes.stack, inst)
    stack = tree_map(
        lambda new, old: torch.where(
            lanes.active.reshape((-1,) + (1,) * (old.dim() - 1)), new, old),
        stacks, lanes.stack)
    return lanes._replace(stack=stack)


def checked_rebuilds(monkeypatch):
    """Route ``ckpt.rebuild_stacks`` through a check: its result must
    equal the whole-pool replay of the same input.  Returns the list of
    calls that ran, each its touched-lane count, the deepest touched depth
    and the passes ``REBUILDS`` counted for it."""
    real = ckpt.rebuild_stacks
    calls = []

    def checked(problem, lanes, touched, depth):
        before = ckpt.REBUILDS["passes"]
        out = real(problem, lanes, touched, depth)
        if not touched.any():
            assert out is lanes                   # nothing ran
            return out
        assert_same_lanes(out, whole_pool_rebuild(problem, lanes),
                          f"rebuild {len(calls)}")
        np.testing.assert_array_equal(depth, lanes.depth.cpu().numpy())
        assert bool(lanes.active.cpu().numpy()[touched].all())
        calls.append(dict(lanes=int(touched.sum()),
                          deepest=int(depth[touched].max()),
                          passes=ckpt.REBUILDS["passes"] - before))
        return out

    monkeypatch.setattr(ckpt, "rebuild_stacks", checked)
    return calls


def drive(svc, requests, resize_at=None, max_rounds=600):
    """Submit ``requests`` ((family, spec) each) and drain them, taking
    ``svc.resize(**resize_at[r])`` before round r; every optimum must be
    the serial oracle's."""
    for rid, (family, spec) in enumerate(requests):
        svc.submit(SolveRequest(rid=rid, family=family,
                                graph=parse_graph_instance(spec)))
    while svc._has_work():
        if resize_at is not None and svc.rounds in resize_at:
            svc.resize(**resize_at[svc.rounds])
        svc.step_round()
        assert svc.rounds < max_rounds
    for rid, (family, spec) in enumerate(requests):
        want = serial_rb(registry.problem(family, spec).oracle())[0]
        assert svc.results[rid].optimum == want, (rid, spec)


@pytest.mark.parametrize("family", ["vc", "ds"])
@pytest.mark.parametrize("seed", [0, 1])
def test_admission_replays_only_its_roots(monkeypatch, family, seed):
    """No pending pool: every admission seeds roots, so every targeted
    rebuild runs 0 passes and equals the whole-pool replay.  Ten requests
    drawn from the mix by ``seed`` pass through two slots."""
    calls = checked_rebuilds(monkeypatch)
    order = np.random.RandomState(seed).randint(0, len(MIX[family]), 10)
    svc = Solver(SolverConfig(lanes=64, steps_per_round=8,
                              device="cpu")).serve(max_n=34, slots=2)
    ckpt.reset_rebuilds()
    drive(svc, [(family, MIX[family][j]) for j in order])
    assert len(calls) >= 8
    assert all(c["deepest"] == c["passes"] == 0 for c in calls)
    assert ckpt.REBUILDS["passes"] == 0
    assert ckpt.REBUILDS["lanes"] == sum(c["lanes"] for c in calls) \
        == len(order)


@pytest.mark.parametrize("family", ["vc", "ds"])
def test_pool_installs_replay_to_the_deepest_task(monkeypatch, family):
    """A resize from 64 lanes to 16 parks the surplus tasks in the pending
    pool; the resizes and the admissions that install the surplus each
    replay exactly as many passes as the deepest task they placed, and
    equal the whole-pool replay."""
    calls = checked_rebuilds(monkeypatch)
    svc = Solver(SolverConfig(lanes=64, steps_per_round=8,
                              device="cpu")).serve(max_n=34, slots=3)
    drive(svc, [(family, spec) for spec in MIX[family]], resize_at={
        3: dict(num_lanes=16), 9: dict(num_lanes=48)})
    deep = [c for c in calls if c["deepest"] > 0]
    assert deep, "no admission installed a task below its root"
    assert all(c["passes"] == c["deepest"] for c in calls)


def test_each_shard_replays_the_lanes_it_owns(monkeypatch):
    """On a mesh of two CPU shards each shard's rebuild takes its own
    touched lanes and depth; a shard with none runs nothing."""
    calls = checked_rebuilds(monkeypatch)
    mesh = Mesh(["cpu"] * 2)
    svc = Solver(SolverConfig(lanes=24, steps_per_round=8, device="cpu",
                              mesh=mesh)).serve(max_n=34, slots=2)
    drive(svc, [("vc", spec) for spec in MIX["vc"][:4]],
          resize_at={3: dict(mesh=mesh, num_lanes=8)})
    assert calls and all(c["passes"] == c["deepest"] for c in calls)


@pytest.mark.parametrize("family", ["vc", "ds"])
def test_restore_and_resize_replay_only_the_installed_lanes(
        monkeypatch, tmp_path, family):
    """A checkpoint of 32 lanes restored onto 8, a ``repartition`` of those
    8 onto 16 and an ``install_pending`` of the surplus onto the 8 idle
    lanes each rebuild exactly the lanes they placed, in as many passes as
    the deepest of them, and equal the whole-pool replay bitwise."""
    calls = checked_rebuilds(monkeypatch)
    spec = {"vc": "gnp:50:10:3", "ds": "gnp:40:10:6"}[family]
    problem = registry.problem(family, spec).build(device="cpu")
    lanes = init_lanes(problem, 32)
    round_fn = make_round(problem, 4)
    for _ in range(6):
        lanes, _ = round_fn(lanes)
    path = str(tmp_path / "mid.ckpt")
    ckpt.save(path, lanes)
    live = lanes.depth.numpy()[lanes.active.numpy()]   # in lane order
    assert live.size > 16 and live[:8].max() > 0

    def rebuilt(place, depths):
        """``place()``, which must rebuild the lanes of ``depths`` alone."""
        ckpt.reset_rebuilds()
        out = place()
        assert ckpt.REBUILDS == dict(calls=1, lanes=depths.size,
                                     passes=int(depths.max()))
        return out

    small, pool = rebuilt(lambda: ckpt.restore(path, problem, 8), live[:8])
    assert [t.depth for t in pool] == live[8:].tolist()
    grown, rest = rebuilt(lambda: ckpt.repartition(problem, small, 16),
                          live[:8])
    assert rest == [] and int(grown.active.sum()) == 8
    fed, left = rebuilt(lambda: ckpt.install_pending(problem, grown, pool),
                        live[8:16])
    assert bool(fed.active.all()) and len(left) == len(pool) - 8
    assert [c["passes"] for c in calls] == [c["deepest"] for c in calls] \
        == [int(live[:8].max())] * 2 + [int(live[8:16].max())]

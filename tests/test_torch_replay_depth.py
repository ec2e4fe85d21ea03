"""The round replays only as deep as its deepest received task
(``steal.replay_begin`` / ``replay_chunk``, run by
``round_graph.GraphedRound``).

The plan part reports ``need``, the deepest task a lane received in the
round's steal; the host then runs ``ceil(need / REPLAY_CHUNK)`` chunks of
CONVERTINDEX passes, none when no lane received a task.  Held here on the
CPU, eager and on the stand-in graph backend of
``tests/test_torch_round_graph.py``: every round equals, in every
``Lanes`` field, the round whose replay runs all IDX_LEN passes over every
lane, the reference's (``repro.core.distributed.make_round``) and the
port's (``steal.balance_device``), and ``steal.REPLAYS`` counts what ran.
The service's rounds are held against the reference's service in
``tests/test_torch_service.py``; ``tests/test_torch_gpu.py`` holds the
launches on the card.
"""

from __future__ import annotations

import torch
import pytest

from test_torch_round_graph import Emulated, counting

from repro_torch import registry
from repro_torch.convert import to_numpy
from repro_torch.core import round_graph, steal
from repro_torch.core.api import LEFT, RIGHT, tree_leaves
from repro_torch.core.distributed import _open_work, make_round
from repro_torch.core.engine import Lanes, init_lanes, make_expand, \
    replay_path
from repro_torch.kernels import _build
from repro_torch.obs import spans
from repro_torch.problems.graphs import parse_graph_instance
from repro_torch.service import SolveRequest
from repro_torch.solver import Solver, SolverConfig

C = steal.REPLAY_CHUNK
#: (family, instance, lanes): each fills its lanes and then runs rounds
#: in which no lane receives a task.
PROBLEMS = [("vc", "reg:36:4:3", 32), ("ds", "gnp:30:20:3", 8),
            ("ss", "ss:16:2", 64)]
BACKENDS = ["eager", "emulated"]


def full_round(problem, steps):
    """The round whose replay runs IDX_LEN passes over every lane."""
    expand = make_expand(problem, steps)

    def round_(lanes):
        lanes = steal.balance_device(problem, expand(lanes))
        return lanes, _open_work(lanes)
    return round_


def reference_round(family, spec, steps):
    """The reference's round (``repro.core.distributed.make_round``, its
    whole IDX_LEN-pass replay) as a check: ``check(before, after)`` runs
    it on the port's lanes ``before`` and asserts every array equal to
    the port's ``after`` (``test_torch_engine.assert_lanes_equal``)."""
    import jax
    import jax.numpy as jnp
    from repro import registry as jregistry
    from repro.core import distributed as jdist
    from repro.core.engine import init_lanes as j_init_lanes
    from test_torch_engine import assert_lanes_equal, numpy_tree

    jp = jregistry.problem(family, spec).build()
    j_round = jax.jit(jdist.make_round(jp, steps))

    def check(before: Lanes, after: Lanes, where: str) -> None:
        like = j_init_lanes(jp, before.idx.shape[0])
        leaves = jax.tree_util.tree_leaves(
            to_numpy(before, like=numpy_tree(like)))
        jl = jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(like), map(jnp.asarray, leaves))
        want, _ = j_round(jl)
        assert_lanes_equal(after, want, where)
    return check


def chunked_round(problem, steps, backend):
    body = make_round(problem, steps)
    if backend == "eager":
        return body
    return round_graph.GraphedRound(body.plan, body.chunk, body.chunks,
                                    backend=Emulated)


def assert_same(a, b):
    for name, x, y in zip(Lanes._fields, a, b):
        for u, v in zip(tree_leaves(x), tree_leaves(y)):
            assert u.dtype == v.dtype and torch.equal(u, v), name


def receipts(before: Lanes, after: Lanes):
    """(lanes that received a task in the round, the deepest of them)."""
    got = after.t_s > before.t_s
    return int(got.sum()), int(torch.where(got, after.depth, 0).max())


@pytest.fixture(autouse=True)
def fresh_counts():
    steal.reset_replays()
    round_graph.reset_counts()
    yield
    steal.reset_replays()


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("family,spec,width", PROBLEMS)
def test_a_chunked_round_equals_the_whole_replay(family, spec, width,
                                                 backend):
    """From the root through the fill into rounds at full lanes: every
    round bitwise the whole replay's, ``ceil(need / C)`` chunks each,
    none where no lane received a task."""
    problem = registry.problem(family, spec).build(device="cpu")
    il = problem.max_depth + 1
    chunked = chunked_round(problem, 8, backend)
    full = full_round(problem, 8)
    reference = reference_round(family, spec, 8)
    a = b = init_lanes(problem, width)
    needs = []
    for r in range(12):
        chunks = steal.REPLAYS["chunks"]
        before = a
        a, open_a = chunked(a)
        b, open_b = full(b)
        assert_same(a, b)
        reference(before, a, f"round {r}")
        assert torch.equal(open_a, open_b.cpu())
        _, need = receipts(before, a)
        needs.append(need)
        assert steal.REPLAYS["chunks"] - chunks == -(-need // C)
    assert 0 in needs and max(needs) > 0
    assert steal.REPLAYS == {
        "rounds": 12, "no_receiver": needs.count(0),
        "chunks": sum(-(-n // C) for n in needs),
        "passes": sum(-(-n // C) * C for n in needs),
        "full_passes": 12 * il}


def lanes_with_open_slot(problem, width, slot):
    """Lane 0 at depth ``slot + 1`` on a right-branch path whose two
    deepest slots are LEFT (open), its stack that path's states; every
    other lane idle.  Its next step takes the right branch below, so the
    first thief receives the task at ``slot``, of depth ``slot + 1``."""
    lanes = init_lanes(problem, width)
    depth = slot + 1
    idx = lanes.idx.clone()
    idx[0, :depth + 1] = RIGHT
    idx[0, slot:depth + 1] = LEFT
    path = torch.zeros(width, dtype=torch.int32)
    path[0] = depth
    bits = torch.where(idx < 0, 0, idx).to(torch.int8)
    stack = replay_path(problem, bits, path, lanes.stack,
                        torch.zeros(width, dtype=torch.int32))
    return lanes._replace(idx=idx, depth=path, stack=stack)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("family,spec", [("vc", "gnp:30:20:3"),
                                         ("ds", "gnp:16:30:2"),
                                         ("ss", "ss:16:2")])
@pytest.mark.parametrize("need", ["C", "2C", "IDX_LEN-1"])
def test_need_at_a_chunk_edge_and_at_the_deepest_slot(family, spec, need,
                                                      backend):
    """A task received at depth C or 2C (an exact number of chunks) or at
    IDX_LEN - 1 (the deepest a steal hands out): the chunked round equals
    the whole replay over the same lanes, the port's and the
    reference's."""
    problem = registry.problem(family, spec).build(device="cpu")
    il = problem.max_depth + 1
    depth = {"C": C, "2C": 2 * C, "IDX_LEN-1": il - 1}[need]
    assert depth <= il - 1
    lanes = lanes_with_open_slot(problem, 8, depth - 1)
    chunked = chunked_round(problem, 1, backend)
    full = full_round(problem, 1)
    reference = reference_round(family, spec, 1)
    for r in range(3):               # warm-up, capture, replay
        a, open_a = chunked(lanes)
        b, open_b = full(lanes)
        assert_same(a, b)
        reference(lanes, a, f"call {r}")
        assert torch.equal(open_a, open_b)
        assert receipts(lanes, a) == (1, depth)
    assert steal.REPLAYS["chunks"] == 3 * -(-depth // C)


def test_a_service_round_of_several_instances_equals_the_whole_replay():
    """The service's rounds (three slots, vertex cover and dominating set
    together): each round's chunked replay equals the whole replay of the
    same input lanes."""
    svc = Solver(SolverConfig(lanes=32, steps_per_round=8, device="cpu")
                 ).serve(max_n=20, slots=3)
    body = svc._round
    svc._round = round_graph.GraphedRound(body.plan, body.chunk,
                                          body.chunks, backend=Emulated)
    full = full_round(svc.problem, svc.steps_per_round)
    seen = []

    def checked(lanes):
        out, open_work = svc_round(lanes)
        want, want_open = full(lanes)
        assert_same(out, want)
        assert torch.equal(open_work, want_open)
        busy = torch.unique(out.inst[out.active]).numel()
        seen.append((busy, receipts(lanes, out)[1]))
        return out, open_work

    svc_round, svc._round = svc._round, checked
    for rid in range(6):
        svc.submit(SolveRequest(
            rid=rid, graph=parse_graph_instance(f"gnp:16:30:{rid}"),
            family="vc" if rid % 2 else "ds"))
    results = svc.drain()
    assert len(results) == 6
    assert any(busy >= 2 and need > 0 for busy, need in seen)
    assert steal.REPLAYS["rounds"] == len(seen) == svc.rounds
    assert steal.REPLAYS["passes"] == sum(-(-n // C) * C for _, n in seen)


def test_replays_count_the_passes_of_a_solve():
    """Over a whole solve, ``REPLAYS`` passes are the sum of
    ``ceil(need / C) * C`` over its rounds, its full passes IDX_LEN a
    round."""
    handle = registry.problem("vc", "reg:36:4:3")
    needs = []
    real = make_round

    def recording(*args, **kw):
        body = real(*args, **kw)

        def round_(lanes):
            out, open_work = body(lanes)
            needs.append(receipts(lanes, out)[1])
            return out, open_work
        return round_

    import repro_torch.solver as solver_mod
    orig, solver_mod.make_round = solver_mod.make_round, recording
    try:
        res = Solver(SolverConfig(lanes=16, steps_per_round=8,
                                  device="cpu")).solve(handle)
    finally:
        solver_mod.make_round = orig
    il = handle.build(device="cpu").max_depth + 1
    assert len(needs) == res.stats.rounds
    assert steal.REPLAYS == {
        "rounds": len(needs), "no_receiver": needs.count(0),
        "chunks": sum(-(-n // C) for n in needs),
        "passes": sum(-(-n // C) * C for n in needs),
        "full_passes": len(needs) * il}


def test_a_replayed_round_counts_the_launches_of_its_chunks():
    """A replayed round adds the plan's captured launches once and the
    chunk's for each chunk launched: 64 + the passes run, as a card round
    of 64 steps and one count_stats launch a pass counts them."""
    problem = registry.problem("vc", "reg:36:4:3").build(device="cpu")
    body = make_round(problem, 8)
    graphed = round_graph.GraphedRound(counting(body.plan, 64),
                                       counting(body.chunk, C),
                                       body.chunks,
                                       backend=Emulated)
    lanes = init_lanes(problem, 32)
    seen = []
    for _ in range(12):
        launches = _build.LAUNCHES["count_stats"]
        passes = steal.REPLAYS["passes"]
        lanes, _ = graphed(lanes)
        seen.append(steal.REPLAYS["passes"] - passes)
        assert _build.LAUNCHES["count_stats"] - launches == 64 + seen[-1]
    assert round_graph.COUNTS["replays"] == 11
    assert 0 in seen[2:] and max(seen[2:]) > 0


class _Event:
    """A stand-in CUDA timing event on a made-up device clock."""

    def __init__(self, ms, done=True):
        self.ms, self.done = ms, done

    def elapsed_time(self, end):
        if not (self.done and end.done):
            raise RuntimeError("Both events must be completed before "
                               "calculating elapsed time.")
        return end.ms - self.ms


def test_a_round_with_no_receiver_still_files_its_replay_device_span(
        monkeypatch):
    """The chunks' ``replay`` device span is recorded around no chunk at
    all on a round that launches none, deferred past the round's readback, and filed
    under its own round by the next round's, never before its events have
    completed."""
    rec = spans.SpanRecorder()
    monkeypatch.setattr(spans, "RECORDER", rec)
    clock, made = iter(range(1000)), []

    def event():
        if getattr(rec._local, "armed", None) is None:
            return None
        made.append(_Event(float(next(clock)), done=False))
        return made[-1]

    monkeypatch.setattr(rec, "_event", event)
    # A stand-in round: its flags are (open work, chunks to launch).
    graphed = round_graph.GraphedRound(
        None, None, lambda host: (int(host[1]), host[:1]))
    card = torch.device("cuda")        # arms the spans; nothing launches
    run = rec.begin_run("solve")
    launched = []
    for r, n in ((1, 0), (2, 3)):
        with rec.span("round", run=run, round=r):
            rec.pend_device([("expand", _Event(10.0 * r),
                              _Event(10.0 * r + 4))])
            flags = torch.tensor([5, n], dtype=torch.int32)
            open_work = graphed._finish(flags, card,
                                        lambda: launched.append(r))
            assert open_work.tolist() == [5]
        start, end = made[-2:]
        dev = [(s.name, s.round) for s in rec.spans(run)
               if s.clock == "device"]
        # Filed: this round's plan span and, from round 2 on, round 1's
        # replay, whose events had completed by then.
        assert dev == [("expand", 1)] + (
            [("replay", 1), ("expand", 2)] if r == 2 else [])
        start.done = end.done = True
    assert launched == [2, 2, 2]
    with rec.span("round", run=run, round=3):
        assert rec.read_device() == 1
    replays = [s for s in rec.spans(run) if s.name == "replay"]
    assert [(s.round, s.clock) for s in replays] == [
        (1, "host"), (1, "device"), (2, "host"), (2, "device")]
    assert {s.duration_ns for s in replays if s.clock == "device"} == {
        1_000_000}

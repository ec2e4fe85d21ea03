"""The round's CUDA graphs (``repro_torch.core.round_graph``): their
bookkeeping on the CPU.

A CUDA graph exists only on the card, so these tests give
``GraphedRound`` a stand-in backend: its capture runs the body once to
learn the outputs and then scribbles over them (a captured graph has run
nothing), and its replay runs the body again on the static inputs it
closed over and writes the static outputs in place (a replay chunk,
which returns nothing, writes its own in place).  What is held here
is the wrapper's part: the CPU round is the eager round, inputs stay
untouched, outputs are fresh tensors, launches are counted as eager
rounds count them, a new shape captures anew and a failed capture falls
back to eager.  ``tests/test_torch_gpu.py`` holds the graph itself
against the eager round on the card.
"""

from __future__ import annotations

import functools

import pytest
import torch

from repro_torch import registry
from repro_torch.core import round_graph
from repro_torch.core.api import tree_leaves
from repro_torch.core.distributed import Mesh, ShardedLanes, make_round
from repro_torch.core.engine import init_lanes
from repro_torch.kernels import _build
from repro_torch.obs import spans
from repro_torch.solver import Solver, SolverConfig

PROBLEMS = [("vc", "gnp:30:20:3"), ("ds", "gnp:16:30:2"), ("ss", "ss:16:2")]


class Emulated:
    """A stand-in for ``round_graph.CudaGraph`` that runs on any device."""

    @staticmethod
    def applies(device):
        return True

    def __init__(self, device):
        self.fn = self.out = None

    def capture(self, fn):
        self.fn = fn
        self.out = fn()
        for leaf in tree_leaves(self.out):        # nothing has run yet
            if leaf is not None:
                leaf.fill_(True if leaf.dtype == torch.bool else 7)
        return self.out

    def replay(self):
        # The device counts no launch and records no span.
        before, recording = dict(_build.LAUNCHES), spans.RECORDER.enabled
        spans.disable()
        try:
            got = self.fn()
        finally:
            spans.RECORDER.enabled = recording
            _build.LAUNCHES.update(before)
        if got is not None:
            for static, leaf in zip(tree_leaves(self.out),
                                    tree_leaves(got)):
                static.copy_(leaf)


class Refused(Emulated):
    """A capture that fails as a body that syncs fails on the card."""

    def capture(self, fn):
        fn()
        raise RuntimeError("operation not permitted when stream is "
                           "capturing")


def counting(fn, per_call=3):
    """``fn`` that counts ``per_call`` count_stats launches a call, as the
    card's kernels would."""
    def body(*args):
        _build.LAUNCHES["count_stats"] += per_call
        return fn(*args)
    return body


def graphed_as(body, backend=Emulated, plan=None, **kw):
    """The round ``body`` (``make_round``'s) run by a ``GraphedRound`` on
    ``backend``, its plan replaced by ``plan`` when given."""
    return round_graph.GraphedRound(plan or body.plan, body.chunk,
                                    body.chunks, backend=backend, **kw)


def build(family, spec, lanes=16):
    problem = registry.problem(family, spec).build(device="cpu")
    return problem, init_lanes(problem, lanes)


def assert_same(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


def storages(tree):
    return {x.untyped_storage().data_ptr() for x in tree_leaves(tree)
            if x.numel()}


@pytest.fixture(autouse=True)
def fresh_counts():
    round_graph.reset_counts()
    yield
    round_graph.reset_counts()


@pytest.mark.parametrize("family,spec", PROBLEMS)
def test_cpu_round_is_the_eager_round_bitwise(family, spec):
    problem, lanes = build(family, spec)
    graphed = make_round(problem, 8)
    assert isinstance(graphed, round_graph.GraphedRound)
    a = b = lanes
    for _ in range(5):
        a, open_a = graphed(a)
        b, open_b = graphed.fn(b)
        assert_same((a, open_a), (b, open_b))
    assert round_graph.COUNTS["cpu"] == 5
    assert round_graph.COUNTS["captures"] == round_graph.COUNTS["replays"] \
        == 0


@pytest.mark.parametrize("family,spec", PROBLEMS)
def test_replayed_rounds_equal_the_eager_rounds(family, spec):
    problem, lanes = build(family, spec)
    body = make_round(problem, 8)
    eager, graphed = body.fn, graphed_as(body)
    a = b = lanes
    for _ in range(6):
        a, open_a = graphed(a)
        b, open_b = eager(b)
        assert_same((a, open_a), (b, open_b))
    assert {k: v for k, v in round_graph.COUNTS.items() if v} == {
        "warmup": 1, "captures": 1, "replays": 5}


def test_inputs_are_left_untouched_and_outputs_are_fresh():
    problem, lanes = build("vc", "gnp:30:20:3")
    graphed = graphed_as(make_round(problem, 8))
    prev_out = None
    for _ in range(4):
        kept = [x.clone() for x in tree_leaves(lanes)]
        replays = round_graph.COUNTS["replays"]
        out = graphed(lanes)
        assert_same(tree_leaves(lanes), kept)
        if round_graph.COUNTS["replays"] > replays:
            # (The eager warm-up passes ``t_c`` through, as eager rounds do.)
            assert not storages(out) & storages(lanes)
            assert not storages(out) & storages(prev_out)
            assert not storages(out) & storages(graphed._static_in)
            assert not storages(out) & storages(graphed._static_out)
        prev_out = out
        lanes = out[0]
    assert round_graph.COUNTS["replays"] == 3


def test_launches_grow_by_the_captured_delta_on_every_replay():
    problem, lanes = build("vc", "gnp:30:20:3")
    body = make_round(problem, 8)
    graphed = graphed_as(body, plan=counting(body.plan))
    # The plan's 8 engine steps each clone every stack leaf.
    pushed = 8 * sum(s.numel() * s.element_size() for s in lanes.stack)
    for _ in range(5):
        before = dict(_build.LAUNCHES)
        lanes, _ = graphed(lanes)
        assert _build.LAUNCHES["count_stats"] == before["count_stats"] + 3
        assert _build.LAUNCHES["stack_push_bytes"] == \
            before["stack_push_bytes"] + pushed
    assert graphed._launches == {"count_stats": 3, "stack_push_bytes": pushed}
    assert round_graph.COUNTS["replays"] == 4


def test_a_changed_shape_captures_anew():
    problem, small = build("vc", "gnp:30:20:3", lanes=8)
    big = init_lanes(problem, 16)
    body = make_round(problem, 8)
    eager, graphed = body.fn, graphed_as(body)
    for lanes in (small, small, small, big, big, big, small):
        assert_same(graphed(lanes), eager(lanes))
    assert {k: v for k, v in round_graph.COUNTS.items() if v} == {
        "warmup": 3, "captures": 2, "replays": 4}


def test_a_failed_capture_falls_back_to_eager_and_is_counted():
    problem, lanes = build("vc", "gnp:30:20:3")
    body = make_round(problem, 8)
    graphed = graphed_as(body, Refused, plan=counting(body.plan))
    b = lanes
    launches = []
    with pytest.warns(RuntimeWarning, match="runs eager from now on") as w:
        for _ in range(4):
            before = _build.LAUNCHES["count_stats"]
            lanes, open_a = graphed(lanes)
            launches.append(_build.LAUNCHES["count_stats"] - before)
            b, open_b = make_round(problem, 8).fn(b)
            assert_same((lanes, open_a), (b, open_b))
    assert len(w) == 1                            # warns once
    assert launches == [3, 3, 3, 3]               # the failed capture's own
    assert {k: v for k, v in round_graph.COUNTS.items() if v} == {
        "warmup": 1, "capture_failed": 3}


@pytest.mark.parametrize("calls,want", [
    (1, {"short": 1}), (2, {"short": 2}),
    (3, {"warmup": 1, "captures": 1, "replays": 2}),
    (None, {"warmup": 1, "captures": 1, "replays": 3})])
def test_a_body_with_too_few_calls_to_pay_for_a_capture_stays_eager(calls,
                                                                   want):
    problem, lanes = build("vc", "gnp:30:20:3")
    body = make_round(problem, 8)
    eager, graphed = body.fn, graphed_as(body, calls=calls)
    a = b = lanes
    for _ in range(calls or 4):
        a, open_a = graphed(a)
        b, open_b = eager(b)
        assert_same((a, open_a), (b, open_b))
    assert {k: v for k, v in round_graph.COUNTS.items() if v} == want


@pytest.mark.parametrize("boot,want", [
    (2, {"short": 2, "warmup": 1, "captures": 1, "replays": 3}),
    (3, {"warmup": 2, "captures": 2, "replays": 5})])
def test_the_solver_tells_its_bootstrap_body_how_many_calls_it_gets(
        monkeypatch, boot, want):
    """``Solver.solve``'s bootstrap body gets ``bootstrap_rounds`` calls:
    with two it stays eager, with three it is graphed; the main body is
    graphed either way.  The tree is the eager solve's."""
    config = SolverConfig(lanes=8, steps_per_round=8, device="cpu",
                          bootstrap_rounds=boot, max_rounds=boot + 4)
    handle = registry.problem("vc", "gnp:30:20:3")
    eager = Solver(config).solve(handle)
    round_graph.reset_counts()
    monkeypatch.setattr(round_graph, "GraphedRound", functools.partial(
        round_graph.GraphedRound, backend=Emulated))
    graphed = Solver(config).solve(handle)
    assert graphed.stats == eager.stats
    assert_same(graphed.lanes, eager.lanes)
    assert {k: v for k, v in round_graph.COUNTS.items() if v} == want


def test_a_mesh_of_several_shards_stays_eager_and_is_counted():
    problem, lanes = build("vc", "gnp:30:20:3", lanes=16)
    mesh_round = make_round(problem, 8, mesh=Mesh(["cpu"] * 2))
    assert not isinstance(mesh_round, round_graph.GraphedRound)
    one_shard = make_round(problem, 8, mesh=Mesh(["cpu"]))
    sharded = ShardedLanes([lanes])
    for _ in range(2):
        sharded, _ = one_shard(sharded)
    solver = Solver(SolverConfig(lanes=8, steps_per_round=8, device="cpu",
                                 mesh=Mesh(["cpu"] * 2), max_rounds=3))
    solver.solve(registry.problem("vc", "gnp:30:20:3"))
    assert round_graph.COUNTS["mesh"] == 3
    assert round_graph.COUNTS["cpu"] == 2


def test_a_replayed_round_records_one_graph_span():
    spans.enable()
    problem, lanes = build("vc", "gnp:30:20:3")
    graphed = graphed_as(make_round(problem, 8))
    run = spans.begin_run("solve")
    for r in range(1, 5):
        with spans.span("round", run=run, round=r):
            lanes, _ = graphed(lanes)
    got = spans.RECORDER.spans(run)
    tops = {s.round: s.id for s in got if s.name == "round"}
    names = {r: sorted(s.name for s in got
                       if s.round == r and s.name != "round")
             for r in tops}
    # Warm-up and capture run the plan: its phases, the plan's replay
    # among them; every round reads back and runs its replay chunks;
    # replays: one graph around the readback and the chunks.
    assert names[1] == ["balance", "balance", "expand", "readback",
                        "replay", "replay"]
    assert names[2] == ["balance", "balance", "expand", "graph",
                        "readback", "replay", "replay"]
    assert names[3] == names[4] == ["graph", "readback", "replay"]
    graphs = {s.round: s.id for s in got if s.name == "graph"}
    for s in got:
        if s.name == "graph":
            assert s.parent == tops[s.round]
        if s.name == "readback" and s.round in graphs:
            assert s.parent == graphs[s.round]


def test_a_solve_on_the_cpu_counts_its_rounds_as_cpu():
    stats = Solver(SolverConfig(lanes=8, steps_per_round=8, device="cpu",
                                bootstrap_rounds=2)).solve(
        registry.problem("vc", "gnp:20:30:2")).stats
    assert round_graph.COUNTS["cpu"] == stats.rounds
    assert sum(round_graph.COUNTS.values()) == stats.rounds

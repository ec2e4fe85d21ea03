"""The port's spans (``repro_torch.obs.spans``): the recorder itself, its
device spans (with stand-in events: the CPU records none), the spans the
solve and the service record, and that recording them changes nothing
of the search."""

from __future__ import annotations

import collections
import json
import pathlib

import pytest
import torch

from repro_torch import registry
from repro_torch.core.distributed import Mesh
from repro_torch.obs import spans
from repro_torch.obs.spans import Span, SpanRecorder, self_ns
from repro_torch.problems.graphs import parse_graph_instance
from repro_torch.service import SolveRequest
from repro_torch.solver import Solver, SolverConfig

ROOT = pathlib.Path(__file__).resolve().parents[1]
PHASES = ("expand", "balance", "replay", "readback")


@pytest.fixture
def recorder_on():
    """The process-wide recorder on, and on again after the test."""
    spans.enable()
    yield spans.RECORDER
    spans.enable()


# -- the recorder ------------------------------------------------------------

def test_nesting_gives_parents_run_and_round():
    rec = SpanRecorder()
    run = rec.begin_run("solve")
    with rec.span("round", run=run, round=3):
        with rec.span("expand"):
            pass
        with rec.span("balance"):
            with rec.span("replay"):
                pass
    with rec.span("loose"):
        pass
    got = {s.name: s for s in rec.spans()}
    assert got["round"].parent is None
    assert got["expand"].parent == got["balance"].parent == got["round"].id
    assert got["replay"].parent == got["balance"].id
    assert {s.run for s in rec.spans(run)} == {run}
    assert {s.round for s in rec.spans(run)} == {3}
    assert got["loose"].run == 0 and got["loose"].parent is None
    # Children close before their parent and lie inside it.
    assert [s.name for s in rec.spans()] == ["expand", "replay", "balance",
                                            "round", "loose"]
    for s in rec.spans(run):
        p = got["round"]
        assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns


def test_run_ids_are_new_per_run_and_newest_per_mode():
    rec = SpanRecorder()
    a, b = rec.begin_run("solve"), rec.begin_run("service")
    c = rec.begin_run("solve")
    assert len({a, b, c}) == 3
    assert rec.newest_run("solve") == c and rec.newest_run("service") == b
    assert rec.newest_run("other") is None and rec.run_spans("other") == []
    with rec.span("round", run=a, round=1):
        pass
    with rec.span("round", run=c, round=1):
        pass
    assert [s.run for s in rec.run_spans("solve")] == [c]


def test_the_ring_drops_the_oldest():
    rec = SpanRecorder(capacity=4)
    for i in range(6):
        with rec.span("round", run=1, round=i + 1):
            pass
    assert [s.round for s in rec.spans()] == [3, 4, 5, 6]
    with pytest.raises(ValueError):
        SpanRecorder(capacity=0)


def test_request_spans_carry_the_rid_and_the_current_round():
    rec = SpanRecorder()
    run = rec.begin_run("service")
    with rec.span("round", run=run, round=7):
        pass
    whole = rec.open("request", run=run, rid=11)
    queued = rec.open("queued", run=run, rid=11, parent=whole)
    rec.close(queued)
    rec.close(whole)
    rec.close(whole)          # closed twice: nothing more
    rec.close(0)
    req = [s for s in rec.spans(run) if s.rid is not None]
    assert [(s.name, s.rid, s.round) for s in req] == [
        ("queued", 11, 7), ("request", 11, 7)]
    assert req[0].parent == req[1].id
    assert req[1].start_ns <= req[0].start_ns <= req[0].end_ns \
        <= req[1].end_ns


def test_off_records_nothing():
    rec = SpanRecorder()
    rec.enabled = False
    run = rec.begin_run("solve")
    with rec.span("round", run=run, round=1):
        with rec.span("expand"):
            pass
    assert rec.open("request", run=run, rid=1) == 0
    assert rec.spans() == []
    # Turned on inside an open span: its exit pops nothing.
    with rec.span("round", run=run, round=2):
        rec.enabled = True
        with rec.span("expand"):
            pass
    assert [s.name for s in rec.spans()] == ["expand"]


def test_an_exception_closes_the_span():
    rec = SpanRecorder()
    with pytest.raises(KeyError):
        with rec.span("round", run=1, round=1):
            with rec.span("event"):
                raise KeyError("listener")
    assert [s.name for s in rec.spans()] == ["event", "round"]
    with rec.span("expand"):
        pass
    assert rec.spans()[-1].parent is None


def test_self_time_is_the_duration_less_the_children_union():
    spans_ = [Span(1, "round", 0, 100, None, 1, 1),
              Span(2, "admit", 10, 40, 1, 1, 1),
              Span(3, "rebuild", 15, 30, 2, 1, 1),
              Span(4, "expand", 35, 60, 1, 1, 1),     # overlaps admit
              Span(5, "readback", 90, 120, 1, 1, 1)]  # runs past round
    own = self_ns(spans_)
    assert own == {1: 100 - (50 + 10), 2: 30 - 15, 3: 15, 4: 25, 5: 30}
    # A child whose parent is absent counts for nobody.
    assert self_ns(spans_[2:3]) == {3: 15}


def test_the_export_is_chrome_trace_events(tmp_path):
    rec = SpanRecorder()
    run = rec.begin_run("service")
    with rec.span("round", run=run, round=1):
        with rec.span("admit"):
            pass
    rid_span = rec.open("request", run=run, rid=5)
    rec.close(rid_span)
    path = tmp_path / "spans.json"
    assert rec.export_chrome(str(path), run) == 3
    doc = json.loads(path.read_text())
    assert isinstance(doc["baseTimeNanoseconds"], int)
    events = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert [e["name"] for e in events] == ["admit", "round", "request"]
    for e in events:
        assert set(e) >= {"name", "ph", "ts", "dur", "pid", "tid", "args"}
        assert e["dur"] >= 0 and e["ts"] > 0
    admit, rnd, req = events
    assert admit["args"]["parent"] == rnd["args"]["id"]
    assert req["args"]["rid"] == 5 and req["tid"] != rnd["tid"]
    assert rnd["ts"] <= admit["ts"] <= admit["ts"] + admit["dur"] \
        <= rnd["ts"] + rnd["dur"] + 1e-3


def test_the_export_shares_the_profilers_clock(tmp_path):
    """An operation the profiler records inside a span lies inside the
    span in the two exported files."""
    from torch.profiler import ProfilerActivity, profile
    rec = SpanRecorder()
    x = torch.randn(256, 256)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with rec.span("expand", run=1, round=1):
            for _ in range(20):
                x = torch.tanh(x @ x)
    prof.export_chrome_trace(str(tmp_path / "prof.json"))
    rec.export_chrome(str(tmp_path / "spans.json"))
    theirs = json.loads((tmp_path / "prof.json").read_text())
    ours = json.loads((tmp_path / "spans.json").read_text())
    assert ours["baseTimeNanoseconds"] == theirs["baseTimeNanoseconds"]
    mms = [e for e in theirs["traceEvents"]
           if e.get("ph") == "X" and e.get("name") == "aten::mm"]
    (span,) = [e for e in ours["traceEvents"] if e["ph"] == "X"]
    assert len(mms) == 20
    slack = 1e3          # µs: the two clocks are read a moment apart
    for e in mms:
        assert span["ts"] - slack <= e["ts"]
        assert e["ts"] + e["dur"] <= span["ts"] + span["dur"] + slack


# -- device spans ------------------------------------------------------------

class _Event:
    """A stand-in for a timing CUDA event: the milliseconds at which it
    was recorded on a made-up device clock."""

    def __init__(self, ms, done=True):
        self.ms, self.done = ms, done

    def elapsed_time(self, end):
        if not (self.done and end.done):    # as torch's: it never waits
            raise RuntimeError("Both events must be completed before "
                               "calculating elapsed time.")
        return end.ms - self.ms


def _round_events(t0=0.0, done=True):
    """A round's four device spans as the phases enqueue them."""
    edges = [("expand", 1.0, 11.0), ("balance", 11.0, 11.25),
             ("balance", 11.25, 11.5), ("replay", 11.5, 50.0)]
    return [(name, _Event(t0 + a), _Event(t0 + b, done))
            for name, a, b in edges]


def test_device_spans_are_filed_with_the_reading_rounds_numbers():
    rec = SpanRecorder()
    run = rec.begin_run("solve")
    rec.pend_device(_round_events())
    with rec.span("round", run=run, round=4):
        with rec.span("readback"):
            pass
        assert rec.read_device() == 4
        assert rec.read_device() == 0           # read once
    dev = [s for s in rec.spans(run) if s.clock == "device"]
    assert [(s.name, s.round, s.parent) for s in dev] == [
        ("expand", 4, None), ("balance", 4, None), ("balance", 4, None),
        ("replay", 4, None)]
    assert [s.duration_ns for s in dev] == [10_000_000, 250_000, 250_000,
                                            38_500_000]
    # Placed as on the device: back to back, the last ending last.
    for a, b in zip(dev, dev[1:]):
        assert a.end_ns == b.start_ns
    assert max(s.end_ns for s in dev) == dev[-1].end_ns
    assert {s.clock for s in rec.spans(run)} - {"device"} == {"host"}


def test_device_spans_pending_are_the_last_rounds_and_never_waited_for():
    rec = SpanRecorder()
    rec.pend_device(_round_events())
    rec.pend_device(_round_events(t0=100.0))   # a replay records them again
    with rec.span("round", run=1, round=2):
        assert rec.read_device() == 4
    assert len(rec.spans()) == 5
    rec.pend_device(_round_events(done=False))  # the card not waited for
    with rec.span("round", run=1, round=3):
        assert rec.read_device() == 0
    assert len(rec.spans()) == 6
    with rec.span("round", run=1, round=4):
        assert rec.read_device() == 0           # dropped, not kept


def test_device_phases_arm_nothing_off_the_card_or_with_the_recorder_off():
    rec = SpanRecorder()
    rec.pend_device(_round_events())        # a card round never read
    with rec.device_phases(torch.device("cpu")) as phases:
        with rec.span("expand", device=True):
            pass
    assert phases.recorded == []
    assert rec.read_device() == 0           # a CPU round files none
    rec.pend_device(_round_events())
    rec.enabled = False
    with rec.device_phases(torch.device("cuda")) as phases:
        with rec.span("expand", device=True):
            pass
    assert phases.recorded == []
    rec.pend_device(_round_events())        # a replay, the recorder off
    assert rec.read_device() == 0
    assert [s.clock for s in rec.spans()] == ["host"]


def test_device_phases_collect_the_spans_opened_inside(monkeypatch):
    rec = SpanRecorder()
    clock = iter(range(100))
    monkeypatch.setattr(rec, "_event", lambda: (
        _Event(float(next(clock))) if getattr(rec._local, "armed", None)
        else None))
    with rec.span("expand", device=True):       # not armed: no device span
        pass
    with rec.device_phases(torch.device("cuda")) as phases:
        with rec.span("expand", device=True):
            with rec.span("inner"):
                pass
        with rec.span("readback"):              # a host span only
            pass
        with rec.span("replay", device=True):
            pass
    assert [(n, a.ms, b.ms) for n, a, b in phases.recorded] == [
        ("expand", 0.0, 1.0), ("replay", 2.0, 3.0)]
    assert getattr(rec._local, "armed", None) is None
    with rec.span("round", run=1, round=1):     # pending on leaving
        assert rec.read_device() == 2


def test_the_export_puts_device_spans_on_a_row_of_their_own(tmp_path):
    rec = SpanRecorder()
    run = rec.begin_run("solve")
    rec.pend_device(_round_events())
    with rec.span("round", run=run, round=1):
        rec.read_device()
    path = tmp_path / "spans.json"
    assert rec.export_chrome(str(path), run) == 5
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e["ph"] == "X"]
    rows = {e["name"]: e["tid"] for e in events}
    assert rows["round"] == 0
    assert {rows[n] for n in ("expand", "balance", "replay")} == {2}


# -- the spans of the solve and the service ----------------------------------

def _solve(mesh=None, metrics=False):
    cfg = SolverConfig(lanes=8 if mesh else 16, steps_per_round=8,
                       device="cpu", mesh=mesh, metrics=metrics)
    return Solver(cfg, on_event=lambda ev: None).solve(
        registry.problem("vc", "gnp:20:30:2"))


def _by_round(run):
    tops = {s.round: s for s in run if s.name == "round"}
    kids = collections.defaultdict(list)
    for s in run:
        if s.parent is not None and s.rid is None:
            kids[s.round].append(s)
    return tops, kids


@pytest.mark.parametrize("shards", [0, 2])
def test_every_solve_round_holds_its_phases(recorder_on, shards):
    res = _solve(Mesh(["cpu"] * shards) if shards else None)
    run = spans.run_spans("solve")
    tops, kids = _by_round(run)
    assert sorted(tops) == list(range(1, res.stats.rounds + 1))
    for r, top in tops.items():
        names = collections.Counter(s.name for s in kids[r])
        assert set(PHASES) | {"event"} <= set(names), (r, names)
        assert names["readback"] == names["event"] == 1
        for s in kids[r]:
            assert s.parent == top.id
            assert top.start_ns <= s.start_ns <= s.end_ns <= top.end_ns


@pytest.mark.parametrize("shards", [0, 2])
def test_the_cpu_records_no_device_span(recorder_on, shards):
    _solve(Mesh(["cpu"] * shards) if shards else None)
    run = spans.run_spans("solve")
    assert run and {s.clock for s in run} == {"host"}


def _service(n_requests=5, on=True):
    (spans.enable if on else spans.disable)()
    svc = Solver(SolverConfig(lanes=16, steps_per_round=8, device="cpu")
                 ).serve(max_n=20, slots=2)
    for rid in range(n_requests):
        svc.submit(SolveRequest(
            rid=rid, graph=parse_graph_instance(f"gnp:16:30:{rid}"),
            family="vc" if rid % 2 else "ds"))
    return svc, svc.drain()


def test_every_service_round_and_request_has_its_spans(recorder_on):
    svc, results = _service()
    run = spans.run_spans("service")
    tops, kids = _by_round(run)
    assert sorted(tops) == list(range(1, svc.rounds + 1))
    for r, top in tops.items():
        names = collections.Counter(s.name for s in kids[r])
        assert set(PHASES) | {"admit", "retire"} <= set(names), (r, names)
        direct = [s for s in kids[r] if s.parent == top.id]
        assert {s.name for s in direct} >= set(PHASES) | {"admit", "retire"}
    admits = {s.id: s for s in run if s.name == "admit"}
    rebuilds = [s for s in run if s.name == "rebuild"]
    assert rebuilds and all(s.parent in admits for s in rebuilds)
    assert len(results) == 5
    assert {s.clock for s in run} == {"host"}
    for rid, ticket in svc.tickets.items():
        mine = [s for s in run if s.rid == rid]
        (whole,) = [s for s in mine if s.name == "request"]
        (queued,) = [s for s in mine if s.name == "queued"]
        assert queued.parent == whole.id
        # Admitted in the admit span of the round after admitted_round.
        admit = next(s for s in admits.values()
                     if s.round == ticket.admitted_round + 1)
        assert admit.start_ns <= queued.end_ns <= admit.end_ns
        assert whole.end_ns >= queued.end_ns
        retire = next(s for s in run if s.name == "retire"
                      and s.round == ticket.finished_round)
        assert retire.start_ns <= whole.end_ns <= retire.end_ns


def test_a_cancelled_queued_request_closes_both_spans(recorder_on):
    svc = Solver(SolverConfig(lanes=8, steps_per_round=8, device="cpu")
                 ).serve(max_n=20, slots=1)
    for rid in range(3):
        svc.submit(SolveRequest(rid=rid,
                                graph=parse_graph_instance("gnp:16:30:1"),
                                family="vc"))
    svc.step_round()
    assert svc.cancel(2)
    run = spans.run_spans("service")
    assert sorted(s.name for s in run if s.rid == 2) == ["queued", "request"]
    assert not any(s.rid == 1 for s in run)        # still queued: open


# -- the search is the same with spans on or off -----------------------------

def _lanes_equal(a, b):
    for x, y in zip(a, b):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y)
        else:
            _lanes_equal(x, y)


def test_a_solve_is_bitwise_the_same_with_spans_on_and_off(recorder_on):
    on = _solve(metrics=True)
    spans.disable()
    before = len(spans.RECORDER.spans())
    off = _solve(metrics=True)
    assert len(spans.RECORDER.spans()) == before
    spans.enable()
    assert on.stats == off.stats
    _lanes_equal(on.lanes, off.lanes)
    assert torch.equal(on.payload, off.payload)


def test_a_service_is_bitwise_the_same_with_spans_on_and_off(recorder_on):
    svc_on, on = _service(on=True)
    svc_off, off = _service(on=False)
    spans.enable()
    assert spans.run_spans("service") == []      # the off run recorded none
    assert svc_on.rounds == svc_off.rounds
    assert sorted(on) == sorted(off)
    for rid in on:
        a, b = on[rid], off[rid]
        assert (a.optimum, a.admitted_round, a.retired_round, a.status) == \
            (b.optimum, b.admitted_round, b.retired_round, b.status)
        assert (a.payload == b.payload).all()
    _lanes_equal(svc_on.lanes, svc_off.lanes)


def test_the_span_code_is_in_the_round_loops_lint_scope():
    from repro_torch.analysis import lint_paths
    result = lint_paths(["src/repro_torch"], root=ROOT,
                        rules=["trace-safety"])
    assert result.findings == []
    for name in ("_Opened.__enter__", "_Opened.__exit__",
                 "SpanRecorder._push", "SpanRecorder._pop", "span",
                 "SpanRecorder._event", "SpanRecorder._close_device",
                 "pend_device"):
        assert f"repro_torch.obs.spans:{name}" in result.scanned

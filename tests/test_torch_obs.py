"""The port's search telemetry (``repro_torch.obs``) against the JAX
reference's ``repro.obs``.

(a) the metrics registry and the trace schema, the unit cases of
``tests/test_obs.py``; (b) record for record, the port's traces equal the
reference's (all fields but ``meta.backend`` and ``meta.config``) on vc,
ds and ss solves, a vc solve at ``fused_steps=3``, a solve resumed from a
checkpoint and a K=8 service drain, with equal metrics snapshots, and
``tools/trace_report.py`` reads each port trace unchanged; (c) telemetry is observation only: the same
``Lanes``, ``SolveStats`` and service results with it on and off.
"""

import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro import registry as jregistry
from repro.problems import gnp_graph as j_gnp
from repro.service import SolveRequest as JRequest
from repro.solver import Solver as JSolver
from repro.solver import SolverConfig as JConfig
from repro_torch import registry
from repro_torch.core.api import tree_leaves
from repro_torch.obs import (TRACE_KINDS, MetricsRegistry, TraceError,
                             TraceWriter, read_trace, validate_record)
from repro_torch.problems import gnp_graph
from repro_torch.service import SolveRequest
from repro_torch.solver import (EVENT_KINDS, ConfigError, ProgressEvent,
                                Solver, SolverConfig, emit)
from test_torch_service import assert_services_equal

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))
import trace_report  # noqa: E402  (tools/ is not a package)

BASE = dict(lanes=4, steps_per_round=16, bootstrap_rounds=2,
            bootstrap_steps=4)
VC = ("vc", "gnp:14:30:5")


# -- (a) metrics registry -----------------------------------------------------


def test_counter_labels_and_values():
    r = MetricsRegistry()
    c = r.counter("reqs", "requests")
    c.inc()
    c.inc(2, scope="cross")
    c.inc(3, scope="cross")
    assert c.value() == 1
    assert c.value(scope="cross") == 5
    with pytest.raises(ValueError):
        c.inc(-1)


def test_gauge_and_histogram():
    r = MetricsRegistry()
    g = r.gauge("depth", "queue depth")
    g.set(4)
    assert g.value() == 4
    h = r.histogram("ship", "depths", buckets=(1, 2, 4))
    for v in (1, 1, 3, 9):
        h.observe(v)
    got = h.value()
    assert got["count"] == 4 and got["sum"] == 14
    assert got["buckets"] == {"1": 2, "2": 0, "4": 1, "+Inf": 1}
    with pytest.raises(ValueError):
        r.histogram("bad", "unsorted", buckets=(4, 1))


def test_registry_idempotent_and_type_checked():
    r = MetricsRegistry()
    a = r.counter("x", "doc")
    assert r.counter("x", "doc") is a        # same instrument back
    with pytest.raises(ValueError, match="x"):
        r.gauge("x", "doc")                  # same name, different type


def test_disabled_registry_is_noop():
    r = MetricsRegistry(enabled=False)
    c = r.counter("x", "doc")
    c.inc(5)
    r.gauge("g", "doc").set(3)
    r.histogram("h", "doc").observe(1)
    snap = r.snapshot()
    assert snap.names() == ()
    assert snap.value("x") == 0              # missing counter reads as 0


def test_snapshot_is_a_frozen_copy():
    r = MetricsRegistry()
    c = r.counter("n", "doc")
    c.inc(2)
    snap = r.snapshot()
    c.inc(10)
    assert snap.value("n") == 2
    assert r.snapshot().value("n") == 12
    assert "n" in snap.to_dict()


# -- (a) trace schema ---------------------------------------------------------


def test_trace_kinds_are_the_reference_schema():
    from repro.obs import TRACE_KINDS as J_KINDS
    from repro.obs import TRACE_SCHEMA_VERSION as J_VERSION
    from repro_torch.obs import TRACE_SCHEMA_VERSION
    assert TRACE_KINDS == J_KINDS and TRACE_SCHEMA_VERSION == J_VERSION


def test_trace_writer_validates_and_reader_roundtrips(tmp_path):
    path = str(tmp_path / "t.jsonl")
    w = TraceWriter(path)
    w.write("meta", schema=1, mode="solve", lanes=4, slots=1)
    w.write("round", round=1, open=3, active=2, nodes=8, steal_req=1,
            steal_recv=1, donated=1, inst_nodes=[8])
    w.write("summary", rounds=1, nodes=8, lane_nodes=[8, 0, 0, 0],
            inst_nodes=[8])
    w.close()
    records = read_trace(path)
    assert [r["t"] for r in records] == ["meta", "round", "summary"]


def test_trace_writer_rejects_unknown_kind_and_missing_fields(tmp_path):
    w = TraceWriter(str(tmp_path / "t.jsonl"))
    with pytest.raises(TraceError, match="unknown"):
        w.write("explosion", round=1)
    with pytest.raises(TraceError, match="missing"):
        w.write("round", round=1)            # lacks nodes/steal_*/...
    with pytest.raises(TraceError):
        validate_record({"round": 1})        # no "t" discriminator
    w.close()


def test_read_trace_reports_line_numbers(tmp_path):
    path = tmp_path / "bad.jsonl"
    path.write_text('{"t":"meta","schema":1,"mode":"solve",'
                    '"lanes":4,"slots":1}\n'
                    '{"t":"nope"}\n')
    with pytest.raises(TraceError, match=":2:"):
        read_trace(str(path))


def test_trace_report_rejects_inconsistent_totals(tmp_path):
    path = str(tmp_path / "t.jsonl")
    w = TraceWriter(path)
    w.write("meta", schema=1, mode="solve", lanes=2, slots=1)
    w.write("summary", rounds=1, nodes=10, lane_nodes=[4, 4],
            inst_nodes=[10])
    w.close()
    with pytest.raises(ValueError, match="per-lane"):
        trace_report.analyze(read_trace(path))


# -- (a) centralized event emission -------------------------------------------


def test_progress_event_rejects_unknown_kind():
    with pytest.raises(ValueError, match="unknown"):
        ProgressEvent(kind="explosion", round=1)
    assert "round" in EVENT_KINDS and "done" in EVENT_KINDS


def test_emit_validates_even_without_listener():
    emit(None, "round", round=1, open_work=0)
    with pytest.raises(ValueError, match="unknown"):
        emit(None, "explosion", round=1)
    seen = []
    emit(seen.append, "done", round=3, open_work=0, best=7)
    assert len(seen) == 1 and seen[0].kind == "done" and seen[0].best == 7


def test_config_validates_trace_path():
    for bad in ("", 7):
        with pytest.raises(ConfigError):
            SolverConfig(device="cpu", trace_path=bad)


# -- (b) the port's traces are the reference's --------------------------------


def records(path):
    """A trace's records, less the two meta fields that name the package's
    own configuration."""
    out = [json.loads(line) for line in open(path)]
    for r in out:
        if r["t"] == "meta":
            r.pop("backend")
            r.pop("config", None)
    return out


def report_exits_zero(path):
    proc = subprocess.run([sys.executable, str(ROOT / "tools" /
                                               "trace_report.py"), str(path)],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "trace report" in proc.stdout


def traced_pair(tmp_path, family, spec, **cfg):
    """The same traced, metered solve in both packages: (port solver,
    result, trace path), (reference solver, result, trace path)."""
    out = []
    for tag, solver_cls, config_cls, reg, extra in (
            ("t", Solver, SolverConfig, registry, {"device": "cpu"}),
            ("j", JSolver, JConfig, jregistry, {})):
        path = tmp_path / f"{tag}.jsonl"
        solver = solver_cls(config_cls(**cfg, **extra, metrics=True,
                                       trace_path=str(path)))
        out.append((solver, solver.solve(reg.problem(family, spec)), path))
    return out


@pytest.mark.parametrize("family,spec,fused", [
    pytest.param(*VC, 1, id="vc-gnp:14:30:5"),
    pytest.param("ds", "gnp:14:30:2", 1, id="ds-gnp:14:30:2"),
    pytest.param("ss", "ss:14:5", 1, id="ss-ss:14:5"),
    pytest.param(*VC, 3, id="vc-gnp:14:30:5-fused3")])
def test_solve_trace_equals_reference(family, spec, fused, tmp_path):
    """The port's stats, trace records and metrics equal the reference's;
    at ``fused_steps=3`` the records' dispatch counts are the reference's
    grouped ones, the only place the port reads it."""
    (t_solver, t_res, t_path), (j_solver, j_res, j_path) = traced_pair(
        tmp_path, family, spec, **BASE, fused_steps=fused)
    assert t_res.stats == j_res.stats
    got = records(t_path)
    assert got == records(j_path)
    meta = json.loads(open(t_path).readline())
    assert meta["backend"] == "cpu" and meta["mode"] == "solve"
    assert meta["fused_steps"] == fused
    assert t_solver.metrics().to_dict() == j_solver.metrics().to_dict()
    summary = [r for r in got if r["t"] == "summary"][-1]
    assert summary["nodes"] == sum(summary["lane_nodes"]) == t_res.stats.nodes
    assert summary["rounds"] == t_res.stats.rounds
    report_exits_zero(t_path)


def test_resumed_solve_trace_equals_reference(tmp_path):
    """A reference checkpoint resumed at another lane count by both
    packages: the deltas count only the resumed run, record for record."""
    ckpt = str(tmp_path / "run.ckpt")
    JSolver(JConfig(lanes=8, steps_per_round=8, max_rounds=4,
                    checkpoint_every=2, checkpoint_path=ckpt)).solve(
        jregistry.problem("vc", "gnp:30:25:4"))
    (t_solver, t_res, t_path), (_, j_res, j_path) = traced_pair(
        tmp_path, "vc", "gnp:30:25:4", lanes=5, steps_per_round=8,
        resume_from=ckpt)
    assert t_res.stats == j_res.stats
    got = records(t_path)
    assert got == records(j_path)
    summary = got[-1]
    assert summary["t"] == "summary"
    assert summary["nodes"] < t_res.stats.nodes       # carried totals excluded
    assert t_solver.metrics().value("engine_nodes") == summary["nodes"]
    report_exits_zero(t_path)


def mix(gnp):
    return [("vc", gnp(12 + (i % 4), 0.3, seed=i)) for i in range(8)]


def test_service_trace_equals_reference_k8_drain(tmp_path):
    """The K=8 drain of tests/test_obs.py through both services: equal
    results, trace records and metrics; the report's ledger matches."""
    t_path, j_path = tmp_path / "t.jsonl", tmp_path / "j.jsonl"
    cfg = dict(lanes=16, steps_per_round=16, metrics=True)
    tsvc = Solver(SolverConfig(**cfg, device="cpu", trace_path=str(t_path))
                  ).serve(max_n=15, slots=4)
    jsvc = JSolver(JConfig(**cfg, trace_path=str(j_path))).serve(max_n=15,
                                                                  slots=4)
    for i, ((fam, g), (_, jg)) in enumerate(zip(mix(gnp_graph),
                                                mix(j_gnp))):
        tsvc.submit(SolveRequest(rid=i, graph=g, family=fam))
        jsvc.submit(JRequest(rid=i, graph=jg, family=fam))
    got, want = tsvc.drain(), jsvc.drain()
    assert {r: (v.optimum, v.status) for r, v in got.items()} == \
        {r: (v.optimum, v.status) for r, v in want.items()}
    assert tsvc.rounds == jsvc.rounds
    assert records(t_path) == records(j_path)
    assert tsvc.metrics().to_dict() == jsvc.metrics().to_dict()
    report = trace_report.analyze(read_trace(str(t_path)))
    assert report["mode"] == "service" and report["slots"] == 4
    assert report["lifecycle"]["admit"] == 8
    assert report["lifecycle"]["retire"] == 8
    assert sum(report["inst_nodes"]) == report["nodes"]
    assert report["nodes"] == tsvc.metrics().value("engine_nodes")
    assert tsvc.metrics().value("service_wait_rounds")["count"] == 8
    report_exits_zero(t_path)


def test_service_lifecycle_trace_equals_reference(tmp_path):
    """Cancel, deadline, budget and reject records through both services,
    record for record."""
    t_path, j_path = tmp_path / "t.jsonl", tmp_path / "j.jsonl"
    cfg = dict(lanes=8, steps_per_round=6)
    tsvc = Solver(SolverConfig(**cfg, device="cpu", trace_path=str(t_path))
                  ).serve(max_n=18, slots=2)
    jsvc = JSolver(JConfig(**cfg, trace_path=str(j_path))).serve(max_n=18,
                                                                 slots=2)
    reqs = [dict(n=18, seed=7, node_budget=5), dict(n=16, seed=2),
            dict(n=14, seed=3, deadline_rounds=2), dict(n=12, seed=4),
            dict(n=15, seed=5)]
    for svc, gnp, req_cls in ((tsvc, gnp_graph, SolveRequest),
                              (jsvc, j_gnp, JRequest)):
        tickets = []
        for rid, r in enumerate(reqs):
            kw = {k: v for k, v in r.items() if k not in ("n", "seed")}
            tickets.append(svc.submit(req_cls(
                rid=rid, graph=gnp(r["n"], 0.3, seed=r["seed"]),
                family="vc", **kw)))
        with pytest.raises(Exception) as err:
            svc.submit(req_cls(rid=9, graph=gnp(30, 0.3, seed=1),
                               family="vc"))
        assert type(err.value).__name__ == "AdmissionError"
        svc.step_round()
        tickets[4].cancel()
        svc.drain()
    got = records(t_path)
    assert got == records(j_path)
    kinds = [r["t"] for r in got]
    for kind in ("reject", "admit", "expire", "cancel", "retire"):
        assert kind in kinds, kind
    report_exits_zero(t_path)


# -- (c) telemetry is observation only ----------------------------------------


def assert_same_lanes(a, b):
    """Two port ``Lanes`` equal array for array."""
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert x.dtype == y.dtype
        assert torch.equal(x, y)


@pytest.mark.parametrize("family,spec", [VC, ("ss", "ss:12:3")])
def test_solve_identical_with_telemetry_on_and_off(family, spec, tmp_path):
    events = {"off": [], "on": []}
    off = Solver(SolverConfig(**BASE, device="cpu"),
                 on_event=events["off"].append).solve(
        registry.problem(family, spec))
    on = Solver(SolverConfig(**BASE, device="cpu", metrics=True,
                             trace_path=str(tmp_path / "t.jsonl")),
                on_event=events["on"].append).solve(
        registry.problem(family, spec))
    assert off.stats == on.stats
    assert_same_lanes(off.lanes, on.lanes)
    strip = [[(e.kind, e.round, e.open_work, e.best) for e in events[k]]
             for k in ("off", "on")]
    assert strip[0] == strip[1]
    rounds = [e for e in events["on"] if e.kind == "round"]
    assert rounds and all(e.metrics is not None for e in rounds)
    assert events["on"][-1].metrics.value("engine_nodes") == on.stats.nodes
    assert all(e.metrics is None for e in events["off"])


def test_service_identical_with_telemetry_on_and_off(tmp_path):
    """Results, tickets, rounds and lanes after every round are the same
    with telemetry on; with a collector the node budget still evicts."""
    svcs = [Solver(SolverConfig(lanes=8, steps_per_round=8, device="cpu",
                                **tele)).serve(max_n=18, slots=2)
            for tele in ({}, dict(metrics=True,
                                  trace_path=str(tmp_path / "t.jsonl")))]
    for svc in svcs:
        for rid, (n, seed, budget) in enumerate(((18, 7, 5), (16, 2, None),
                                                 (14, 3, None))):
            svc.submit(SolveRequest(rid=rid, graph=gnp_graph(n, 0.3, seed),
                                    family="vc", node_budget=budget))
    while svcs[0]._has_work():
        for svc in svcs:
            svc.step_round()
        assert_services_equal(svcs[1], svcs[0], f"round {svcs[0].rounds}")
    assert not svcs[1]._has_work()
    svcs[1].finalize_trace()
    assert svcs[0].results[0].status == "expired"
    assert svcs[1].tickets[0].nodes_used == svcs[0].tickets[0].nodes_used >= 5


def test_metrics_off_means_none():
    solver = Solver(SolverConfig(lanes=2, device="cpu"))
    assert solver.metrics() is None
    solver.solve(registry.problem(*VC))
    assert solver.metrics() is None
    assert solver.serve(max_n=8, slots=1).metrics() is None


def test_quickstart_example_runs_on_the_cpu():
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "torch_quickstart.py"),
         "--device", "cpu"], capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert proc.returncode == 0, proc.stderr
    assert "optimum matches the serial oracle" in proc.stdout

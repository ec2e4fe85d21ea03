"""The span readers (``portbench/spans.py``) on the CPU at tiny sizes: a
traced run of each cell reports every span metric; a program without
spans, or a ring that lost the window, reports none."""

from __future__ import annotations

import json
import pathlib
import sys

import pytest

from portbench import harness
from portbench import spans as span_readers

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _span_metrics(workload):
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    return {m["name"] for m in bench["per_layer"]
            if workload in m["workloads"]
            and "spans.py" in (ROOT / "portbench" / "metrics"
                               / f"{m['name']}.py").read_text()}


def test_thirteen_span_metrics_over_the_two_cells():
    solve = _span_metrics("vc-hard-saturated")
    service = _span_metrics("vc-service-closed")
    assert solve == {f"{p}_ms.solve" for p in
                     ("expand", "balance", "replay", "readback", "event")}
    assert service == {f"{p}_ms.service" for p in
                       ("admit", "rebuild", "expand", "balance", "replay",
                        "readback", "retire")} | {
                           "request_wait_p50_s.service"}


@pytest.mark.parametrize("workload", ["vc-hard-saturated",
                                      "vc-service-closed"])
def test_a_traced_run_reports_every_span_metric(tiny_root, workload):
    # Three seconds: the saturated readers leave out the window's last
    # round, so the window needs two rounds on a loaded host too.
    result = harness.run_cell(tiny_root, workload, 2 ** 31 + 55, 3.0, True,
                              device="cpu")
    assert result["correct"], result["checks"]
    metrics = result["metrics"]
    for name in _span_metrics(workload):
        assert isinstance(metrics[name]["value"], float), name
        assert metrics[name]["value"] >= 0.0
    if workload == "vc-service-closed":
        # The window's rounds lie inside the window, their phases inside
        # them.
        phases = sum(metrics[n]["value"] for n in _span_metrics(workload)
                     if n.endswith("_ms.service"))
        assert phases <= metrics["round_ms.service"]["value"]
        assert metrics["rebuild_ms.service"]["value"] > 0.0


def _reading(driver, **window):
    return dict(mix={"driver": driver, "settle_rounds": 4, "warm_rounds": 4},
                notes={"full_round": 12}, window=window)


def test_the_window_rounds_are_the_drivers():
    assert span_readers.window_rounds(
        _reading("saturated", rounds=100)) == range(17, 116)
    assert span_readers.window_rounds(
        _reading("closed_loop", rounds=100)) == range(5, 105)
    assert span_readers.window_rounds(_reading("saturated", rounds=1)) \
        is None
    assert span_readers.window_rounds(_reading("drain", rounds=9)) is None


def test_no_spans_no_number(tiny_root, monkeypatch):
    """A program without ``repro_torch.obs.spans`` (an older tree) and a
    ring that no longer holds the window both read as nothing."""
    from repro_torch import obs
    from repro_torch.obs import spans
    reading = _reading("closed_loop", rounds=3)
    rec = spans.SpanRecorder()
    monkeypatch.setattr(spans, "RECORDER", rec)
    run = rec.begin_run("service")
    for r in (6, 7):                  # round 5 fell out of the ring
        with rec.span("round", run=run, round=r):
            with rec.span("expand"):
                pass
    assert span_readers.self_ms("expand")(reading) is None
    with rec.span("round", run=run, round=5):
        pass
    assert span_readers.self_ms("expand")(reading) >= 0.0

    monkeypatch.delattr(obs, "spans")
    monkeypatch.setitem(sys.modules, "repro_torch.obs.spans", None)
    assert span_readers.self_ms("expand")(reading) is None
    assert span_readers.request_wait_p50_s(reading) is None

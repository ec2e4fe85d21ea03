"""The dominating-set cell, ``ds-hard-saturated`` (``ds-4096`` under the
``hard-saturated`` mix), on the CPU at tiny sizes: its result line, the
reference against the port round for round on a small random regular
graph, the planted faults and the control each reading not correct, and
its device-span metrics reading nothing off the card."""

from __future__ import annotations

import collections
import json
import pathlib

import pytest

from portbench import generate, harness
from portbench.conftest import tiny_copy
from portbench.test_portbench_faults import FAULTS
from portbench.test_portbench_reference import (
    test_reference_follows_the_port_round_for_round as follows)

ROOT = pathlib.Path(__file__).resolve().parent.parent
CELL = "ds-hard-saturated"
#: ``ds-4096`` cut to the CPU's size in the copy (the shared fixture's
#: table cuts the configurations that were there before it).
TINY = dict(lanes=64, steps_per_round=8)
DEVICE_METRICS = {f"{p}_dev_ms.solve" for p in ("expand", "balance",
                                                 "replay")}


def ds_copy(dest, **mix_change):
    root = tiny_copy(dest, **mix_change)
    path = root / "portbench" / "configs" / "ds-4096.json"
    path.write_text(json.dumps(dict(json.loads(path.read_text()), **TINY)))
    return root


@pytest.fixture
def ds_root(tmp_path):
    return ds_copy(tmp_path)


def test_the_cell_is_listed_with_its_metrics():
    bench = harness.load_bench(ROOT)
    wl, cfg, mix = harness.cell_spec(ROOT, bench, CELL)
    assert (wl["config"], wl["traffic"], wl["chips"]) == (
        "ds-4096", "hard-saturated", 1)
    assert cfg["problem"] == "ds" and cfg["reduced"] == []
    assert (cfg["lanes"], cfg["steps_per_round"]) == (4096, 64)
    assert mix["graph"] == {"family": "reg", "n": 300, "k": 4}
    traced = {m["name"] for m in harness.cell_metrics(bench, CELL, True)}
    assert DEVICE_METRICS <= traced
    assert {"round_ms.solve", "lane_util.solve", "readback_ms.solve",
            "count_stats_roofline.solve", "device_ops_per_round.solve",
            "idle_share.solve", "event_ms.solve"} <= traced
    assert not traced & {"expand_ms.solve", "balance_ms.solve",
                         "replay_ms.solve"}
    assert {m["name"] for m in harness.cell_metrics(bench, CELL, False)} \
        == {"nodes_per_s", "setup_s"}


@pytest.mark.parametrize("trace", [0, 1])
def test_result_line_schema_on_the_cpu(ds_root, trace):
    result = harness.run_cell(ds_root, CELL, 2 ** 31 + 101, 1.0,
                              bool(trace), device="cpu")
    assert list(result)[-1] == "checks"
    assert result["correct"] is True, result["checks"]
    assert set(result["checks"]) == {"round_mismatch", "payload_faults"}
    for c in result["checks"].values():
        assert set(c) == {"value", "limit"}
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"}
    want = {m["name"] for m in harness.cell_metrics(
        harness.load_bench(ds_root), CELL, bool(trace))}
    got = set(result["metrics"])
    assert got <= want
    if trace:
        assert {"busy_s", "window_s"} <= set(result["device"])
        # The CPU records no device span: those metrics read nothing.
        assert not got & DEVICE_METRICS
        assert "lane_util.solve" in got
    else:
        assert got == want
    json.loads(json.dumps(result))


def test_reference_follows_the_port_on_a_regular_graph():
    # 52 rounds, 5,277 nodes to the drain at 32 lanes and 8 steps.
    follows("ds", generate.reg(36, 4, 3), 32, 8)


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_timed_path_reads_not_correct(tmp_path, monkeypatch,
                                               fault):
    from repro_torch.core import engine
    root = ds_copy(tmp_path, late_s=2)
    monkeypatch.setattr(engine, "make_step", FAULTS[fault](engine.make_step))
    result = harness.run_cell(root, CELL, 2 ** 31 + 77, 0.5, False,
                              device="cpu")
    assert result["correct"] is False, result["checks"]


def test_the_control_reads_not_correct(ds_root):
    result = harness.run_cell(ds_root, CELL, 2 ** 31 + 5, 0.5, False,
                              device="cpu", control=True)
    assert result["correct"] is True
    assert any(c["value"] > c["limit"]
               for c in result["control_checks"].values())


def _reading(rounds):
    return dict(mix={"driver": "saturated", "settle_rounds": 4},
                notes={"full_round": 12}, window={"rounds": rounds})


def test_the_device_span_readers(monkeypatch):
    """Window rounds 17..19 of a 4-round window (the last left out): the
    mean device time a round by name; nothing when a round lacks its
    device span, or when the program files none (an older tree)."""
    from repro_torch.obs import spans
    from portbench.device_spans import device_ms
    rec = spans.SpanRecorder()
    monkeypatch.setattr(spans, "RECORDER", rec)
    run = rec.begin_run("solve")

    def round_(r, device=True):
        with rec.span("round", run=run, round=r):
            with rec.span("graph"):
                pass
        if device:
            for name, ms in (("expand", 2), ("balance", 1), ("balance", 1),
                             ("replay", 6)):
                rec._done.append(spans.Span(
                    -1, name, 0, ms * 1_000_000, None, run, r,
                    clock="device"))

    for r in (17, 18):
        round_(r)
    round_(19, device=False)
    assert device_ms("replay")(_reading(4)) is None
    round_(19)
    assert device_ms("expand")(_reading(4)) == pytest.approx(2.0)
    assert device_ms("balance")(_reading(4)) == pytest.approx(2.0)
    assert device_ms("replay")(_reading(4)) == pytest.approx(6.0)
    assert device_ms("graph")(_reading(4)) is None     # a host span
    # A tree whose spans have no clock: its host spans only.
    old = collections.namedtuple("OldSpan", spans.Span._fields[:-1])
    kept = [old(*s[:-1]) for s in rec.spans() if s.clock == "host"]
    rec._done.clear()
    rec._done.extend(kept)
    assert device_ms("expand")(_reading(4)) is None

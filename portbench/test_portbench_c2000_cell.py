"""The wide vertex-cover cell, ``vc-c2000-saturated`` (``vc-c2000`` under
the ``c2000-saturated`` mix), on the CPU at tiny sizes that keep a row
wider than 32 words: its entries, its result line, the reference against
the port round for round at w = 33 with the control reading not correct,
and the program counters its two new metrics read."""

from __future__ import annotations

import json
import pathlib
import types

import pytest
import torch

from portbench import generate, harness
from portbench.conftest import tiny_copy
from portbench.lanes import to_numpy
from portbench.reference import engine
from portbench.reference import vc as rvc
from portbench.reference.bits import num_words, pack

ROOT = pathlib.Path(__file__).resolve().parent.parent
CELL = "vc-c2000-saturated"
#: ``vc-c2000`` and its mix cut to the CPU's size in the copy: lanes and
#: steps as the DS cell's test cuts them, n = 1056 keeps 33 words a row
#: (the shared fixture's tables cut the configurations there before it).
TINY = dict(lanes=32, steps_per_round=8)
TINY_MIX = dict(graph={"family": "gnp", "n": 1056, "p": 0.5},
                fill_max_rounds=12)
SATURATED = ("vc-hard-saturated", "ds-hard-saturated", CELL)


def c2000_copy(dest):
    root = tiny_copy(dest)
    for kind, name, change in (("configs", "vc-c2000", TINY),
                               ("traffic", "c2000-saturated", TINY_MIX)):
        path = root / "portbench" / kind / f"{name}.json"
        path.write_text(json.dumps(dict(json.loads(path.read_text()),
                                        **change)))
    return root


def _port_problem(dense):
    from repro_torch.problems.graphs import Graph
    from repro_torch.problems.vertex_cover import make_vertex_cover
    return make_vertex_cover(Graph(n=dense.shape[0], adj=pack(dense)),
                             device="cpu")


def test_the_cell_is_listed_with_its_metrics():
    bench = harness.load_bench(ROOT)
    wl, cfg, mix = harness.cell_spec(ROOT, bench, CELL)
    assert (wl["config"], wl["traffic"], wl["chips"]) == (
        "vc-c2000", "c2000-saturated", 1)
    assert cfg["problem"] == "vc" and cfg["reduced"] == []
    assert cfg["reference"] == "portbench/reference/vc.py"
    assert (cfg["lanes"], cfg["steps_per_round"], cfg["max_ship"]) == (
        4096, 64, 16)
    assert mix["driver"] == "saturated"
    assert mix["graph"] == {"family": "gnp", "n": 2000, "p": 0.5}
    assert num_words(mix["graph"]["n"]) == 63 > 32
    assert (mix["fill_max_rounds"], mix["settle_rounds"],
            mix["profile_rounds"]) == (40, 4, 2)
    traced = {m["name"] for m in harness.cell_metrics(bench, CELL, True)}
    assert traced == {
        "round_ms.solve", "lane_util.solve", "count_stats_roofline.solve",
        "idle_share.solve", "device_ops_per_round.solve",
        "readback_ms.solve", "event_ms.solve", "expand_dev_ms.solve",
        "balance_dev_ms.solve", "replay_dev_ms.solve",
        "wide_route_share.solve", "stack_copy_gb.solve"}
    assert {m["name"] for m in harness.cell_metrics(bench, CELL, False)} \
        == {"nodes_per_s", "setup_s"}
    listed = {m["name"]: m["workloads"] for m in bench["per_layer"]}
    assert listed["wide_route_share.solve"] == [CELL]
    assert listed["stack_copy_gb.solve"] == list(SATURATED)


@pytest.mark.parametrize("trace", [0, 1])
def test_result_line_on_the_cpu(tmp_path, trace):
    root = c2000_copy(tmp_path)
    result = harness.run_cell(root, CELL, 2 ** 31 + 2000, 1.0, bool(trace),
                              device="cpu")
    assert list(result)[-1] == "checks"
    assert result["correct"] is True, result["checks"]
    assert set(result["checks"]) == {"round_mismatch", "payload_faults"}
    want = {m["name"] for m in harness.cell_metrics(
        harness.load_bench(root), CELL, bool(trace))}
    got = set(result["metrics"])
    assert got <= want
    if not trace:
        assert got == want
        return
    # 8 steps a round, each cloning every stack leaf of 32 lanes:
    # 1058 rows of 33 + 33 + 1 words.
    gb = result["metrics"]["stack_copy_gb.solve"]
    assert gb == {"value": pytest.approx(8 * 32 * 1058 * 67 * 4 / 1e9,
                                         rel=1e-12), "unit": "GB/round"}
    # No kernel launches on the CPU: the route share has nothing to read.
    assert "wide_route_share.solve" not in got
    json.loads(json.dumps(result))


def test_reference_follows_the_port_at_33_words():
    """G(1056, 0.5), 32 lanes: the port runs from the root to its first
    incumbent (rounds of 64 steps), then three rounds of 8 steps, each
    equal to the reference's round from the same state, field for field;
    the control, the reference with its proof dropped, differs."""
    from repro_torch.core.distributed import make_round
    from repro_torch.core.engine import init_lanes
    dense = generate.gnp(1056, 0.5, generate.instance_seed(3, 0))
    prob, node = _port_problem(dense), rvc.NODE(dense)
    lanes = init_lanes(prob, 32)
    run_up, round_fn = make_round(prob, 64), make_round(prob, 8)
    for _ in range(12):
        lanes, _ = run_up(lanes)
        if int(lanes.best.min()) < engine.INF:
            break
    else:
        pytest.fail("no incumbent in 12 rounds")
    mismatch = control = 0
    for _ in range(3):
        pre = to_numpy(lanes, node.leaves)
        lanes, work = round_fn(lanes)
        want, ref_work = engine.round_(node, pre, 8)
        mismatch += sum(engine.mismatches(
            want, to_numpy(lanes, node.leaves)).values())
        assert int(work.sum()) == int(ref_work.sum())
        control += sum(engine.mismatches(
            want, engine.round_(node, pre, 8, slack=1)[0]).values())
    assert mismatch == 0
    assert control > 0
    assert rvc.payload_faults(dense, to_numpy(lanes, node.leaves)[
        "best_payload"][0], int(lanes.best.min())) == 0


def test_stack_push_bytes_are_the_leaves_bytes_times_the_steps():
    from repro_torch.core.distributed import make_round
    from repro_torch.core.engine import init_lanes
    from repro_torch.kernels import _build
    prob = _port_problem(generate.gnp(1056, 0.5, 5))
    lanes = init_lanes(prob, 8)
    leaf_bytes = sum(s.numel() * s.element_size() for s in lanes.stack)
    assert leaf_bytes == 8 * 1058 * (33 + 33 + 1) * 4
    for steps in (1, 5):
        before = dict(_build.LAUNCHES)
        lanes, _ = make_round(prob, steps)(lanes)
        delta = {k: v - before[k] for k, v in _build.LAUNCHES.items()}
        assert delta.pop("stack_push_bytes") == steps * leaf_bytes
        assert not any(delta.values())        # the CPU launches nothing


def test_route_keys_count_each_launch_once(monkeypatch):
    """The launcher counts a launch under its kernel, and under
    ``<kernel>.<route>`` when the wrapper names one; a sum over
    ``_build.KERNELS`` counts every launch once.  The wrappers' route at
    the cell's width is the wide one."""
    from repro_torch.kernels import _build, bitset_ops
    assert bitset_ops._route("count_stats", None, 2000, 63, 4096, 1) == \
        "wide"
    assert bitset_ops._route("count_stats", None, 300, 10, 4096, 1) == \
        "narrow"
    monkeypatch.setattr(_build, "_entry", lambda name, argtypes: (
        lambda *args: 0))
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: (
        types.SimpleNamespace(cuda_stream=0)))
    before = dict(_build.LAUNCHES)
    for name, route in (("count_stats", "wide"), ("count_stats", "wide"),
                        ("count_stats", "narrow"),
                        ("stacked_count_stats", "wide"),
                        ("popcount_reduce", None)):
        _build.launch(name, [], [], "cuda", route=route)
    delta = {k: v - before[k] for k, v in _build.LAUNCHES.items()}
    assert {k: v for k, v in delta.items() if v} == {
        "count_stats": 3, "count_stats.wide": 2, "count_stats.narrow": 1,
        "stacked_count_stats": 1, "stacked_count_stats.wide": 1,
        "popcount_reduce": 1}
    assert sum(delta[k] for k in _build.KERNELS) == 5
    assert set(_build.LAUNCHES) - set(_build.KERNELS) == {
        f"{k}.{r}" for k in _build.ROUTED for r in ("narrow", "wide")} | {
            "stack_push_bytes"}


def test_the_new_readers_read_nothing_without_their_counters():
    """A program without the route and stack counters (an older tree)
    reports neither metric; with them, the arithmetic."""
    route = harness.reader(ROOT, "wide_route_share.solve")
    copied = harness.reader(ROOT, "stack_copy_gb.solve")
    old = dict(profile=dict(rounds=2, launches={"count_stats": 128}))
    assert route(old) is None and copied(old) is None
    assert route({}) is None and copied({}) is None
    new = dict(profile=dict(rounds=2, launches={
        "count_stats": 128, "count_stats.wide": 128,
        "stack_push_bytes": 2 * 64 * 4096 * 2002 * 127 * 4}))
    assert route(new) == 1.0
    assert copied(new) == pytest.approx(266.60464, rel=1e-6)

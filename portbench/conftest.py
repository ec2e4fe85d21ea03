"""Fixtures of the benchmark's CPU tests: a copy of the benchmark cut to
sizes the CPU runs in seconds (the cells' own sizes are the card's)."""

from __future__ import annotations

import json
import os
import pathlib
import shutil

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent

#: Tiny sizes of each configuration and mix.
TINY_CONFIGS = {"vc-4096": dict(lanes=64, steps_per_round=8),
                "ds-1024": dict(lanes=32, steps_per_round=8)}
TINY_MIXES = {
    "hard-saturated": dict(graph={"family": "reg", "n": 70, "k": 4},
                           fill_max_rounds=12),
    "drain-stream": dict(graph={"family": "gnp", "n": 24, "p": 0.2}, pool=2,
                         max_rounds=120),
    "service-closed": dict(graph={"family": "gnp", "n_min": 14, "n_max": 20,
                                  "p": 0.2},
                           pool=12, clients=6, slots=3, max_n=20,
                           warm_rounds=2,
                           late_s=20, profile_rounds=2),
}


#: A cell whose files stay under ``portbench/`` but that ``BENCHMARK.json``
#: does not list: the drain's rate follows the host's speed further than
#: any bound allows (PERF.md §7).  The copy lists it again, with the metrics
#: it reported, so that the tests still drive the drain driver and the
#: dominating-set reference; a later cell lists it by these entries alone.
PARKED = dict(
    config=dict(name="ds-1024", source="arXiv 1312.7626 Table 2",
                file="portbench/configs/ds-1024.json", reduced=[],
                why="dominating set at 1024 lanes on the shared engine"),
    workload=dict(name="ds-drain-stream", config="ds-1024",
                  traffic="drain-stream", chips=1,
                  why="a fixed pool of four G(60, 0.10) drained back to "
                      "back: ramp, steal and replay, the drain tail"),
    metrics=("nodes_per_s", "round_ms.solve", "lane_util.solve",
             "count_stats_roofline.solve", "idle_share.solve",
             "device_ops_per_round.solve"))


def tiny_copy(dest: pathlib.Path, **mix_change) -> pathlib.Path:
    """``BENCHMARK.json`` (the parked cell listed again) and
    ``portbench/`` copied under ``dest`` with the tiny sizes, and
    ``mix_change`` applied to every mix; ``src`` linked.  Returns the
    copy's root."""
    shutil.copytree(ROOT / "portbench", dest / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append(PARKED["config"])
    bench["workloads"].append(PARKED["workload"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in PARKED["metrics"]:
            m["workloads"].append(PARKED["workload"]["name"])
    (dest / "BENCHMARK.json").write_text(json.dumps(bench))
    os.symlink(ROOT / "src", dest / "src")
    for kind, table in (("configs", TINY_CONFIGS), ("traffic", TINY_MIXES)):
        for name, change in table.items():
            path = dest / "portbench" / kind / f"{name}.json"
            spec = json.loads(path.read_text())
            spec.update(change)
            if kind == "traffic":
                spec.update(mix_change)
            path.write_text(json.dumps(spec))
    return dest


@pytest.fixture
def tiny_root(tmp_path):
    return tiny_copy(tmp_path)

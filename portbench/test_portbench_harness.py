"""The harness on the CPU at tiny sizes: the result line's schema,
``BENCHMARK.json`` against the contract, file-only discovery of a new
cell, mix and metric, and the isolation of the run."""

from __future__ import annotations

import json
import pathlib
import re
import subprocess
import sys

import pytest

from portbench import harness

ROOT = pathlib.Path(__file__).resolve().parent.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_benchmark_json_keeps_to_the_contract():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"]
    assert 1 <= b["run_seconds"] <= 51
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("portbench/")
        assert (ROOT / c["file"]).exists()
    names = [w["name"] for w in b["workloads"]]
    assert len(set(names)) == len(names)
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (ROOT / "portbench" / "traffic" / f"{w['traffic']}.json"
                ).exists()
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").exists()
    for m in b["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        for w in m["workloads"]:
            assert w in names
            assert w in e2e[m["moves"]].get("workloads", names)
        if m["name"].split(".")[0].endswith("_roofline"):
            assert m["unit"] == "%"
    for w in names:   # every cell: setup_s, another end-to-end, a layer
        assert len(harness.cell_metrics(b, w, False)) >= 2
        assert harness.cell_metrics(b, w, True)


def _check_line(result, trace):
    keys = list(result)
    assert keys[-1] == "checks"
    for k in ("correct", "attempted", "failed", "metrics", "device"):
        assert k in result
    assert result["correct"] is True
    for name, c in result["checks"].items():
        assert set(c) == {"value", "limit"}
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"}
    if trace:
        assert {"busy_s", "window_s"} <= set(result["device"])
    json.loads(json.dumps(result))


@pytest.mark.parametrize("workload", ["vc-hard-saturated", "ds-drain-stream",
                                      "vc-service-closed"])
@pytest.mark.parametrize("trace", [0, 1])
def test_result_line_schema_on_the_cpu(tiny_root, workload, trace):
    result = harness.run_cell(tiny_root, workload, 2 ** 31 + 101, 1.0,
                              bool(trace), device="cpu")
    _check_line(result, trace)
    want = {m["name"] for m in harness.cell_metrics(
        harness.load_bench(tiny_root), workload, bool(trace))}
    got = set(result["metrics"])
    assert got <= want
    if not trace:
        assert got == want


def test_a_new_cell_mix_and_metric_are_found_from_files_alone(tiny_root):
    pb = tiny_root / "portbench"
    (pb / "configs" / "vc-tiny.json").write_text(json.dumps(dict(
        json.loads((pb / "configs" / "vc-4096.json").read_text()),
        name="vc-tiny", lanes=16, steps_per_round=4)))
    (pb / "traffic" / "tiny-drain.json").write_text(json.dumps(dict(
        driver="drain", graph={"family": "gnp", "n": 18, "p": 0.25},
        pool_base=3, pool=2, warm_rounds=1, max_rounds=120,
        profile_after_rounds=0, profile_rounds=2)))
    (pb / "metrics" / "solves_seen.py").write_text(
        "def read(r):\n    return float(len(r['notes']['optima']))\n")
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(name="vc-tiny", source="test",
                                 file="portbench/configs/vc-tiny.json",
                                 reduced=[], why="test"))
    bench["workloads"].append(dict(name="vc-tiny-drain", config="vc-tiny",
                                   traffic="tiny-drain", chips=1, why="t"))
    nps = next(m for m in bench["end_to_end"] if m["name"] == "nodes_per_s")
    nps["workloads"].append("vc-tiny-drain")
    bench["per_layer"].append(dict(
        name="solves_seen", unit="solves", better="higher",
        source="program_counter", layer="round loop", moves="nodes_per_s",
        workloads=["vc-tiny-drain"]))
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    result = harness.run_cell(tiny_root, "vc-tiny-drain", 5, 0.5, True,
                              device="cpu")
    assert result["correct"]
    assert result["metrics"]["solves_seen"]["value"] >= 2
    result = harness.run_cell(tiny_root, "vc-tiny-drain", 5, 0.5, False,
                              device="cpu")
    assert set(result["metrics"]) == {"nodes_per_s", "setup_s"}


def test_the_drain_window_attaches_no_listener(tiny_root, monkeypatch):
    # A listener costs the facade an incumbent readback a round, which a
    # user draining instances does not pay; only the traced solve after
    # the window listens.
    from repro_torch.solver import Solver
    listeners = []
    solve = Solver.solve

    def spy(self, *args, **kwargs):
        listeners.append(self.on_event)
        return solve(self, *args, **kwargs)

    monkeypatch.setattr(Solver, "solve", spy)
    result = harness.run_cell(tiny_root, "ds-drain-stream", 2 ** 31 + 9, 0.5,
                              False, device="cpu")
    assert result["correct"], result["checks"]
    assert len(listeners) >= 3 and all(e is None for e in listeners)


def test_a_run_loads_no_jax_and_no_jax_package(tiny_root):
    code = ("import sys, pathlib; sys.path[:0] = [%r, %r]\n"
            "from portbench import harness\n"
            "r = harness.run_cell(pathlib.Path(%r), 'vc-service-closed', 3, "
            "0.5, True, device='cpu')\n"
            "assert r['correct']\n"
            "print(harness.forbidden_modules())\n"
            % (str(tiny_root), str(ROOT / "src"), str(tiny_root)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_like", object())
    assert "repro_torch_like" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.fake", object())
    assert "repro.fake" in harness.forbidden_modules()


def test_no_harness_file_reads_the_old_benchmarks():
    for path in (ROOT / "portbench").rglob("*.py"):
        if path.name.startswith("test_"):
            continue
        text = path.read_text()
        for word in ("benchmarks/", "BENCH_", "chip_smoke", "import jax",
                     "from repro ", "import repro\n", "from repro."):
            assert word not in text, (path, word)


def test_without_a_card_the_run_exits_with_an_error_and_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would measure it")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "vc-hard-saturated", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=str(ROOT), capture_output=True, text=True, timeout=300)
    assert out.returncode == 2
    assert out.stdout == ""
    assert "CUDA" in out.stderr

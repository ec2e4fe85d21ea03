"""The cell runner: finds a cell's configuration, traffic mix and metric
readers by name, drives the mix's driver, and assembles the result line.

Everything one configuration, mix or metric needs sits in files of its
own, found by the names in ``BENCHMARK.json``:

* ``configs/<config>.json``   the deployment (problem, lanes, steps, ...);
* ``traffic/<mix>.json``      the mix's parameters; its ``driver`` names
                              ``drivers/<driver>.py``, the loop that drives
                              the program's entry point;
* ``metrics/<metric>.py``     one reader per metric: ``read(reading)``
                              returns the number, or None when the run has
                              nothing to read for it.

A driver's ``run(ctx)`` returns a *reading*: a dict with ``setup_s``, the
``window`` it measured, the ``profile`` of its traced rounds (traced runs
only), the ``checks`` that decide ``correct`` (name, value, limit),
``attempted`` and ``failed``.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import pathlib
import sys
import time
from typing import Dict, List, Optional

#: Top-level module names no run may load: JAX and the JAX package.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class NoDevice(RuntimeError):
    """The run found fewer CUDA cards than the cell asks for."""


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is forbidden, compared whole
    (``repro_torch`` is not ``repro``)."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".", 1)[0] in FORBIDDEN})


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_bench(root: pathlib.Path) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell_spec(root: pathlib.Path, bench: dict, workload: str):
    """(workload entry, configuration, mix) of cell ``workload``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no cell {workload!r} in BENCHMARK.json "
                       f"(cells: {', '.join(sorted(cells))})")
    wl = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg = load_json(root / configs[wl["config"]]["file"])
    mix = load_json(root / "portbench" / "traffic" / f"{wl['traffic']}.json")
    return wl, cfg, mix


def cell_metrics(bench: dict, workload: str, trace: bool) -> List[dict]:
    """The metrics a run of ``workload`` reports: its end-to-end metrics
    untraced, its per-layer metrics traced."""
    def listed(m):
        return "workloads" not in m or workload in m["workloads"]

    e2e = [m for m in bench["end_to_end"] if listed(m)]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if workload in m.get("workloads", ())
            or ("workloads" not in m and m["moves"] in moved)]


def reader(root: pathlib.Path, name: str):
    """``read`` of ``portbench/metrics/<name>.py``."""
    path = root / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def require_cards(chips: int) -> None:
    import torch
    if not torch.cuda.is_available():
        raise NoDevice("no CUDA card: the benchmark measures the port on "
                       "the card and never falls back to the CPU")
    if torch.cuda.device_count() < chips:
        raise NoDevice(f"the cell asks for {chips} cards, "
                       f"{torch.cuda.device_count()} present")


class Window:
    """The measured window and, in a traced run, the profiler over a fixed
    number of rounds right after it (``profile_rounds`` in the mix), so
    that the window's own rounds run unprofiled."""

    def __init__(self, ctx: "Context"):
        self.ctx = ctx
        self.seconds = float(ctx.seconds)
        self.t_start: Optional[float] = None
        self.t_end: Optional[float] = None
        self.rounds = 0
        self.memory_peak_bytes = 0
        self.profile: Optional[dict] = None
        self.traced_rounds = (int(ctx.mix.get("profile_rounds", 0))
                              if ctx.trace else 0)
        self._prof = None
        self._launch0: Dict[str, int] = {}
        self._p_start = 0.0
        self._p_rounds = 0

    def open(self) -> None:
        self.ctx.sync()
        self.t_start = time.perf_counter()
        self.ctx.setup_s = self.t_start - self.ctx.t0

    def tick(self) -> None:
        """After each round of the window."""
        self.rounds += 1

    def elapsed(self) -> float:
        return time.perf_counter() - self.t_start

    def expired(self) -> bool:
        return self.elapsed() >= self.seconds

    def close(self) -> None:
        self.ctx.sync()
        self.t_end = time.perf_counter()
        self.memory_peak_bytes = self.ctx.memory_peak()

    @property
    def elapsed_s(self) -> float:
        return self.t_end - self.t_start

    def profile_start(self) -> None:
        """Start the profiler (the traced rounds follow the window)."""
        from torch.profiler import ProfilerActivity, profile

        from repro_torch.kernels import _build
        acts = [ProfilerActivity.CPU]
        if self.ctx.device == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.start()
        self._launch0 = dict(_build.LAUNCHES)
        self._p_rounds = 0
        self.ctx.sync()
        self._p_start = time.perf_counter()

    def profile_tick(self) -> bool:
        """After each traced round; True once the last one has run (the
        profiler is then stopped)."""
        self._p_rounds += 1
        if self._p_rounds < self.traced_rounds:
            return False
        self.profile_stop()
        return True

    def profile_stop(self) -> None:
        from repro_torch.kernels import _build
        if self._prof is None:
            return
        self.ctx.sync()
        span = time.perf_counter() - self._p_start
        launches = {k: v - self._launch0.get(k, 0)
                    for k, v in _build.LAUNCHES.items()}
        self._prof.stop()
        self.profile = dict(prof=self._prof, window_s=span,
                            rounds=self._p_rounds, launches=launches)
        self._prof = None


class Context:
    """What a driver is given: the cell's files, the run's arguments, the
    device, and the window."""

    def __init__(self, config, mix, seed, seconds, trace, device, t0,
                 control=False):
        self.config = config
        self.mix = mix
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = device
        self.t0 = t0
        self.control = control
        self.setup_s: Optional[float] = None

    def window(self) -> Window:
        return Window(self)

    def sync(self) -> None:
        if self.device == "cuda":
            import torch
            torch.cuda.synchronize()

    def memory_peak(self) -> int:
        if self.device != "cuda":
            return 0
        import torch
        return int(torch.cuda.max_memory_allocated())

    def solver_config(self, **overrides):
        from repro_torch.solver import SolverConfig
        c = self.config
        kw = dict(lanes=int(c["lanes"]),
                  steps_per_round=int(c["steps_per_round"]),
                  max_ship=int(c["max_ship"]), device=self.device)
        kw.update(overrides)
        return SolverConfig(**kw)


def run_cell(root: pathlib.Path, workload: str, seed: int, seconds: float,
             trace: bool, *, device: str = "cuda",
             t0: Optional[float] = None, bench: Optional[dict] = None,
             control: bool = False) -> dict:
    """Run cell ``workload`` once and return its result (the dict printed
    as the last line).  ``device="cpu"`` is for the tests alone: the
    command line always asks for the card.  ``control`` adds the
    control's readings (``control_checks``) for ``portbench/control.py``.
    """
    t0 = time.perf_counter() if t0 is None else t0
    root = pathlib.Path(root)
    bench = load_bench(root) if bench is None else bench
    wl, cfg, mix = cell_spec(root, bench, workload)
    if device == "cuda":
        require_cards(int(wl["chips"]))
    ctx = Context(cfg, mix, seed, seconds, trace, device, t0,
                  control=control)
    driver = importlib.import_module(f"portbench.drivers.{mix['driver']}")
    reading = driver.run(ctx)
    reading["setup_s"] = ctx.setup_s
    reading["config"], reading["mix"] = cfg, mix

    profile = reading.get("profile")
    if profile is not None and profile.get("prof") is not None:
        from portbench import trace as trace_mod
        profile.update(trace_mod.reduce(profile.pop("prof")))

    metrics = {}
    for m in cell_metrics(bench, workload, trace):
        value = reader(root, m["name"])(reading)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    checks = reading["checks"]
    result = {
        "correct": all(v <= lim for _, v, lim in checks),
        "attempted": int(reading["attempted"]),
        "failed": int(reading["failed"]),
        "metrics": metrics,
        "device": device_info(device, int(wl["chips"]),
                              reading["memory_peak_bytes"]),
    }
    if trace and profile is not None and "busy_s" in profile:
        result["device"]["busy_s"] = profile["busy_s"]
        result["device"]["window_s"] = profile["window_s"]
        result["breakdown"] = {"device_ops": profile["top_ops"],
                               "idle_gaps": profile["idle_gaps"]}
    if control:
        result["control_checks"] = {n: {"value": v, "limit": lim}
                                    for n, v, lim in reading["control_checks"]}
    result["notes"] = reading.get("notes", {})
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    return result


def device_info(device: str, chips: int, peak: int) -> dict:
    if device != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": peak}
    import torch
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "memory_peak_bytes": peak}


def checks_text(result: dict) -> str:
    """The compared numbers, one line each, beside their limits."""
    return "\n".join(f"check {name}: {c['value']} (limit {c['limit']})"
                     for name, c in result["checks"].items())

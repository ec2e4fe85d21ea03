"""The arithmetic of the metric readers (``metrics/<name>.py`` each bind
one of these as ``read``).  A reader takes a run's reading and returns
its number, or None when the run holds nothing to read for it."""

from __future__ import annotations

from typing import Optional

from portbench import roofline
from portbench.stats import percentile


def setup_s(r: dict) -> Optional[float]:
    return r.get("setup_s")


def nodes_per_s(r: dict) -> Optional[float]:
    w = r["window"]
    return w["nodes"] / w["seconds"] if w.get("nodes") else None


def instances_per_s(r: dict) -> Optional[float]:
    w = r["window"]
    return w["done"] / w["seconds"] if w.get("done") else None


def latency_p95_s(r: dict) -> Optional[float]:
    lat = r["window"].get("latencies")
    return percentile(lat, 95) if lat else None


def queue_wait_p50_s(r: dict) -> Optional[float]:
    waits = r["window"].get("waits")
    return percentile(waits, 50) if waits else None


def round_ms(r: dict) -> Optional[float]:
    """Host milliseconds a round over the window (the traced rounds
    follow it)."""
    w = r["window"]
    return 1e3 * w["seconds"] / w["rounds"] if w.get("rounds") else None


def lane_util(r: dict) -> Optional[float]:
    """Search nodes over lane-steps: the share of the lanes' steps that
    visited a new node."""
    w = r["window"]
    return w["nodes"] / w["lane_steps"] if w.get("lane_steps") else None


def idle_share(r: dict) -> Optional[float]:
    p = r.get("profile") or {}
    if not p.get("busy_s") or not p.get("window_s"):
        return None
    return 1.0 - p["busy_s"] / p["window_s"]


def device_ops_per_round(r: dict) -> Optional[float]:
    p = r.get("profile") or {}
    if not p.get("device_ops") or not p.get("rounds"):
        return None
    return p["device_ops"] / p["rounds"]


def kernel_roofline(kernel: str):
    """The reader of ``<kernel>_roofline``: per cent of the least time of
    the profiled launches (bytes over HBM's rate at the cell's shape)."""
    def read(r: dict) -> Optional[float]:
        p = r.get("profile") or {}
        shape = r.get("shape", {}).get(kernel)
        if shape is None or not p.get("kernel_s"):
            return None
        nbytes = getattr(roofline, f"{kernel}_bytes")(*shape)
        return roofline.share_pct(p["launches"].get(kernel, 0),
                                  roofline.bound_s(nbytes),
                                  p["kernel_s"].get(kernel, 0.0))
    return read

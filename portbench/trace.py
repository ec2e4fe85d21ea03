"""Reduction of a traced window: what ran on the device, and when it was
idle, from ``torch.profiler``'s events.

* ``busy_s``: the union of the device's activity (kernels, copies,
  fills), so overlapping events count once;
* ``device_ops``: the number of those events;
* ``kernel_s``: device seconds of each of the program's bitset kernels;
* ``top_ops``: the 10 device operations that took most time (summed by
  name);
* ``idle_gaps``: the longest gaps between device activity (the 256
  longest), summed by the innermost host operation running over each
  gap's middle; the 10 largest sums.
"""

from __future__ import annotations

import re
from typing import Dict, List, Tuple

import numpy as np

#: The program's bitset kernels whose device time a roofline reads.
KERNELS = ("count_stats", "stacked_count_stats")
GAPS_NAMED = 256


def kernel_of(name: str):
    """Which of ``KERNELS`` a device event's name is, or None: a kernel of
    ``csrc/<k>.cu`` is named ``<k>_kernel`` or ``<k>_<pass>_kernel``, and
    ``count_stats`` must not match ``stacked_count_stats``."""
    for k in KERNELS:
        if re.search(r"(?<![A-Za-z_])" + k + r"(_\w+)?_kernel", name):
            return k
    return None


def _union(iv: np.ndarray) -> np.ndarray:
    """Merged intervals of ``iv`` [m, 2], sorted by start."""
    if iv.size == 0:
        return iv.reshape(0, 2)
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    out = [list(iv[0])]
    for s, e in iv[1:]:
        if s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return np.asarray(out, float)


def reduce_events(dev: List[Tuple[float, float, str]],
                  cpu: List[Tuple[float, float, str]]) -> dict:
    """The reduction over device and host events ``(start_us, end_us,
    name)`` on one clock."""
    out: Dict = {"device_ops": len(dev)}
    by_name: Dict[str, float] = {}
    kernel_s = dict.fromkeys(KERNELS, 0.0)
    for s, e, name in dev:
        by_name[name] = by_name.get(name, 0.0) + (e - s) * 1e-6
        k = kernel_of(name)
        if k is not None:
            kernel_s[k] += (e - s) * 1e-6
    out["kernel_s"] = kernel_s
    out["top_ops"] = [[n[:120], s] for n, s in
                      sorted(by_name.items(), key=lambda kv: -kv[1])[:10]]
    merged = _union(np.asarray([(s, e) for s, e, _ in dev], float))
    out["busy_s"] = float((merged[:, 1] - merged[:, 0]).sum() * 1e-6)

    gaps = []
    if cpu:
        lo = min(s for s, _, _ in cpu)
        hi = max(e for _, e, _ in cpu)
        edges = np.concatenate([[lo], merged.ravel(), [hi]]) \
            if merged.size else np.asarray([lo, hi])
        starts, ends = edges[0::2], edges[1::2]
        keep = ends > starts
        gaps = list(zip(starts[keep], ends[keep]))
    gaps.sort(key=lambda g: g[0] - g[1])
    named: Dict[str, float] = {}
    if gaps and cpu:
        cs = np.asarray([s for s, _, _ in cpu], float)
        ce = np.asarray([e for _, e, _ in cpu], float)
        dur = ce - cs
        names = [n for _, _, n in cpu]
        for s, e in gaps[:GAPS_NAMED]:
            mid = 0.5 * (s + e)
            cover = np.nonzero((cs <= mid) & (ce >= mid))[0]
            name = (names[cover[np.argmin(dur[cover])]] if cover.size
                    else "(no host operation)")
            named[name] = named.get(name, 0.0) + (e - s) * 1e-6
    out["idle_gaps"] = [[n[:120], s] for n, s in
                        sorted(named.items(), key=lambda kv: -kv[1])[:10]]
    return out


def reduce(prof) -> dict:
    """:func:`reduce_events` over a stopped ``torch.profiler.profile``."""
    from torch.autograd import DeviceType
    dev, cpu = [], []
    for evt in prof.events():
        tr = evt.time_range
        row = (float(tr.start), float(tr.end), evt.name)
        if evt.device_type == DeviceType.CUDA:
            dev.append(row)
        elif evt.device_type == DeviceType.CPU:
            cpu.append(row)
    return reduce_events(dev, cpu)

"""Per-round telemetry collector shared by both drivers (counterpart of
``repro.obs.collect``; DESIGN.md §8).

One :class:`RoundCollector` rides along a ``Solver.solve`` run or a
``SolverService``; the driver calls it at round boundaries:

  start(lanes)                  once, after init/restore (baseline)
  before_round(lanes, dirty)    after host-side lane surgery (admission,
                                pending-pool installs) — refreshes the
                                baseline when ``dirty`` so steal counts
                                measure the round ONLY
  after_round(round, lanes, …)  after the round — computes deltas,
                                updates the metrics registry, appends
                                trace records; returns the per-instance
                                node delta (the service reuses it for
                                node-budget accounting)
  lifecycle(kind, …)            admit/retire/expire/cancel/reject hooks
  finish(rounds, best)          writes the trace ``summary`` record

Cost model: every number comes from the lane counters the engine keeps
on the device (``nodes``/``t_s``/``t_r``/``donated``/``t_c``), the
control arrays (``active``/``inst``/``base``), ``steps`` and the
incumbent table.  :meth:`_read` stacks them into one int32 tensor and
copies it to the host with ONE ``.cpu()``, taken after the round's own
open-work readback; nothing runs inside the expand loop and nothing
computed here feeds back into device state, so the search tree is
bit-identical with telemetry on or off.

A lane whose ``t_s`` rose this round received a stolen task, and its
``base`` is the installed task's depth: the ship-depth histogram costs
nothing extra.  ``dispatches`` is the reference's ``ceil(steps /
fused_steps)`` per round, so traces of the two packages compare equal;
the port's real kernel launches are counted by ``kernels._build`` and are
no trace field.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.api import INF_VALUE
from repro_torch.obs.registry import MetricsRegistry, MetricsSnapshot
from repro_torch.obs.trace import TRACE_SCHEMA_VERSION, TraceWriter

__all__ = ["RoundCollector"]

# The incumbent watermark starts at the engine's "no solution" sentinel so
# a slot still at INF_VALUE never registers as an improvement.
_INF = int(INF_VALUE)

#: Subtree-depth buckets for the shipped-task histogram.
_SHIP_BUCKETS = (1, 2, 4, 8, 16, 32, 64)
#: Round-count buckets for scheduler wait/run histograms.
_ROUND_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256)

#: The int32[W] lane arrays one read copies, in this order.
_LANE_FIELDS = ("nodes", "t_s", "t_r", "donated", "t_c", "inst", "active",
                "base")


class RoundCollector:
    """Host-side per-round metrics + trace collection for one run, on one
    device or sharded over ``devices`` shards (per-shard gauges)."""

    def __init__(self, *, mode: str, lanes: int, slots: int,
                 steps_per_round: int, fused_steps: int = 1,
                 backend: str = "cuda", devices: int = 1,
                 registry: Optional[MetricsRegistry] = None,
                 trace: Optional[TraceWriter] = None):
        if mode not in ("solve", "service"):
            raise ValueError(f"mode must be 'solve' or 'service', got {mode!r}")
        self.mode = mode
        self.num_lanes = int(lanes)
        self.slots = int(slots)
        self.fused_steps = max(1, int(fused_steps))
        self.devices = max(1, int(devices))   # lane pool shards (mesh)
        self.registry = registry if registry is not None else MetricsRegistry()
        self.trace = trace

        r = self.registry
        self.c_rounds = r.counter("engine_rounds", "service/solve rounds run")
        self.c_nodes = r.counter("engine_nodes", "search nodes expanded")
        self.c_steps = r.counter("engine_steps", "engine steps executed")
        self.c_dispatches = r.counter(
            "engine_dispatches",
            "fused step-group launches (ceil(steps/fused_steps) per round)")
        self.c_steal_req = r.counter("steal_requests",
                                     "task requests made (paper T_R)")
        self.c_steal_recv = r.counter(
            "steal_received",
            "tasks received via stealing (paper T_S), by scope label")
        self.c_donated = r.counter("steal_donated", "tasks donated")
        self.c_incumbent = r.counter("incumbent_improvements",
                                     "per-instance incumbent improvements")
        self.g_util = r.gauge("lane_utilization",
                              "active-lane fraction at the last round end")
        self.g_open = r.gauge("open_work", "total open work at last round end")
        self.h_ship = r.histogram("steal_ship_depth",
                                  "depth of shipped subtree roots",
                                  buckets=_SHIP_BUCKETS)
        self.g_dev_nodes = r.gauge(
            "device_nodes", "nodes expanded last round, per device shard")
        self.g_dev_active = r.gauge(
            "device_active_lanes", "active lanes at round end, per device")
        if mode == "service":
            self.g_queue = r.gauge("service_queue_depth",
                                   "queued (unadmitted) requests")
            self.h_wait = r.histogram("service_wait_rounds",
                                      "rounds queued before admission",
                                      buckets=_ROUND_BUCKETS)
            self.h_run = r.histogram("service_run_rounds",
                                     "rounds from admission to resolution",
                                     buckets=_ROUND_BUCKETS)

        self._base: Optional[Dict[str, np.ndarray]] = None
        self._best_seen = np.full((self.slots,), _INF, np.int64)
        self._inst_nodes = np.zeros((self.slots,), np.int64)
        self._lane = {k: np.zeros((self.num_lanes,), np.int64)
                      for k in ("nodes", "recv", "req", "donated", "cross")}
        self._steps = 0
        self._dispatches = 0
        self._rounds_seen = 0
        if trace is not None:
            trace.write("meta", schema=TRACE_SCHEMA_VERSION, mode=mode,
                        lanes=self.num_lanes, slots=self.slots,
                        steps_per_round=int(steps_per_round),
                        fused_steps=self.fused_steps, backend=backend,
                        devices=self.devices)

    # -- round boundaries ---------------------------------------------------

    @staticmethod
    def _read(lanes) -> Dict[str, np.ndarray]:
        """The lane arrays, ``steps`` and the incumbent table, stacked on
        the device into one int32 tensor and copied to the host once."""
        w = lanes.nodes.shape[0]
        flat = torch.cat([
            torch.stack([getattr(lanes, f).to(torch.int32)
                         for f in _LANE_FIELDS]).reshape(-1),
            lanes.steps.reshape(1).to(torch.int32),
            lanes.best.to(torch.int32)])
        host = flat.cpu().numpy().astype(np.int64)       # the one copy
        out = {f: host[i * w:(i + 1) * w]
               for i, f in enumerate(_LANE_FIELDS)}
        tail = len(_LANE_FIELDS) * w
        out["steps"] = host[tail]
        out["best"] = host[tail + 1:]
        return out

    def start(self, lanes) -> None:
        """Capture the delta baseline (call after init or restore, so a
        restored checkpoint's carried totals never count as this run's)."""
        self._base = self._read(lanes)

    def before_round(self, lanes, dirty: bool) -> None:
        """Refresh the baseline iff host-side surgery touched the lanes
        since ``after_round`` (admissions and pool installs bump ``t_s``;
        without the refresh they would masquerade as steals)."""
        if dirty or self._base is None:
            self._base = self._read(lanes)

    def after_round(self, round_no: int, lanes, open_total: int, *,
                    queue_depth: int = 0,
                    slot_rids: Optional[Sequence[int]] = None) -> np.ndarray:
        """Ingest one finished round; returns int64[K] node deltas."""
        cur = self._read(lanes)
        base = self._base if self._base is not None else {
            k: np.zeros_like(v) for k, v in cur.items()}
        d_nodes = cur["nodes"] - base["nodes"]
        d_recv = cur["t_s"] - base["t_s"]
        d_req = cur["t_r"] - base["t_r"]
        d_don = cur["donated"] - base["donated"]
        d_cross = cur["t_c"] - base["t_c"]
        d_steps = int(cur["steps"] - base["steps"])
        self._base = cur

        inst, active = cur["inst"], cur["active"] != 0
        lane_base, best = cur["base"], cur["best"]

        inst_delta = np.zeros((self.slots,), np.int64)
        bound = inst >= 0
        np.add.at(inst_delta, inst[bound], d_nodes[bound])
        self._inst_nodes += inst_delta
        for key, d in (("nodes", d_nodes), ("recv", d_recv), ("req", d_req),
                       ("donated", d_don), ("cross", d_cross)):
            self._lane[key] += d
        dispatches = -(-d_steps // self.fused_steps) if d_steps > 0 else 0
        self._steps += d_steps
        self._dispatches += dispatches
        self._rounds_seen += 1
        ship_depths = [int(d) for d in lane_base[d_recv > 0]]

        self.c_rounds.inc()
        self.c_nodes.inc(int(d_nodes.sum()))
        self.c_steps.inc(d_steps)
        self.c_dispatches.inc(dispatches)
        self.c_steal_req.inc(int(d_req.sum()))
        n_cross = int(d_cross.sum())
        self.c_steal_recv.inc(int(d_recv.sum()) - n_cross, scope="intra")
        self.c_steal_recv.inc(n_cross, scope="cross")
        self.c_donated.inc(int(d_don.sum()))
        self.g_util.set(float(active.mean()) if active.size else 0.0)
        self.g_open.set(int(open_total))
        for depth in ship_depths:
            self.h_ship.observe(depth)
        if self.mode == "service":
            self.g_queue.set(int(queue_depth))

        # Per-shard lane metrics: shard d owns lanes [d*W/D, (d+1)*W/D).
        dev_nodes = dev_active = None
        if self.devices > 1 and self.num_lanes % self.devices == 0:
            dev_nodes = d_nodes.reshape(self.devices, -1).sum(axis=1)
            dev_active = active.reshape(self.devices, -1).sum(axis=1)
            for d in range(self.devices):
                self.g_dev_nodes.set(int(dev_nodes[d]), device=d)
                self.g_dev_active.set(int(dev_active[d]), device=d)

        improved = []
        for slot in range(self.slots):
            b = int(best[slot])
            if b < self._best_seen[slot]:
                self._best_seen[slot] = b
                rid = None
                if slot_rids is not None and int(slot_rids[slot]) >= 0:
                    rid = int(slot_rids[slot])
                self.c_incumbent.inc()
                improved.append((slot, b, rid))

        if self.trace is not None:
            self.trace.write(
                "round", round=int(round_no), open=int(open_total),
                active=int(active.sum()), nodes=int(d_nodes.sum()),
                steal_req=int(d_req.sum()), steal_recv=int(d_recv.sum()),
                steal_recv_cross=n_cross, donated=int(d_don.sum()),
                steps=d_steps, dispatches=dispatches,
                inst_nodes=[int(x) for x in inst_delta],
                ship_depths=ship_depths, best=[int(b) for b in best],
                queue_depth=int(queue_depth),
                dev_nodes=(None if dev_nodes is None
                           else [int(x) for x in dev_nodes]),
                dev_active=(None if dev_active is None
                            else [int(x) for x in dev_active]))
            for slot, b, rid in improved:
                self.trace.write("incumbent", round=int(round_no), inst=slot,
                                 best=b, rid=rid)
        return inst_delta

    # -- elastic events -----------------------------------------------------

    def resize(self, num_lanes: int, *, devices: int,
               round_no: int) -> None:
        """Re-shape the per-lane accounting after an elastic pool resize.
        As the engine's carried counters do (checkpoint restore and
        ``repartition`` sum each counter onto lane 0), the per-lane totals
        collapse onto lane 0 of the new layout, so the summary ledger
        (sum(lane_nodes) == nodes == sum(inst_nodes)) stays exact across
        resizes.  The delta baseline is dropped: the driver re-baselines
        through ``before_round(dirty=True)`` on the rebuilt lanes."""
        self.num_lanes = int(num_lanes)
        self.devices = max(1, int(devices))
        for key, old in self._lane.items():
            carried = np.zeros((self.num_lanes,), np.int64)
            carried[0] = old.sum()
            self._lane[key] = carried
        self._base = None
        if self.trace is not None:
            self.trace.write("resize", round=int(round_no),
                             lanes=self.num_lanes, devices=self.devices)

    # -- request lifecycle (service) ----------------------------------------

    def lifecycle(self, kind: str, *, round_no: int, rid: int,
                  slot: Optional[int] = None, best: Optional[int] = None,
                  waited: Optional[int] = None, ran: Optional[int] = None,
                  reason: Optional[str] = None) -> None:
        """One request transition: histogram wait/run rounds and append the
        trace record.  An admitted slot's incumbent watermark resets so the
        next tenant's improvements are reported from scratch."""
        if kind == "admit":
            if slot is not None:
                self._best_seen[slot] = _INF
            if waited is not None and self.mode == "service":
                self.h_wait.observe(int(waited))
        elif kind in ("retire", "expire", "cancel"):
            if ran is not None and self.mode == "service":
                self.h_run.observe(int(ran))
        if self.trace is not None:
            self.trace.write(kind, round=int(round_no), rid=int(rid),
                             slot=slot, best=best, waited=waited, ran=ran,
                             reason=reason)

    # -- wrap-up ------------------------------------------------------------

    def finish(self, *, rounds: int,
               best: Optional[List[int]] = None) -> None:
        """Append the trace ``summary`` (per-lane/-instance totals this run).
        Callable repeatedly — a service summarizes after every drain and
        readers take the last summary."""
        if self.trace is not None:
            self.trace.write(
                "summary", round=int(rounds), rounds=self._rounds_seen,
                nodes=int(self._lane["nodes"].sum()),
                best=best,
                lane_nodes=[int(x) for x in self._lane["nodes"]],
                lane_recv=[int(x) for x in self._lane["recv"]],
                lane_req=[int(x) for x in self._lane["req"]],
                lane_donated=[int(x) for x in self._lane["donated"]],
                lane_cross=[int(x) for x in self._lane["cross"]],
                inst_nodes=[int(x) for x in self._inst_nodes],
                steps=self._steps, dispatches=self._dispatches)

    def close(self) -> None:
        if self.trace is not None:
            self.trace.close()

    def snapshot(self) -> MetricsSnapshot:
        return self.registry.snapshot()

"""Continuous-batching solver service over one lane pool (counterpart of
``repro.service.driver``).

  * the *pool* is W engine lanes advancing in lockstep under one round
    (expand -> instance-scoped steal -> per-instance open-work count);
  * a *slot* is one of K stacked-instance table entries
    (``batch_problem.StackedSpec``); a request holds a slot from
    admission to retirement or eviction;
  * *admission* pops the next request from the scheduling policy
    (:mod:`repro_torch.service.scheduler`, priority heap by default),
    packs it through the registry and writes it into the slot of the
    preallocated device tables IN PLACE, resets the slot's incumbent and
    seeds the instance root onto one idle lane; every other lane the
    instance uses arrives by stealing;
  * *retirement* fires when the slot's open-work count reaches zero: the
    optimum and payload are recorded and the ticket resolves DONE;
  * *eviction* fires on ``Ticket.cancel()``, a missed ``deadline_rounds``
    or an exhausted ``node_budget``: the best-so-far is recorded as an
    anytime result, the slot's lanes are deactivated and unbound, and the
    ticket resolves CANCELLED / EXPIRED.

The round and the bound problem are built once and close over the device
tables, which are never replaced: every admission's table write is seen
by the next round.  The host reads back one value per round, the
per-slot open-work vector, plus the event-driven readbacks the reference
marks (admission and placement checks, retirement, eviction, node-budget
accounting).

``save``/``restore`` persist the whole service (lane control state, slot
tables, queued-request heap, ticket states) through
``repro_torch.core.checkpoint``, in the reference's file format; restoring
onto W' != W lanes parks surplus tasks in an instance-tagged pending pool.

Telemetry (``trace_path``, ``metrics``) rides one
``repro_torch.obs.RoundCollector``, fed at round boundaries: its one copy
of the lane counters per round also serves node-budget accounting.

Sharded (``mesh``, DESIGN.md §9): the pool is split over the mesh's
shards, ``num_lanes`` per shard; the stacked tables are bound once per
distinct device and every admission writes each copy; rounds steal across
shards (``repro_torch.core.distributed``).  Host surgery reads the
gathered lanes, writes back only the fields it changed, shard by shard,
and replays stacks per shard.  ``resize`` re-lays the pool onto another
mesh or lane count between rounds, through ``checkpoint.repartition``;
``maybe_autoscale`` asks an ``AutoscalePolicy`` each round.
"""

from __future__ import annotations

import warnings
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import registry
from repro_torch.convert import stacked_tables
from repro_torch.core import checkpoint as ckpt
from repro_torch.core.api import INF_VALUE, UNVISITED, resolve_device, tree_map
from repro_torch.core.distributed import (Mesh, ShardedLanes, _gather_lanes,
                                         _shard_lanes, available_devices,
                                         make_round, replace_sharded)
from repro_torch.core.engine import NO_INSTANCE, Lanes, init_lanes
from repro_torch.obs import spans
from repro_torch.problems.graphs import Graph, num_words
from repro_torch.service.batch_problem import StackedSpec, StackedTables
from repro_torch.service.scheduler import (AutoscalePolicy, QueueItem,
                                           Scheduler, SchedulingPolicy,
                                           make_policy)
from repro_torch.service.ticket import (TERMINAL, AdmissionError,
                                        RequestResult, SolveRequest, Ticket,
                                        TicketStatus)

__all__ = [
    "AdmissionError",
    "RequestResult",
    "SolveRequest",
    "SolverService",
]

#: Lane fields the host edits at admission (``_host_lane_fields``).
_HOST_FIELDS = ("idx", "depth", "base", "inst", "active", "t_s", "best")

#: The index of a root task: no branch taken yet.
_NO_PATH = np.zeros((0,), np.int8)


class _ResultMap(dict):
    """Results keyed by int rid; lookups normalise Tickets through
    ``int()`` (the reference's deprecated Ticket-as-rid surface)."""

    def __getitem__(self, key):
        return super().__getitem__(int(key))

    def __contains__(self, key):
        return super().__contains__(int(key))

    def get(self, key, default=None):
        return super().get(int(key), default)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


class SolverService:
    """Fixed pool of W lanes continuously batched over streamed requests.

    Construct through :meth:`repro_torch.solver.Solver.serve` (or
    :meth:`from_config`); direct ``SolverService(...)`` construction is the
    reference's deprecated surface and warns as it does.
    """

    def __init__(self, *, max_n: int, slots: int, num_lanes: int,
                 steps_per_round: int = 64, device: str = "cuda",
                 scheduler: Union[str, SchedulingPolicy] = "priority",
                 fused_steps: int = 1):
        warnings.warn(
            "direct SolverService(...) construction is deprecated; use "
            "repro_torch.solver.Solver(SolverConfig(...)).serve(max_n=..., "
            "slots=...)", DeprecationWarning, stacklevel=2)
        self._init(max_n=max_n, slots=slots, num_lanes=num_lanes,
                   steps_per_round=steps_per_round, device=device,
                   scheduler=scheduler, fused_steps=fused_steps)

    @classmethod
    def from_config(cls, config, *, max_n: int, slots: int,
                    on_event: Optional[Callable[[Any], None]] = None
                    ) -> "SolverService":
        """The facade constructor: lanes / steps_per_round / device /
        scheduler / fused_steps / mesh / max_ship / autoscale / telemetry
        come from a :class:`repro_torch.solver.SolverConfig`."""
        return cls._create(max_n=max_n, slots=slots, num_lanes=config.lanes,
                           steps_per_round=config.steps_per_round,
                           device=config.device, scheduler=config.scheduler,
                           fused_steps=config.fused_steps, mesh=config.mesh,
                           max_ship=config.max_ship,
                           autoscale=config.autoscale,
                           trace_path=config.trace_path,
                           metrics=config.metrics, on_event=on_event)

    @classmethod
    def _create(cls, **kwargs) -> "SolverService":
        svc = object.__new__(cls)
        svc._init(**kwargs)
        return svc

    def _init(self, *, max_n: int, slots: int, num_lanes: int,
              steps_per_round: int = 64, device: str = "cuda",
              scheduler: Union[str, SchedulingPolicy] = "priority",
              fused_steps: int = 1, mesh: Optional[Mesh] = None,
              max_ship: int = 16,
              autoscale: Optional[AutoscalePolicy] = None,
              trace_path: Optional[str] = None, metrics: bool = False,
              on_event: Optional[Callable[[Any], None]] = None):
        self.spec = StackedSpec(n=max_n, k=slots)
        self.device = resolve_device(device)
        self.steps_per_round = steps_per_round
        self.max_ship = max_ship              # cross-device ship cap / round
        self.on_event = on_event
        self.autoscale = autoscale            # elasticity policy, or None
        self.tables = self.spec.empty_tables()            # host numpy
        # Mesh layout: ``num_lanes`` is the PER-SHARD lane count.
        self.mesh = mesh
        self.n_devices = mesh.size if mesh is not None else 1
        self.lanes_per_device = num_lanes
        self.num_lanes = num_lanes * self.n_devices
        self._build_round_fns()
        self._set_lanes(init_lanes(self.problem, self.num_lanes,
                                   seed_root=False, bind_instance=False))

        policy = (scheduler if not isinstance(scheduler, str)
                  else make_policy(scheduler))
        self.sched = Scheduler(policy)
        self.slot_rid: List[int] = [-1] * slots          # -1 = free slot
        self.slot_admitted: List[int] = [0] * slots
        self._slot_best_seen: List[int] = [int(INF_VALUE)] * slots
        self.results: Dict[int, RequestResult] = _ResultMap()
        self.pool: List[ckpt.PendingTask] = []
        self.rounds = 0
        # True when the placement check last passed with at most one live
        # slot: _admit_and_place then skips its device readback until the
        # next placement-changing event (admission, retire/evict, pool
        # install) clears it.
        self._placement_clean = False

        # Host-time spans (obs/spans.py): this service's run, and each
        # live request's (request, queued) span ids.
        self._span_run = spans.begin_run("service")
        self._request_spans: Dict[int, Tuple[int, int]] = {}

        # Telemetry (DESIGN.md §8): one RoundCollector fed at round
        # boundaries.
        self.metrics_enabled = bool(metrics)
        self._collector = None
        if metrics or trace_path is not None:
            from repro_torch import obs
            self._collector = obs.RoundCollector(
                mode="service", lanes=self.num_lanes, slots=slots,
                steps_per_round=steps_per_round, fused_steps=fused_steps,
                backend=self.device.type, devices=self.n_devices,
                trace=obs.TraceWriter(trace_path) if trace_path else None)
            self._collector.start(self.lanes)

    def _build_round_fns(self) -> None:
        """(Re)build the device tables, the bound problems and the round
        for the current mesh: called at construction and by
        :meth:`resize`.  The tables are bound once per distinct device;
        each copy is written in place at admission, and the problems and
        the round close over these very tensors."""
        mesh = self.mesh
        if mesh is not None and mesh.device_type != self.device.type:
            raise ValueError(f"a mesh of {mesh.device_type} devices for a "
                             f"service on {self.device.type}")
        devices = mesh.distinct() if mesh is not None else (self.device,)
        self._home = mesh.devices[0] if mesh is not None else self.device
        self._tables_by_dev = {dev: stacked_tables(self.tables, dev)
                               for dev in devices}
        problems = {dev: self.spec.bind(tables, dev)
                    for dev, tables in self._tables_by_dev.items()}
        self._tables_dev = self._tables_by_dev[self._home]
        self.problem = problems[self._home]       # where gathered lanes live
        self._problems = problems
        self._round = make_round(self.problem if mesh is None else problems,
                                 self.steps_per_round, mesh=mesh,
                                 max_ship=self.max_ship)

    def _set_lanes(self, lanes: Lanes) -> None:
        """Adopt ``lanes`` (all of them, on the home device), sharded over
        the mesh when there is one."""
        self.lanes = (lanes if self.mesh is None
                      else _shard_lanes(lanes, self.mesh))

    def _replace_lanes(self, **fields) -> None:
        """``Lanes._replace`` of the pool with gathered-layout values; on a
        mesh each shard takes its slice of each field and keeps the rest."""
        self.lanes = (self.lanes._replace(**fields) if self.mesh is None
                      else replace_sharded(self.lanes, self.mesh, **fields))

    def _rebuild_stacks(self, touched: np.ndarray,
                        depth: np.ndarray) -> None:
        """CONVERTINDEX replay of the ``touched`` lanes' stacks (bool[W],
        gathered layout, with ``depth`` the host's copy), per shard."""
        with spans.span("rebuild"):
            if self.mesh is None:
                self.lanes = ckpt.rebuild_stacks(self.problem, self.lanes,
                                                 touched, depth)
            else:
                w = self.lanes_per_device
                self.lanes = ShardedLanes([
                    ckpt.rebuild_stacks(self._problems[dev], shard,
                                        touched[r * w:(r + 1) * w],
                                        depth[r * w:(r + 1) * w])
                    for r, (dev, shard) in enumerate(zip(
                        self.mesh.devices, self.lanes.shards))])

    def metrics(self):
        """``repro_torch.obs.MetricsSnapshot`` of this service's registry,
        or None when telemetry is off (enable via
        ``SolverConfig(metrics=True)`` or ``trace_path=...``)."""
        return (self._collector.snapshot()
                if self._collector is not None else None)

    def finalize_trace(self) -> None:
        """Append a trace ``summary`` record (per-lane / per-instance
        totals so far).  Called by :meth:`drain`; call it directly when
        stepping rounds by hand.  Readers use the last summary."""
        if self._collector is not None:
            self._collector.finish(rounds=self.rounds,
                                   best=self.lanes.best.tolist())

    # -- host/device plumbing ----------------------------------------------

    def _write_slot(self, slot: int) -> None:
        """Copy host slot ``slot`` into every device's tables, in place."""
        for dev in self._tables_by_dev.values():
            dev.adj[slot].copy_(torch.from_numpy(
                self.tables.adj[slot].view(np.int32)))
            dev.fullm[slot].copy_(torch.from_numpy(
                self.tables.fullm[slot].view(np.int32)))
            dev.family[slot] = int(self.tables.family[slot])

    def _write_tables(self) -> None:
        """Copy every host slot into the device tables, in place."""
        for slot in range(self.spec.k):
            self._write_slot(slot)

    def _to_dev(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(arr).to(self._home)

    # -- the ticketed front door -------------------------------------------

    @property
    def queue(self) -> Tuple[SolveRequest, ...]:
        """Queued (not yet admitted) requests, in pop order."""
        return tuple(item.request for item in self.sched.pending())

    @property
    def tickets(self) -> Dict[int, Ticket]:
        """Every ticket this service has issued, by rid."""
        return self.sched.tickets

    def submit(self, request: SolveRequest) -> Ticket:
        """Queue a request after full admission validation; returns its
        :class:`~repro_torch.service.ticket.Ticket`.  Anything the service
        can never run raises :class:`AdmissionError`, after a ``reject``
        ProgressEvent."""
        reason = None
        try:
            spec = registry.get(request.family)
        except registry.UnknownProblemError as e:
            reason = str(e)
        else:
            n = spec.size(request.graph)
            if not spec.servable:
                reason = (f"problem family {request.family!r} is registered "
                          f"but not servable (no service packing in its "
                          f"@register_problem call)")
            elif n > self.spec.n:
                reason = (f"request n={n} exceeds service "
                          f"max_n={self.spec.n}")
            elif (request.rid in self.sched.tickets
                  or request.rid in self.slot_rid
                  or request.rid in self.results):
                reason = f"duplicate request id {request.rid}"
            elif (request.deadline_rounds is not None
                  and request.deadline_rounds < 1):
                reason = (f"deadline_rounds must be >= 1, got "
                          f"{request.deadline_rounds}")
            elif request.node_budget is not None and request.node_budget < 1:
                reason = f"node_budget must be >= 1, got {request.node_budget}"
        if reason is not None:
            self._emit("reject", rid=request.rid, reason=reason)
            if self._collector is not None:
                self._collector.lifecycle("reject", round_no=self.rounds,
                                          rid=request.rid, reason=reason)
            raise AdmissionError(reason)
        ticket = self.sched.enqueue(request, now_round=self.rounds,
                                    service=self)
        whole = spans.open_span("request", run=self._span_run,
                                rid=request.rid)
        self._request_spans[request.rid] = (whole, spans.open_span(
            "queued", run=self._span_run, rid=request.rid, parent=whole))
        return ticket

    def _end_request(self, rid: int) -> None:
        """Close request ``rid``'s spans: it reached a terminal state."""
        whole, queued = self._request_spans.pop(rid, (0, 0))
        spans.close_span(queued)
        spans.close_span(whole)

    def cancel(self, rid: int) -> bool:
        """Cancel request ``rid`` (the ``Ticket.cancel`` implementation).
        QUEUED: removed from the queue.  RUNNING: the slot is freed and its
        lanes reclaimed within one round, with the best-so-far recorded.
        Returns False for unknown or already-terminal rids."""
        ticket = self.sched.tickets.get(rid)
        if ticket is None or ticket.status in TERMINAL:
            return False
        best = None
        if ticket.status is TicketStatus.QUEUED:
            self.sched.remove_queued(rid)
        else:
            result = self._evict_slot(self.slot_rid.index(rid), "cancelled")
            best = result.optimum
        self.sched.resolve(rid, TicketStatus.CANCELLED, self.rounds)
        self._end_request(rid)
        self._emit("cancel", rid=rid, best=best)
        self._note_lifecycle("cancel", rid, best=best)
        return True

    def _emit(self, kind: str, **kw) -> None:
        from repro_torch.solver import emit
        emit(self.on_event, kind, round=self.rounds, **kw)

    def _note_lifecycle(self, kind: str, rid: int,
                        best: Optional[int] = None) -> None:
        """Trace a terminal request transition with its wait/run rounds."""
        if self._collector is None:
            return
        ticket = self.sched.tickets.get(rid)
        self._collector.lifecycle(
            kind, round_no=self.rounds, rid=rid, best=best,
            waited=ticket.wait_rounds if ticket is not None else None,
            ran=ticket.run_rounds if ticket is not None else None)

    def _host_lane_fields(self) -> Dict[str, np.ndarray]:
        return {f: _host(getattr(self.lanes, f)).copy() for f in _HOST_FIELDS}

    def _admit_and_place(self) -> bool:
        """Admit queued requests into free slots and (re)target idle lanes.
        Admission ORDER is the scheduling policy's.  Returns True when lane
        control state changed (stacks were replayed)."""
        # Steady state: nothing to drain or admit.  After a placement-
        # changing event one readback of ``active``/``inst`` checks that
        # every idle lane points at its round-robin live slot; with <= 1
        # live slot a passed check stays true until the next event.
        if not self.pool and not (len(self.sched)
                                  and any(r < 0 for r in self.slot_rid)):
            if self._placement_clean:
                return False             # no device readback at all
            live = [s for s in range(self.spec.k) if self.slot_rid[s] >= 0]
            active = _host(self.lanes.active)      # event-driven readback
            inst = _host(self.lanes.inst)          # event-driven readback
            idle = np.flatnonzero(~active)
            wants = [live[j % len(live)] if live else NO_INSTANCE
                     for j in range(len(idle))]
            if all(inst[lane] == want for lane, want in zip(idle, wants)):
                self._placement_clean = len(live) <= 1
                return False

        h = self._host_lane_fields()
        idle = [i for i in range(self.num_lanes) if not h["active"][i]]

        # Pending-pool drain first: restored tasks are already-owned
        # subtrees and take idle lanes before fresh roots.  Both are
        # placed in one ``place_tasks`` call after the admission loop.
        placed = min(len(self.pool), len(idle))
        lanes, tasks = idle[:placed], self.pool[:placed]
        del self.pool[:placed], idle[:placed]

        # Admission: one free slot + one idle lane per popped request.
        free = [s for s in range(self.spec.k) if self.slot_rid[s] < 0]
        payload_host = None
        while len(self.sched) and free and idle:
            item = self.sched.pop_admission()
            if item is None:
                break
            req = item.request
            slot = free.pop(0)
            lane = idle.pop(0)
            adj, fm, fam = registry.get(req.family).pack(req.graph,
                                                         self.spec.n)
            self.tables.adj[slot] = adj
            self.tables.fullm[slot] = fm
            self.tables.family[slot] = fam
            self._write_slot(slot)
            self.slot_rid[slot] = req.rid
            self.slot_admitted[slot] = self.rounds
            self._slot_best_seen[slot] = int(INF_VALUE)
            ticket = self.sched.tickets.get(req.rid)
            if ticket is not None:
                ticket.status = TicketStatus.RUNNING
                ticket.admitted_round = self.rounds
            spans.close_span(self._request_spans.get(req.rid, (0, 0))[1])
            # Reset the slot incumbent, seed the root on the chosen lane.
            h["best"][slot] = int(INF_VALUE)
            if payload_host is None:
                payload_host = tree_map(lambda p: _host(p).copy(),
                                        self.lanes.best_payload)
            payload_host = tree_map(lambda p: _zero_row(p, slot),
                                    payload_host)
            lanes.append(lane)
            tasks.append(ckpt.PendingTask(_NO_PATH, 0, 0, slot))
            self._emit("admit", rid=req.rid)
            if self._collector is not None:
                self._collector.lifecycle(
                    "admit", round_no=self.rounds, rid=req.rid, slot=slot,
                    waited=(ticket.wait_rounds if ticket is not None
                            else None))

        touched = ckpt.place_tasks(h, lanes, tasks)
        h["t_s"][touched] += 1

        # Retarget the remaining idle lanes round-robin over live slots so
        # the next steal round can feed them (instance-scoped thieves).
        live = [s for s in range(self.spec.k) if self.slot_rid[s] >= 0]
        retargeted = False
        for j, lane in enumerate(idle):
            want = live[j % len(live)] if live else NO_INSTANCE
            if h["inst"][lane] != want:
                h["inst"][lane] = want   # no stack impact: lane stays idle
                retargeted = True

        changed = bool(touched.any())
        if not changed and not retargeted:
            self._placement_clean = len(live) <= 1
            return False
        fields = {f: self._to_dev(h[f]) for f in _HOST_FIELDS}
        if payload_host is not None:
            fields["best_payload"] = tree_map(self._to_dev, payload_host)
        self._replace_lanes(**fields)
        if changed:
            # CONVERTINDEX replay rebuilds the stacks of the seeded and
            # installed lanes alone: replaying an untouched active lane
            # gives back its stack (the determinism contract), and a lane
            # seeded at its root needs no pass.
            self._rebuild_stacks(touched, h["depth"])
        self._placement_clean = len(live) <= 1
        return changed

    # -- retirement / eviction ----------------------------------------------

    def _result_payload(self, slot: int) -> np.ndarray:
        """Slot ``slot``'s incumbent bitset as the reference's uint32."""
        return _host(self.lanes.best_payload[slot]).copy().view(np.uint32)

    def _retire(self, open_vec: np.ndarray) -> None:
        h_inst = None
        for slot in range(self.spec.k):
            rid = self.slot_rid[slot]
            if rid < 0 or open_vec[slot] != 0:
                continue
            if any(t.inst == slot for t in self.pool):
                continue                      # restored work still pending
            self.results[rid] = RequestResult(
                rid=rid,
                optimum=int(self.lanes.best[slot]),
                payload=self._result_payload(slot),
                admitted_round=self.slot_admitted[slot],
                retired_round=self.rounds)
            self.sched.resolve(rid, TicketStatus.DONE, self.rounds)
            self._end_request(rid)
            self._emit("retire", rid=rid, best=self.results[rid].optimum)
            self._note_lifecycle("retire", rid,
                                 best=self.results[rid].optimum)
            self.slot_rid[slot] = -1
            # Unbind the retired slot's (now idle) lanes.
            if h_inst is None:
                h_inst = _host(self.lanes.inst).copy()  # event-driven
            h_inst[h_inst == slot] = NO_INSTANCE
        if h_inst is not None:
            self._replace_lanes(inst=self._to_dev(h_inst))
            self._placement_clean = False

    def _evict_slot(self, slot: int, status: str) -> RequestResult:
        """Free a slot mid-flight: record the best-so-far as an anytime
        result, deactivate and unbind its lanes (their subtrees go with the
        request) and drop its pending-pool tasks.  The slot is reusable by
        the very next admission."""
        rid = self.slot_rid[slot]
        result = RequestResult(
            rid=rid,
            optimum=int(self.lanes.best[slot]),
            payload=self._result_payload(slot),
            admitted_round=self.slot_admitted[slot],
            retired_round=self.rounds,
            status=status)
        self.results[rid] = result
        self.slot_rid[slot] = -1
        self._placement_clean = False
        inst = _host(self.lanes.inst).copy()        # event-driven readback
        active = _host(self.lanes.active).copy()    # event-driven readback
        mine = inst == slot
        active[mine] = False
        inst[mine] = NO_INSTANCE
        self._replace_lanes(inst=self._to_dev(inst),
                            active=self._to_dev(active))
        self.pool = [t for t in self.pool if t.inst != slot]
        return result

    def _expire(self) -> None:
        """End-of-round deadline/budget sweep (the scheduler decides WHO,
        this method does the surgery)."""
        queued, running = self.sched.overdue(self.rounds)
        for rid in queued:
            self.sched.remove_queued(rid)
            self.sched.resolve(rid, TicketStatus.EXPIRED, self.rounds)
            self._end_request(rid)
            # Never admitted: the anytime result is the empty incumbent.
            self.results[rid] = RequestResult(
                rid=rid, optimum=int(INF_VALUE),
                payload=np.zeros((self.spec.words,), np.uint32),
                admitted_round=-1, retired_round=self.rounds,
                status="expired")
            self._emit("expire", rid=rid)
            self._note_lifecycle("expire", rid)
        for rid in running:
            result = self._evict_slot(self.slot_rid.index(rid), "expired")
            self.sched.resolve(rid, TicketStatus.EXPIRED, self.rounds)
            self._end_request(rid)
            self._emit("expire", rid=rid, best=result.optimum)
            self._note_lifecycle("expire", rid, best=result.optimum)

    def _emit_incumbents(self) -> None:
        """One ``incumbent`` event each time a slot's bound improves; pays
        the device readback only when someone is listening."""
        if self.on_event is None:
            return
        best = _host(self.lanes.best)
        for slot in range(self.spec.k):
            rid = self.slot_rid[slot]
            if rid >= 0 and int(best[slot]) < self._slot_best_seen[slot]:
                self._slot_best_seen[slot] = int(best[slot])
                self._emit("incumbent", rid=rid, best=int(best[slot]))

    # -- the service loop ---------------------------------------------------

    def _has_work(self) -> bool:
        return (len(self.sched) > 0 or bool(self.pool)
                or any(r >= 0 for r in self.slot_rid))

    def step_round(self) -> np.ndarray:
        """One service cycle: admit -> round -> retire -> evict.  Returns
        the per-slot open-work vector."""
        with spans.span("round", run=self._span_run, round=self.rounds + 1):
            track = self.sched.track_nodes()
            col = self._collector
            with spans.span("admit"):
                changed = self._admit_and_place()
            nodes_before = None
            if col is not None:
                # Host-side surgery (admission seeds, pool installs) bumps
                # t_s: refresh the baseline so steal deltas cover the round
                # only.
                col.before_round(self.lanes, dirty=changed)
            elif track:
                nodes_before = _host(self.lanes.nodes).copy()
            # The round reads its open work back, the one per-round
            # readback (its ``readback`` span).
            self.lanes, open_vec = self._round(self.lanes)
            self.rounds += 1
            open_np = _host(open_vec)
            with spans.span("retire"):
                inst_delta = None
                if col is not None:
                    inst_delta = col.after_round(
                        self.rounds, self.lanes, int(open_np.sum()),
                        queue_depth=self.sched.queue_depth(),
                        slot_rids=self.slot_rid)
                if track:
                    # Round-granular attribution: a lane's node delta this
                    # round is charged to the instance it serves at the
                    # round boundary.  The collector computes exactly this
                    # delta; without one, read back.
                    if inst_delta is None:
                        delta = _host(self.lanes.nodes) - nodes_before
                        inst = _host(self.lanes.inst)
                        inst_delta = [int(delta[inst == slot].sum())
                                      for slot in range(self.spec.k)]
                    for slot in range(self.spec.k):
                        rid = self.slot_rid[slot]
                        if rid >= 0 and inst_delta[slot]:
                            self.sched.note_nodes(rid, int(inst_delta[slot]))
                self._emit("round", open_work=int(open_np.sum()),
                           metrics=(col.snapshot()
                                    if col is not None and self.metrics_enabled
                                    and self.on_event is not None else None))
                self._emit_incumbents()
                self._retire(open_np)
                self._expire()
                self.maybe_autoscale()
            return open_np

    def drain(self, max_rounds: int = 100000) -> Dict[int, RequestResult]:
        """Step rounds until every submitted request is terminal."""
        start = self.rounds
        while self._has_work():
            if self.rounds - start >= max_rounds:
                raise RuntimeError(
                    f"service did not drain in {max_rounds} rounds; "
                    f"slots={self.slot_rid} queue={len(self.queue)}")
            self.step_round()
        self.finalize_trace()
        return self.results

    def run(self, requests: Optional[List[SolveRequest]] = None,
            max_rounds: int = 100000) -> Dict[int, RequestResult]:
        """Deprecated batch-era drain (the reference's shim): submit
        ``requests``, then :meth:`drain`."""
        warnings.warn(
            "SolverService.run() is deprecated; submit() returns a Ticket "
            "— use Ticket.result(), or SolverService.drain()",
            DeprecationWarning, stacklevel=2)
        for r in requests or []:
            self.submit(r)
        return self.drain(max_rounds)

    # -- elastic mesh membership --------------------------------------------

    def resize(self, *, mesh: Optional[Mesh] = None,
               num_lanes: Optional[int] = None) -> None:
        """Re-lay the live pool onto another mesh and/or per-shard lane
        count between rounds (the join-leave half of paper §VII, in
        memory).

        Goes through ``checkpoint.repartition``: the first W' in-flight
        tasks land on the new lanes, the surplus parks in the
        instance-tagged pending pool, per-instance incumbents and the
        aggregate counters carry over exactly.  Tickets, results, queue
        and tables stay live in place.  The tables, problems and round are
        rebuilt for the new mesh.
        """
        per_dev = (self.lanes_per_device if num_lanes is None
                   else int(num_lanes))
        n_dev = mesh.size if mesh is not None else 1
        total = per_dev * n_dev
        if total < 1:
            raise ValueError(f"resize to {total} lanes")
        old_dev, old_total = self.n_devices, self.num_lanes
        lanes = _gather_lanes(self.lanes)
        old_mesh = self.mesh
        self.mesh = mesh
        try:
            self._build_round_fns()
        except ValueError:
            self.mesh = old_mesh
            raise
        new_lanes, surplus = ckpt.repartition(self.problem, lanes, total)
        self.n_devices = n_dev
        self.lanes_per_device = per_dev
        self.num_lanes = total
        self._set_lanes(new_lanes)
        self.pool.extend(surplus)
        self._placement_clean = False
        if self._collector is not None:
            self._collector.resize(total, devices=n_dev,
                                   round_no=self.rounds)
        self._emit("resize", reason=f"devices {old_dev}->{n_dev}, "
                                    f"lanes {old_total}->{total}")

    def maybe_autoscale(self) -> bool:
        """Ask the :class:`AutoscalePolicy` (when configured) whether to
        change the shard count, and :meth:`resize` if so.  Runs once per
        round from :meth:`step_round`.  The shards come from
        ``distributed.available_devices``: on ``cuda`` the cards present
        (one card never grows), on ``cpu`` up to the policy's
        ``max_devices`` shards."""
        if self.autoscale is None:
            return False
        target = self.autoscale.decide(
            queue_depth=self.sched.queue_depth(), devices=self.n_devices,
            now_round=self.rounds,
            busy=any(r >= 0 for r in self.slot_rid) or bool(self.pool))
        if target is None or target == self.n_devices:
            return False
        devices = available_devices(self.device.type,
                                    self.autoscale.max_devices)
        if target > len(devices):
            return False
        self.resize(mesh=Mesh(devices[:target]) if target > 1 else None)
        return True

    # -- elastic checkpoint -------------------------------------------------

    def save(self, path: str) -> None:
        """Persist lanes + slot tables + pending pool + the queued-request
        heap + ticket states in one atomic file, in the reference's format
        (bitset arrays as uint32), so either package can restore it."""
        pool_n = len(self.pool)
        il = self.lanes.idx.shape[1]
        pool_idx = np.full((pool_n, il), int(UNVISITED), np.int8)
        pool_meta = np.zeros((pool_n, 3), np.int32)     # depth, base, inst
        for i, t in enumerate(self.pool):
            width = min(il, t.idx.shape[0])
            pool_idx[i, :width] = t.idx[:width]
            pool_meta[i] = (t.depth, t.base, t.inst)

        pending = self.sched.pending()
        queue_adj = np.zeros((len(pending), self.spec.n,
                              num_words(self.spec.n)), np.uint32)
        queue_meta = []
        for i, item in enumerate(pending):
            g = item.request.graph
            queue_adj[i, :g.n, :g.words] = g.adj
            queue_meta.append({
                "rid": item.request.rid, "family": item.request.family,
                "name": g.name, "n": g.n, "seq": item.seq,
                "priority": item.request.priority,
                "deadline_rounds": item.request.deadline_rounds,
                "node_budget": item.request.node_budget,
            })
        done = sorted(self.results.values(), key=lambda r: r.rid)
        result_payload = (np.stack([np.asarray(r.payload, np.uint32)
                                    for r in done])
                          if done else np.zeros((0,), np.uint32))
        sched_meta = {
            "scheduler": self.sched.policy.name,
            "seq": self.sched.seq,
            "queue": queue_meta,
            "tickets": [{
                "rid": t.rid, "status": t.status.value,
                "priority": t.priority, "deadline_round": t.deadline_round,
                "node_budget": t.node_budget,
                "submitted_round": t.submitted_round,
                "admitted_round": t.admitted_round,
                "finished_round": t.finished_round,
                "nodes_used": t.nodes_used,
            } for t in self.sched.tickets.values()],
            "results": [{
                "rid": r.rid, "optimum": r.optimum,
                "admitted_round": r.admitted_round,
                "retired_round": r.retired_round, "status": r.status,
            } for r in done],
        }
        extra = {
            "adj": self.tables.adj, "fullm": self.tables.fullm,
            "family": self.tables.family,
            "slot_rid": np.asarray(self.slot_rid, np.int32),
            "slot_admitted": np.asarray(self.slot_admitted, np.int32),
            "spec": np.asarray([self.spec.n, self.spec.k], np.int32),
            "rounds": np.asarray(self.rounds, np.int32),
            "slot_best_seen": np.asarray(self._slot_best_seen, np.int32),
            "pool_idx": pool_idx, "pool_meta": pool_meta,
            "queue_adj": queue_adj,
            "result_payload": result_payload,
            "sched_meta": ckpt.pack_json(sched_meta),
        }
        ckpt.save(path, self.lanes, extra=extra)

    @classmethod
    def restore(cls, path: str, *, num_lanes: int,
                steps_per_round: int = 64, device: str = "cuda",
                scheduler: Optional[Union[str, SchedulingPolicy]] = None,
                fused_steps: int = 1, mesh: Optional[Mesh] = None,
                max_ship: int = 16, trace_path: Optional[str] = None,
                metrics: bool = False,
                on_event: Optional[Callable[[Any], None]] = None
                ) -> "SolverService":
        """Rebuild the service onto ``num_lanes`` lanes per shard (elastic
        W' != W) on ``device``, sharded over ``mesh`` when given (the
        mesh, like the lane count, is an execution choice: a service saved
        on one shard count restores on any other).  Surplus in-flight tasks
        wait in the pending pool; queued requests are restored with their
        admission sequence, so the queue pops in the saved order; every
        ticket's state round-trips.
        ``scheduler`` defaults to the checkpointed policy.  With
        ``trace_path`` / ``metrics`` the restored service is traced, its
        deltas counted from the restored lanes."""
        extra = ckpt.read_extra(path)
        n, k = (int(x) for x in extra["spec"])
        meta = (ckpt.unpack_json(extra["sched_meta"])
                if "sched_meta" in extra else
                {"scheduler": "priority", "seq": 0, "queue": [],
                 "tickets": [], "results": []})
        svc = cls._create(max_n=n, slots=k, num_lanes=num_lanes,
                          steps_per_round=steps_per_round, device=device,
                          scheduler=(meta["scheduler"] if scheduler is None
                                     else scheduler),
                          fused_steps=fused_steps, mesh=mesh,
                          max_ship=max_ship, trace_path=trace_path,
                          metrics=metrics, on_event=on_event)
        svc.tables = StackedTables(
            adj=extra["adj"].astype(np.uint32),
            fullm=extra["fullm"].astype(np.uint32),
            family=extra["family"].astype(np.int32))
        svc._write_tables()
        lanes, svc.pool = ckpt.restore(path, svc.problem, svc.num_lanes)
        svc._set_lanes(lanes)
        for i in range(extra["pool_idx"].shape[0]):
            d, b, inst = (int(x) for x in extra["pool_meta"][i])
            svc.pool.append(ckpt.PendingTask(extra["pool_idx"][i].copy(),
                                             d, b, inst))
        svc.slot_rid = [int(r) for r in extra["slot_rid"]]
        svc.slot_admitted = [int(r) for r in extra["slot_admitted"]]
        svc.rounds = int(extra["rounds"])
        if svc._collector is not None:
            # Re-baseline on the restored lanes so the first round's deltas
            # exclude the carried checkpoint totals.
            svc._collector.start(svc.lanes)
        if "slot_best_seen" in extra:     # keep the incumbent stream exact
            svc._slot_best_seen = [int(b) for b in extra["slot_best_seen"]]

        for t in meta["tickets"]:
            svc.sched.adopt(Ticket(
                rid=t["rid"], priority=t["priority"],
                deadline_round=t["deadline_round"],
                node_budget=t["node_budget"],
                status=TicketStatus(t["status"]),
                submitted_round=t["submitted_round"],
                admitted_round=t["admitted_round"],
                finished_round=t["finished_round"],
                nodes_used=t["nodes_used"], _service=svc))
        for i, q in enumerate(meta["queue"]):
            graph = Graph(n=q["n"],
                          adj=extra["queue_adj"][i, :q["n"],
                                                 :num_words(q["n"])].copy(),
                          name=q["name"])
            svc.sched.policy.push(QueueItem(q["seq"], SolveRequest(
                rid=q["rid"], graph=graph, family=q["family"],
                priority=q["priority"],
                deadline_rounds=q["deadline_rounds"],
                node_budget=q["node_budget"])))
        svc.sched.seq = int(meta["seq"])
        for i, r in enumerate(meta["results"]):
            svc.results[r["rid"]] = RequestResult(
                rid=r["rid"], optimum=r["optimum"],
                payload=extra["result_payload"][i].copy(),
                admitted_round=r["admitted_round"],
                retired_round=r["retired_round"], status=r["status"])
        return svc


def _zero_row(arr: np.ndarray, row: int) -> np.ndarray:
    arr[row] = np.zeros_like(arr[row])
    return arr

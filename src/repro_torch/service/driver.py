"""Continuous-batching solver service over one lane pool, on one device
(counterpart of ``repro.service.driver`` without its mesh path).

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

Not ported yet: the mesh path (``mesh``, ``resize``, ``maybe_autoscale``)
and telemetry (``trace_path``, ``metrics``).
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
from repro_torch.core.distributed import make_round
from repro_torch.core.engine import NO_INSTANCE, init_lanes
from repro_torch.problems.graphs import Graph, num_words
from repro_torch.service.batch_problem import StackedSpec, StackedTables
from repro_torch.service.scheduler import (QueueItem, Scheduler,
                                           SchedulingPolicy, make_policy)
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
        scheduler / fused_steps come from a
        :class:`repro_torch.solver.SolverConfig`."""
        return cls._create(max_n=max_n, slots=slots, num_lanes=config.lanes,
                           steps_per_round=config.steps_per_round,
                           device=config.device, scheduler=config.scheduler,
                           fused_steps=config.fused_steps, on_event=on_event)

    @classmethod
    def _create(cls, **kwargs) -> "SolverService":
        svc = object.__new__(cls)
        svc._init(**kwargs)
        return svc

    def _init(self, *, max_n: int, slots: int, num_lanes: int,
              steps_per_round: int = 64, device: str = "cuda",
              scheduler: Union[str, SchedulingPolicy] = "priority",
              fused_steps: int = 1,
              on_event: Optional[Callable[[Any], None]] = None):
        self.spec = StackedSpec(n=max_n, k=slots)
        self.device = resolve_device(device)
        self.steps_per_round = steps_per_round
        self.fused_steps = fused_steps
        self.on_event = on_event
        self.num_lanes = num_lanes
        self.tables = self.spec.empty_tables()            # host numpy
        # Preallocated once and written in place at admission: the bound
        # problem and the round below close over these very tensors.
        self._tables_dev = stacked_tables(self.tables, self.device)
        self.problem = self.spec.bind(self._tables_dev, self.device)
        self._round = make_round(self.problem, steps_per_round,
                                 fused_steps=fused_steps)
        self.lanes = init_lanes(self.problem, num_lanes, seed_root=False,
                                bind_instance=False)

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

    # -- host/device plumbing ----------------------------------------------

    def _write_slot(self, slot: int) -> None:
        """Copy host slot ``slot`` into the device tables, in place."""
        dev = self._tables_dev
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
        return torch.from_numpy(arr).to(self.device)

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
            raise AdmissionError(reason)
        return self.sched.enqueue(request, now_round=self.rounds,
                                  service=self)

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
        self._emit("cancel", rid=rid, best=best)
        return True

    def _emit(self, kind: str, **kw) -> None:
        from repro_torch.solver import emit
        emit(self.on_event, kind, round=self.rounds, **kw)

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
        changed = False

        # Pending-pool drain first: restored tasks are already-owned
        # subtrees and take idle lanes before fresh roots.
        while self.pool and idle:
            task = self.pool.pop(0)
            lane = idle.pop(0)
            il = h["idx"].shape[1]
            width = min(il, task.idx.shape[0])
            h["idx"][lane, :] = int(UNVISITED)
            h["idx"][lane, :width] = task.idx[:width]
            h["depth"][lane], h["base"][lane] = task.depth, task.base
            h["inst"][lane], h["active"][lane] = task.inst, True
            h["t_s"][lane] += 1
            changed = True

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
            # Reset the slot incumbent, seed the root on the chosen lane.
            h["best"][slot] = int(INF_VALUE)
            if payload_host is None:
                payload_host = tree_map(lambda p: _host(p).copy(),
                                        self.lanes.best_payload)
            payload_host = tree_map(lambda p: _zero_row(p, slot),
                                    payload_host)
            h["idx"][lane, :] = int(UNVISITED)
            h["depth"][lane] = h["base"][lane] = 0
            h["inst"][lane], h["active"][lane] = slot, True
            h["t_s"][lane] += 1
            changed = True
            self._emit("admit", rid=req.rid)

        # Retarget the remaining idle lanes round-robin over live slots so
        # the next steal round can feed them (instance-scoped thieves).
        live = [s for s in range(self.spec.k) if self.slot_rid[s] >= 0]
        retargeted = False
        for j, lane in enumerate(idle):
            want = live[j % len(live)] if live else NO_INSTANCE
            if h["inst"][lane] != want:
                h["inst"][lane] = want   # no stack impact: lane stays idle
                retargeted = True

        if not changed and not retargeted:
            self._placement_clean = len(live) <= 1
            return False
        self.lanes = self.lanes._replace(
            **{f: self._to_dev(h[f]) for f in _HOST_FIELDS},
            best_payload=(self.lanes.best_payload if payload_host is None
                          else tree_map(self._to_dev, payload_host)))
        if changed:
            # CONVERTINDEX replay rebuilds the stacks of seeded/installed
            # lanes (replaying untouched active lanes is a no-op by the
            # determinism contract).
            self.lanes = ckpt.rebuild_stacks(self.problem, self.lanes)
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
            self._emit("retire", rid=rid, best=self.results[rid].optimum)
            self.slot_rid[slot] = -1
            # Unbind the retired slot's (now idle) lanes.
            if h_inst is None:
                h_inst = _host(self.lanes.inst).copy()  # event-driven
            h_inst[h_inst == slot] = NO_INSTANCE
        if h_inst is not None:
            self.lanes = self.lanes._replace(inst=self._to_dev(h_inst))
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
        self.lanes = self.lanes._replace(inst=self._to_dev(inst),
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
            # Never admitted: the anytime result is the empty incumbent.
            self.results[rid] = RequestResult(
                rid=rid, optimum=int(INF_VALUE),
                payload=np.zeros((self.spec.words,), np.uint32),
                admitted_round=-1, retired_round=self.rounds,
                status="expired")
            self._emit("expire", rid=rid)
        for rid in running:
            result = self._evict_slot(self.slot_rid.index(rid), "expired")
            self.sched.resolve(rid, TicketStatus.EXPIRED, self.rounds)
            self._emit("expire", rid=rid, best=result.optimum)

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
        track = self.sched.track_nodes()
        self._admit_and_place()
        nodes_before = _host(self.lanes.nodes).copy() if track else None
        self.lanes, open_vec = self._round(self.lanes)
        self.rounds += 1
        open_np = _host(open_vec)        # the one per-round readback
        if track:
            # Round-granular attribution: a lane's node delta this round is
            # charged to the instance it serves at the round boundary.
            delta = _host(self.lanes.nodes) - nodes_before
            inst = _host(self.lanes.inst)
            for slot in range(self.spec.k):
                rid = self.slot_rid[slot]
                used = int(delta[inst == slot].sum())
                if rid >= 0 and used:
                    self.sched.note_nodes(rid, used)
        self._emit("round", open_work=int(open_np.sum()))
        self._emit_incumbents()
        self._retire(open_np)
        self._expire()
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
                fused_steps: int = 1,
                on_event: Optional[Callable[[Any], None]] = None
                ) -> "SolverService":
        """Rebuild the service onto ``num_lanes`` lanes (elastic W' != W)
        on ``device``.  Surplus in-flight tasks wait in the pending pool;
        queued requests are restored with their admission sequence, so the
        queue pops in the saved order; every ticket's state round-trips.
        ``scheduler`` defaults to the checkpointed policy."""
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
                          fused_steps=fused_steps, on_event=on_event)
        svc.tables = StackedTables(
            adj=extra["adj"].astype(np.uint32),
            fullm=extra["fullm"].astype(np.uint32),
            family=extra["family"].astype(np.int32))
        svc._write_tables()
        svc.lanes, svc.pool = ckpt.restore(path, svc.problem, svc.num_lanes)
        for i in range(extra["pool_idx"].shape[0]):
            d, b, inst = (int(x) for x in extra["pool_meta"][i])
            svc.pool.append(ckpt.PendingTask(extra["pool_idx"][i].copy(),
                                             d, b, inst))
        svc.slot_rid = [int(r) for r in extra["slot_rid"]]
        svc.slot_admitted = [int(r) for r in extra["slot_admitted"]]
        svc.rounds = int(extra["rounds"])
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

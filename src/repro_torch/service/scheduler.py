"""Pluggable admission scheduling for the solver service (counterpart of
``repro.service.scheduler``, host-only; DESIGN.md §7).

The semi-centralized strategy of Pastrana-Cruz et al. (2023) — a light
central scheduler over branching workers — maps onto our service cleanly:
the driver (:mod:`repro_torch.service.driver`) stays a pure round-stepping
engine over lanes and slots, and ALL policy lives here:

* :class:`SchedulingPolicy` — the pluggable queue contract.  A policy is a
  priority queue of :class:`QueueItem`\\ s; the driver pops one per free
  slot per round and never looks at priorities, sizes or deadlines itself.
  Implementations: :class:`PriorityFifo` (default — higher ``priority``
  admits first, ties FIFO), :class:`ShortestJobFirst` (smallest registered
  ``size()`` first — the registry feeds the key) and :class:`Fifo`
  (pure arrival order, the pre-ticket behavior and the benchmark
  baseline).  ``SCHEDULERS`` / :func:`make_policy` resolve config names;
  any object satisfying the protocol can be passed to the driver directly,
  so new policies never touch the engine.

* :class:`Scheduler` — the bookkeeping layer over one policy instance:
  owns the ticket table, the admission sequence counter, and the
  deadline / node-budget eviction decisions (mts-style per-subtree
  budgets, Avis & Jordan 2017).  The driver asks ``overdue(round)`` each
  round and performs the lane/slot surgery; the scheduler never touches
  device state.
"""

from __future__ import annotations

import heapq
from typing import Dict, List, NamedTuple, Optional, Protocol, Tuple

from repro_torch import registry
from repro_torch.service.ticket import (TERMINAL, SolveRequest, Ticket,
                                        TicketStatus)

__all__ = [
    "Fifo",
    "PriorityFifo",
    "QueueItem",
    "SCHEDULERS",
    "Scheduler",
    "SchedulingPolicy",
    "ShortestJobFirst",
    "make_policy",
]


class QueueItem(NamedTuple):
    """One queued request: ``seq`` is the admission sequence number (the
    FIFO tie-breaker, preserved across checkpoints so restored queues pop
    in the same order)."""

    seq: int
    request: SolveRequest


class SchedulingPolicy(Protocol):
    """The admission-queue contract the driver consumes.

    ``pop()`` returns the next request to admit (None when empty);
    ``remove(rid)`` drops a queued request (cancellation / queue expiry);
    ``pending()`` is a non-destructive snapshot in pop order (checkpoints,
    introspection).  The driver never inspects requests' policy fields —
    subclass :class:`_HeapPolicy` with a ``key`` to add a policy without
    touching the engine.
    """

    name: str

    def push(self, item: QueueItem) -> None: ...

    def pop(self) -> Optional[QueueItem]: ...

    def remove(self, rid: int) -> bool: ...

    def pending(self) -> Tuple[QueueItem, ...]: ...

    def __len__(self) -> int: ...


class _HeapPolicy:
    """Heap-ordered policy base: orders by ``key(request) + (seq,)`` —
    subclasses supply the key, ties always break FIFO.  Removal is lazy
    (dead entries stay in the heap until popped over) with a live-rid set,
    so cancellation of a queued request is O(1)."""

    name = "heap"

    def __init__(self):
        self._heap: List[Tuple[tuple, QueueItem]] = []
        self._live: set = set()       # rids queued and not removed

    def key(self, request: SolveRequest) -> tuple:
        return ()

    def push(self, item: QueueItem) -> None:
        heapq.heappush(self._heap,
                       (self.key(item.request) + (item.seq,), item))
        self._live.add(item.request.rid)

    def pop(self) -> Optional[QueueItem]:
        while self._heap:
            _, item = heapq.heappop(self._heap)
            if item.request.rid in self._live:
                self._live.discard(item.request.rid)
                return item
        return None

    def remove(self, rid: int) -> bool:
        if rid in self._live:
            self._live.discard(rid)
            # Compact once dead entries dominate, so cancelled requests'
            # QueueItems (and their instance arrays) don't accumulate under
            # a policy that never pops them.
            if len(self._heap) > 8 and len(self._live) < len(self._heap) // 2:
                self._heap = [e for e in self._heap
                              if e[1].request.rid in self._live]
                heapq.heapify(self._heap)
            return True
        return False

    def pending(self) -> Tuple[QueueItem, ...]:
        return tuple(item for _, item in sorted(self._heap)
                     if item.request.rid in self._live)

    def __len__(self) -> int:
        return len(self._live)


class Fifo(_HeapPolicy):
    """Pure arrival order — the pre-ticket ``deque`` behavior, kept as the
    explicit baseline of the reference's service latency benchmark."""

    name = "fifo"


class PriorityFifo(_HeapPolicy):
    """Higher ``SolveRequest.priority`` admits first; equal priorities are
    FIFO — which makes the default policy bitwise-identical to the legacy
    queue when every request carries the default priority."""

    name = "priority"

    def key(self, request: SolveRequest) -> tuple:
        return (-int(request.priority),)


class ShortestJobFirst(_HeapPolicy):
    """Smallest instance first, keyed on the family's registered ``size()``
    (``repro_torch.registry.instance_size``); ties FIFO.  The classic tail-latency
    heuristic when sizes predict work."""

    name = "sjf"

    def key(self, request: SolveRequest) -> tuple:
        return (registry.instance_size(request.family, request.graph),)


#: Config-name -> policy class (the ``SolverConfig.scheduler`` values).
SCHEDULERS: Dict[str, type] = {
    "fifo": Fifo,
    "priority": PriorityFifo,
    "sjf": ShortestJobFirst,
}


def make_policy(name: str) -> SchedulingPolicy:
    """Instantiate a registered policy by config name."""
    try:
        return SCHEDULERS[name]()
    except KeyError:
        raise ValueError(
            f"unknown scheduling policy {name!r} (known: "
            f"{', '.join(sorted(SCHEDULERS))})") from None


class Scheduler:
    """Ticket table + one policy instance + eviction decisions.

    The driver delegates every "which request, when" question here and
    keeps the "how" (table writes, lane seeding, eviction surgery) to
    itself.  All state is host-side and checkpointable
    (``driver.SolverService.save`` persists the pending items, ticket
    states and ``seq`` counter so a restored queue pops identically).
    """

    def __init__(self, policy: SchedulingPolicy):
        self.policy = policy
        self.tickets: Dict[int, Ticket] = {}
        self.seq = 0                      # admission sequence counter
        # Live rids carrying a deadline or node budget: the per-round
        # eviction sweep and the node-readback decision scan ONLY this set,
        # not every ticket the service ever issued.
        self._limited: set = set()

    def __len__(self) -> int:
        return len(self.policy)

    def queue_depth(self) -> int:
        """Number of requests waiting for admission (telemetry gauge)."""
        return len(self.policy)

    def adopt(self, ticket: Ticket) -> None:
        """Index an externally built ticket (checkpoint restore)."""
        self.tickets[ticket.rid] = ticket
        if ticket.status not in TERMINAL and (
                ticket.deadline_round is not None
                or ticket.node_budget is not None):
            self._limited.add(ticket.rid)

    def resolve(self, rid: int, status: TicketStatus,
                now_round: int) -> None:
        """Move a ticket to a terminal state (rids without tickets — legacy
        checkpoints — are a no-op)."""
        ticket = self.tickets.get(rid)
        if ticket is not None:
            ticket.status = status
            ticket.finished_round = now_round
        self._limited.discard(rid)

    def enqueue(self, request: SolveRequest, *, now_round: int,
                service) -> Ticket:
        """Create the QUEUED ticket and push the request onto the policy.
        Validation (registry, sizes, duplicate rids) is the driver's job —
        it owns the ``reject`` event stream."""
        deadline_round = (None if request.deadline_rounds is None
                          else now_round + int(request.deadline_rounds))
        ticket = Ticket(
            rid=request.rid, priority=int(request.priority),
            deadline_round=deadline_round,
            node_budget=request.node_budget,
            submitted_round=now_round, _service=service)
        self.adopt(ticket)
        self.policy.push(QueueItem(self.seq, request))
        self.seq += 1
        return ticket

    def pop_admission(self) -> Optional[QueueItem]:
        return self.policy.pop()

    def remove_queued(self, rid: int) -> bool:
        return self.policy.remove(rid)

    def pending(self) -> Tuple[QueueItem, ...]:
        return self.policy.pending()

    # -- eviction policy ----------------------------------------------------

    def note_nodes(self, rid: int, delta: int) -> None:
        ticket = self.tickets.get(rid)
        if ticket is not None:
            ticket.nodes_used += int(delta)

    def track_nodes(self) -> bool:
        """True while any live ticket carries a node budget — the driver
        only pays the per-round node readback when this is set.  QUEUED
        tickets count too: admission happens inside the same round that
        would otherwise skip the pre-round snapshot."""
        return any(self.tickets[rid].node_budget is not None
                   for rid in self._limited)

    def overdue(self, now_round: int) -> Tuple[List[int], List[int]]:
        """(queued rids past their deadline, running rids past deadline or
        node budget) at the end of round ``now_round``.  O(live limited
        tickets), not O(all tickets ever issued)."""
        queued, running = [], []
        for rid in sorted(self._limited):
            ticket = self.tickets[rid]
            late = (ticket.deadline_round is not None
                    and now_round >= ticket.deadline_round)
            if ticket.status is TicketStatus.QUEUED:
                if late:
                    queued.append(rid)
            elif late or (ticket.node_budget is not None
                          and ticket.nodes_used >= ticket.node_budget):
                running.append(rid)
        return queued, running

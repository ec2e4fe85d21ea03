"""Request-lifecycle types for the solver service (counterpart of
``repro.service.ticket``; DESIGN.md §7).

A host-only copy of the reference's types:

* :class:`SolveRequest` — one tenant's instance, now carrying ``priority``
  (admission order under :class:`~repro_torch.service.scheduler.PriorityFifo`),
  ``deadline_rounds`` (service rounds after submission before the request
  is expired) and ``node_budget`` (search nodes before eviction);
* :class:`Ticket` — the future-like handle ``submit()`` returns: status
  machine QUEUED → RUNNING → DONE | CANCELLED | EXPIRED, blocking
  ``result(timeout=)`` that drives the owning service's rounds, and
  ``cancel()`` which frees the slot and reclaims its lanes within one
  round;
* :class:`RequestResult` — the per-request outcome, extended with a
  ``status`` field so evicted requests keep their best-so-far as an
  *anytime* result instead of vanishing;
* the typed errors: :class:`AdmissionError` (request the service can never
  run, raised at ``submit()`` after a ``reject`` ProgressEvent) and
  :class:`TicketCancelled` (raised by ``result()`` on a cancelled ticket).

Everything here is host-side bookkeeping: no tensors, no engine state.
The policy deciding WHICH queued request is admitted next lives in
:mod:`repro_torch.service.scheduler`; the lane/slot mechanics stay in
:mod:`repro_torch.service.driver`.
"""

from __future__ import annotations

import dataclasses
import enum
import time
import warnings
from typing import Any, Optional

import numpy as np

from repro_torch.problems.graphs import Graph

__all__ = [
    "AdmissionError",
    "RequestResult",
    "SolveRequest",
    "Ticket",
    "TicketCancelled",
    "TicketStatus",
]


class AdmissionError(ValueError):
    """A request the service can never run: unregistered family, family
    without service packing, instance larger than the deployment's
    ``max_n``, a duplicate rid, or nonsensical lifecycle fields.  Raised at
    ``submit()`` time — never deep inside packing — after a ``reject``
    :class:`~repro_torch.solver.ProgressEvent` has been emitted."""


class TicketCancelled(RuntimeError):
    """``Ticket.result()`` on a cancelled request.  The best-so-far anytime
    snapshot (if the request ever ran) stays available under
    ``SolverService.results[rid]`` with ``status == "cancelled"``."""


class TicketStatus(enum.Enum):
    """The request lifecycle.  QUEUED and RUNNING are live; DONE, CANCELLED
    and EXPIRED are terminal (EXPIRED = deadline or node-budget eviction,
    with the best-so-far recorded as an anytime result)."""

    QUEUED = "queued"
    RUNNING = "running"
    DONE = "done"
    CANCELLED = "cancelled"
    EXPIRED = "expired"


#: Terminal states: a ticket in one of these never changes again.
TERMINAL = frozenset(
    {TicketStatus.DONE, TicketStatus.CANCELLED, TicketStatus.EXPIRED})


@dataclasses.dataclass
class SolveRequest:
    """One tenant's instance plus its lifecycle contract.

    ``family`` is any *servable* registered problem family
    (``repro_torch.registry.get(family).servable``).  ``priority`` orders
    admission under the default scheduler (higher admits first, ties FIFO);
    ``deadline_rounds`` (>= 1) expires the request that many service rounds
    after submission; ``node_budget`` (>= 1) evicts it once its slot has
    explored that many search nodes.  Both evictions record the best
    incumbent so far as an anytime result.
    """

    rid: int
    graph: Graph
    family: str
    priority: int = 0
    deadline_rounds: Optional[int] = None
    node_budget: Optional[int] = None


@dataclasses.dataclass
class RequestResult:
    """Outcome of one request.  ``status`` is "done" for a drained search,
    "expired" / "cancelled" for an eviction — then ``optimum`` is the
    anytime incumbent at eviction time (``INF_VALUE`` when no solution had
    been found yet) and ``payload`` its solution bitset."""

    rid: int
    optimum: int
    payload: np.ndarray        # uint32[w] solution bitset (padded width)
    admitted_round: int        # -1 when the request expired while queued
    retired_round: int
    status: str = "done"       # "done" | "expired" | "cancelled"


@dataclasses.dataclass(eq=False)
class Ticket:
    """Future-like handle for one submitted request.

    Returned by ``SolverService.submit``; holds the request's lifecycle
    state (the service mutates it as rounds advance) and drives the service
    on demand: ``result()`` steps rounds until this ticket is terminal.
    ``deadline_round`` is the ABSOLUTE service round at which the request
    expires (submission round + ``deadline_rounds``).
    """

    rid: int
    priority: int = 0
    deadline_round: Optional[int] = None
    node_budget: Optional[int] = None
    status: TicketStatus = TicketStatus.QUEUED
    submitted_round: int = 0
    admitted_round: Optional[int] = None
    finished_round: Optional[int] = None
    nodes_used: int = 0        # round-granular (see driver node accounting)
    _service: Any = dataclasses.field(default=None, repr=False)

    def done(self) -> bool:
        """True once the ticket is terminal (DONE, CANCELLED or EXPIRED)."""
        return self.status in TERMINAL

    @property
    def wait_rounds(self) -> Optional[int]:
        """Rounds spent QUEUED before admission.

        For a ticket that left the queue without ever running (queue-expired
        or cancelled while queued) this is the full submitted→finished span.
        None while the ticket is still queued.
        """
        if self.admitted_round is not None:
            return self.admitted_round - self.submitted_round
        if self.finished_round is not None:
            return self.finished_round - self.submitted_round
        return None

    @property
    def run_rounds(self) -> Optional[int]:
        """Rounds spent RUNNING (admission → terminal); None until both
        endpoints are known (never-admitted tickets stay None)."""
        if self.admitted_round is None or self.finished_round is None:
            return None
        return self.finished_round - self.admitted_round

    def result(self, timeout: Optional[float] = None) -> RequestResult:
        """Drive the owning service until this ticket resolves.

        Steps service rounds (admitting / retiring every other tenant as a
        side effect — the service is cooperatively scheduled) until this
        ticket is terminal.  Raises ``TimeoutError`` after ``timeout``
        wall-clock seconds, :class:`TicketCancelled` if the ticket was
        cancelled; an EXPIRED ticket *returns* its anytime
        :class:`RequestResult` (``status == "expired"``).
        """
        deadline = None if timeout is None else time.monotonic() + timeout
        while self.status not in TERMINAL:
            if self._service is None:
                raise RuntimeError(
                    f"ticket {self.rid} is not bound to a service")
            if deadline is not None and time.monotonic() >= deadline:
                raise TimeoutError(
                    f"ticket {self.rid} unresolved after {timeout}s "
                    f"(status={self.status.value})")
            self._service.step_round()
        if self.status is TicketStatus.CANCELLED:
            raise TicketCancelled(f"request {self.rid} was cancelled")
        return self._service.results[self.rid]

    def cancel(self) -> bool:
        """Cancel the request; True if this call cancelled it.

        A QUEUED ticket is removed from the admission queue; a RUNNING one
        has its slot freed and its lanes reclaimed immediately (within one
        round — the driver's eviction path), with the best-so-far recorded
        as an anytime result.  Terminal tickets return False.
        """
        if self.status in TERMINAL or self._service is None:
            return False
        return self._service.cancel(self.rid)

    def __int__(self) -> int:
        # The pre-ticket submit() returned a bare int rid; treating the
        # ticket AS that int is the legacy surface.
        warnings.warn(
            "treating a Ticket as its int rid is deprecated; use "
            "ticket.rid / ticket.result()", DeprecationWarning, stacklevel=2)
        return self.rid

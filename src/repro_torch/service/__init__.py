"""Multi-tenant solver service of the port (counterpart of
``repro.service``, single device): continuous batching of many instances.

``batch_problem`` stacks K padded instances (vertex cover and/or
dominating set) into one ``BinaryProblem`` whose per-lane state carries an
instance id, evaluated with one ``stacked_count_stats`` launch per engine
step; ``driver`` streams requests through a fixed pool of W lanes with
admission, instance-scoped stealing, per-instance retirement/eviction and
elastic checkpoints; ``scheduler`` decides admission order and deadline /
node-budget evictions; ``ticket`` holds the request-lifecycle types.
"""

from repro_torch.service.batch_problem import (FAMILY_DS, FAMILY_VC,
                                               StackedSpec, StackedTables,
                                               SvcState)
from repro_torch.service.driver import SolverService
from repro_torch.service.scheduler import (SCHEDULERS, Fifo, PriorityFifo,
                                           Scheduler, SchedulingPolicy,
                                           ShortestJobFirst, make_policy)
from repro_torch.service.ticket import (AdmissionError, RequestResult,
                                        SolveRequest, Ticket, TicketCancelled,
                                        TicketStatus)

__all__ = [
    "AdmissionError", "FAMILY_DS", "FAMILY_VC", "Fifo", "PriorityFifo",
    "RequestResult", "SCHEDULERS", "Scheduler", "SchedulingPolicy",
    "ShortestJobFirst", "SolveRequest", "SolverService", "StackedSpec",
    "StackedTables", "SvcState", "Ticket", "TicketCancelled",
    "TicketStatus", "make_policy",
]

"""The scalar reference of the paper's algorithms (Figs. 1, 3-5, 7), in
plain Python (counterpart of ``repro.core.serial``).

1. ``serial_rb`` — SERIAL-RB (Fig. 1) as an iterative one-node-per-step
   DFS with the paper's ``current_idx`` encoding.  ``Solver.oracle`` runs
   it on each family's scalar oracle; every parallel configuration must
   match its optimum.
2. ``ParallelRBSimulator`` — a discrete-time simulator of PARALLEL-RB
   (Fig. 7) with the paper's protocol: the GETPARENT topology (Fig. 5),
   round-robin GETNEXTPARENT re-probing, requests answered with
   GETHEAVIESTTASKINDEX / FIXINDEX (Fig. 4), incumbent broadcast, and
   ``passes > 2`` termination.  One tick advances every active core by
   one node visit, so the makespan in ticks is the simulated parallel
   running time and per-core T_S / T_R are the paper's Tables I/II.
3. ``PyProblem`` — the scalar problem protocol both run on.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

from repro_torch.core.indexing import fix_index

INF = 2 ** 30


class PyNodeEval(NamedTuple):
    """Scalar twin of :class:`repro_torch.core.api.NodeEval` (no payload —
    the oracle only tracks objective values)."""

    is_solution: bool
    value: int
    lower_bound: int
    left: Any
    right: Any


@dataclasses.dataclass(frozen=True)
class PyProblem:
    """Scalar version of :class:`repro_torch.core.api.BinaryProblem`: one
    fused ``evaluate(state, best) -> PyNodeEval`` per node visit, children
    independent of ``best``."""

    name: str
    max_depth: int
    root: Callable[[], Any]
    evaluate: Callable[[Any, int], PyNodeEval]

    def apply(self, state: Any, bit: int) -> Any:
        """Derived child generation (CONVERTINDEX replay uses this)."""
        ev = self.evaluate(state, INF)
        return ev.left if bit == 0 else ev.right


class _DFS:
    """Iterative DFS: ``idx[j]`` is the branch (0/1) taken from depth j to
    j+1 on the live path, ``-1`` a delegated right sibling, ``-2``
    unvisited; backtracking above ``base`` ends the core's task."""

    UNVISITED, DELEGATED = -2, -1

    def __init__(self, problem: PyProblem):
        self.p = problem
        self.idx: List[int] = [self.UNVISITED] * (problem.max_depth + 1)
        self.stack: List[Any] = [None] * (problem.max_depth + 2)
        self.depth = 0
        self.base = 0
        self.active = False
        self.nodes = 0

    def start_root(self) -> None:
        self.stack[0] = self.p.root()
        self.depth, self.base, self.active = 0, 0, True
        self.idx = [self.UNVISITED] * (self.p.max_depth + 1)

    def start_task(self, bits: List[int]) -> None:
        """CONVERTINDEX: replay a (FIXINDEX-ed) task index from the root."""
        self.idx = [self.UNVISITED] * (self.p.max_depth + 1)
        state = self.p.root()
        self.stack[0] = state
        for j, b in enumerate(bits):
            self.idx[j] = b
            state = self.p.apply(state, b)
            self.stack[j + 1] = state
        self.depth = self.base = len(bits)
        self.active = True

    def step(self, best: int) -> Tuple[bool, int]:
        """Visit one node. Returns (improved, value-if-improved-else-INF)."""
        if not self.active:
            return False, INF
        d = self.depth
        state = self.stack[d]
        c = self.idx[d]
        improved, val = False, INF

        if c == self.UNVISITED:                      # first arrival: visit node
            self.nodes += 1
            ev = self.p.evaluate(state, best)        # ONE fused node visit
            if ev.is_solution and ev.value < best:   # IsSolution (Fig. 3 l.5-6)
                improved, val, best = True, ev.value, ev.value
            pruned = ev.lower_bound >= best
            if ev.is_solution or pruned:             # leaf: backtrack (l.7-8)
                self._backtrack()
            else:                                    # descend left (l.13-16)
                self._descend(0, ev.left)
        elif c == 0:                                 # left done: go right
            ev = self.p.evaluate(state, best)
            self._descend(1, ev.right)
        else:                                        # c in {1, -1}: exhausted
            self._backtrack()
        return improved, val

    def _descend(self, bit: int, child: Any) -> None:
        d = self.depth
        self.idx[d] = bit
        self.stack[d + 1] = child
        if d + 1 <= self.p.max_depth:
            self.idx[d + 1] = self.UNVISITED
        self.depth = d + 1

    def _backtrack(self) -> None:
        self.depth -= 1
        if self.depth < self.base:
            self.active = False
            self.depth = self.base

    def get_heaviest(self) -> Optional[List[int]]:
        """GETHEAVIESTTASKINDEX over the live prefix [base, depth)."""
        for i in range(self.base, self.depth):
            if self.idx[i] == 0:
                self.idx[i] = self.DELEGATED
                return list(self.idx[: i + 1])
        return None


def serial_rb(problem: PyProblem, max_steps: int = 10 ** 8,
              record_visits: bool = False
              ) -> Tuple[int, int, List[Tuple[int, ...]]]:
    """SERIAL-RB (Fig. 1): returns (best value, nodes visited, visit log).

    The visit log (optional) records the bit-path of every visited node.
    """
    dfs = _DFS(problem)
    dfs.start_root()
    best = INF
    visits: List[Tuple[int, ...]] = []
    steps = 0
    while dfs.active and steps < max_steps:
        if record_visits and dfs.idx[dfs.depth] == _DFS.UNVISITED:
            visits.append(tuple(dfs.idx[: dfs.depth]))
        improved, val = dfs.step(best)
        if improved:
            best = val
        steps += 1
    return best, dfs.nodes, visits


@dataclasses.dataclass
class CoreStats:
    t_s: int = 0           # tasks received (main tasks), paper's T_S
    t_r: int = 0           # task requests issued, paper's T_R
    nodes: int = 0


class ParallelRBSimulator:
    """Discrete-time simulation of PARALLEL-RB (Fig. 7) on ``c`` cores.

    Requests and responses are mailbox entries consumed at the receiver's
    next tick (one-tick latency: a donor answers requests between node
    visits, Fig. 3 lines 9-11).  A core is 'active' (has a main task),
    'idle' (requesting) or 'inactive' (passes > 2, Fig. 7 line 5); the run
    ends when every core is inactive.
    """

    def __init__(self, problem: PyProblem, c: int,
                 instant_bound_share: bool = True):
        self.p = problem
        self.c = c
        self.cores = [_DFS(problem) for _ in range(c)]
        self.stats = [CoreStats() for _ in range(c)]
        self.state = ["idle"] * c
        self.parent = [get_parent(r, c) for r in range(c)]
        self.passes = [0] * c
        self.init = [True] * c
        self.requests: List[deque] = [deque() for _ in range(c)]   # ranks
        self.responses: List[deque] = [deque() for _ in range(c)]  # bits
        self.outstanding = [False] * c
        self.best = INF
        self.instant_bound_share = instant_bound_share
        self.pending_best: Dict[int, int] = {}   # core -> best (delayed)
        self.local_best = [INF] * c
        self.ticks = 0
        self.cores[0].start_root()
        self.state[0] = "active"
        self.stats[0].t_s = 1

    def _answer_requests(self, r: int) -> None:
        """Fig. 3 lines 9-11: a donor serves queued requests between
        visits."""
        while self.requests[r]:
            requester = self.requests[r].popleft()
            task = (self.cores[r].get_heaviest()
                    if self.state[r] == "active" else None)
            if task is not None:
                task = fix_index(task)
            self.responses[requester].append(task)

    def _core_best(self, r: int) -> int:
        return self.best if self.instant_bound_share else self.local_best[r]

    def _broadcast_best(self, v: int) -> None:
        """Notification message (§IV-B): free and instant, or delivered at
        each core's next tick (which changes pruning, never the optimum)."""
        self.best = min(self.best, v)
        if self.instant_bound_share:
            for i in range(self.c):
                self.local_best[i] = min(self.local_best[i], v)
        else:
            for i in range(self.c):
                self.pending_best[i] = min(self.pending_best.get(i, INF), v)

    def tick(self) -> None:
        self.ticks += 1
        if not self.instant_bound_share and self.pending_best:
            for i, v in list(self.pending_best.items()):
                self.local_best[i] = min(self.local_best[i], v)
            self.pending_best.clear()
        for r in range(self.c):
            # Inactive cores still answer queued requests (with null), so
            # no requester waits forever.
            self._answer_requests(r)
            if self.state[r] == "inactive":
                continue
            core = self.cores[r]
            if self.state[r] == "active":
                improved, val = core.step(self._core_best(r))
                self.stats[r].nodes = core.nodes
                if improved:
                    self._broadcast_best(val)
                if not core.active:
                    self.state[r] = "idle"
            if self.state[r] == "idle":
                self._idle_step(r)

    def _advance_parent(self, r: int) -> None:
        """Fig. 7 lines 12-14 / 18: move to the next parent."""
        if self.init[r]:
            self.init[r] = False
            self.parent[r] = (r + 1) % self.c
        else:
            self.parent[r], self.passes[r] = get_next_parent(
                self.parent[r], r, self.c, self.passes[r])
        if self.passes[r] > 2:                       # termination (l.5)
            self.state[r] = "inactive"

    def _idle_step(self, r: int) -> None:
        if self.responses[r]:                        # consume a reply
            self.outstanding[r] = False
            task = self.responses[r].popleft()
            if task is not None:
                self.cores[r].start_task(task)
                self.state[r] = "active"
                self.stats[r].t_s += 1
                self.passes[r] = 0
                if self.init[r]:                     # first reply: l.14
                    self.init[r] = False
                    self.parent[r] = (r + 1) % self.c
                return
            self._advance_parent(r)                  # null reply: probe on
            return
        if self.outstanding[r]:
            return                                   # wait for the reply
        target = self.parent[r]
        if target == r or self.state[target] == "inactive":
            self._advance_parent(r)                  # skip dead/self parents
            return
        self.requests[target].append(r)
        self.stats[r].t_r += 1
        self.outstanding[r] = True

    def run(self, max_ticks: int = 10 ** 7) -> "SimResult":
        while not all(s == "inactive" for s in self.state):
            if self.ticks >= max_ticks:
                raise RuntimeError("simulator did not terminate")
            self.tick()
        return SimResult(
            best=self.best,
            makespan=self.ticks,
            total_nodes=sum(st.nodes for st in self.stats),
            t_s=[st.t_s for st in self.stats],
            t_r=[st.t_r for st in self.stats],
        )


@dataclasses.dataclass
class SimResult:
    best: int
    makespan: int
    total_nodes: int
    t_s: List[int]
    t_r: List[int]

    @property
    def avg_t_s(self) -> float:
        return sum(self.t_s) / len(self.t_s)

    @property
    def avg_t_r(self) -> float:
        return sum(self.t_r) / len(self.t_r)


# -- Virtual topology (paper Fig. 5) ------------------------------------------


def get_parent(r: int, c: int) -> int:
    """GETPARENT (Fig. 5, top).  C_0's parent is itself by convention."""
    parent = 0
    for i in range(c):
        if 2 ** i > r:
            break
        parent = r - 2 ** i
    return parent


def get_next_parent(parent: int, r: int, c: int,
                    passes: int) -> Tuple[int, int]:
    """GETNEXTPARENT (Fig. 5, bottom): returns (new parent, new passes);
    ``passes`` counts the probe cycling past the core's own rank."""
    parent = (parent + 1) % c
    if parent == r:
        parent = (parent + 1) % c
        passes += 1
    return parent, passes

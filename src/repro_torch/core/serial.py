"""SERIAL-RB (paper Fig. 1), the scalar ground truth of the port.

A pure-Python copy of ``repro.core.serial``'s ``PyNodeEval``,
``PyProblem``, ``_DFS`` and ``serial_rb``: an iterative one-node-per-step
DFS with the paper's ``current_idx`` encoding.  ``Solver.oracle`` runs it
on each family's numpy oracle; every parallel configuration must match
its optimum.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, NamedTuple, Tuple

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

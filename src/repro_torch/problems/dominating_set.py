"""DOMINATING SET via reduction to MINIMUM SET COVER (paper §V), on PyTorch.

Counterpart of ``repro.problems.dominating_set``.  Universe = vertices;
the set of vertex ``v`` is its closed neighbourhood N[v].  Branch on the
candidate covering the most undominated vertices (ties: smallest id):
the left child takes ``v`` into the dominating set, the right child
discards ``v`` as a candidate.  Bound: ``|D| + ceil(undominated /
best_coverage)``; a node with undominated vertices and no possible
coverage is infeasible (INF bound).

The coverage counts, the branch vertex and the undominated count come
from ONE pass over all W lanes per engine step:
``kernels.bitset_ops.domination_stats`` (mask = undominated, valid =
candidates), a CUDA kernel launch for tables on the card.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.convert import words
from repro_torch.core.api import (INF_VALUE, BinaryProblem, NodeEval,
                                  resolve_device)
from repro_torch.core.serial import INF, PyNodeEval, PyProblem
from repro_torch.kernels.bitset_ops import domination_stats
from repro_torch.problems.graphs import (Graph, bit, full_mask,
                                         parse_graph_instance)
from repro_torch.problems.graphs import popcount as popcount_np
from repro_torch.problems.vertex_cover import BIT_WORDS, vbit
from repro_torch.registry import register_problem


class DSState(NamedTuple):
    dominated: torch.Tensor   # int32[..., w]
    cand: torch.Tensor        # int32[..., w] — vertices still allowed into D
    chosen: torch.Tensor      # int32[..., w] — current D
    size: torch.Tensor        # int32[...]


def _closed_adj(graph: Graph) -> np.ndarray:
    cadj = graph.adj.copy()
    for v in range(graph.n):
        cadj[v] |= bit(v, graph.words)
    return cadj


@register_problem(
    "ds",
    parse=parse_graph_instance,
    oracle=lambda graph: make_dominating_set_py(graph),
    doc="minimum dominating set via set-cover branching (paper §V)",
)
def make_dominating_set(graph: Graph, device: str = "cuda") -> BinaryProblem:
    """Batched BinaryProblem with its closed adjacency on ``device``."""
    dev = resolve_device(device)
    n, w = graph.n, graph.words
    cadj = words(_closed_adj(graph), dev)
    fullm = words(full_mask(n), dev)
    bit_words = words(BIT_WORDS, dev)

    def root() -> DSState:
        zeros = torch.zeros(w, dtype=torch.int32, device=dev)
        return DSState(dominated=zeros, cand=fullm.clone(),
                       chosen=zeros.clone(),
                       size=torch.zeros((), dtype=torch.int32, device=dev))

    def evaluate_batch(states: DSState, best: torch.Tensor) -> NodeEval:
        # ONE coverage pass covers every lane (one kernel launch on the
        # card): best |N[v] \ dominated| over candidates, its vertex, and
        # the undominated count.
        out = domination_stats(cadj, states.dominated,
                               states.cand.contiguous(), fullm)
        best_cov, u = out[:, 0], out[:, 2]
        # Vertex -1 (no candidate) normalises to 0, as at
        # dominating_set.py:91 and :201 of the reference.
        v = out[:, 1].clamp(min=0)

        is_sol = u == 0
        # Undominated vertices left but nothing can cover them: INF bound
        # (reference dominating_set.py:167-169).
        infeasible = (u > 0) & (best_cov <= 0)
        cov = best_cov.clamp(min=1)
        need = (u + cov - 1) // cov
        lb = torch.where(infeasible, INF_VALUE, states.size + need)

        bv = vbit(v, w, bit_words)
        new_cand = states.cand & ~bv
        left = DSState(dominated=states.dominated | cadj[v], cand=new_cand,
                       chosen=states.chosen | bv, size=states.size + 1)
        right = DSState(dominated=states.dominated, cand=new_cand,
                        chosen=states.chosen, size=states.size)
        return NodeEval(is_solution=is_sol, value=states.size,
                        lower_bound=lb, left=left, right=right,
                        payload=states.chosen)

    return BinaryProblem(
        name=f"ds[{graph.name}]", max_depth=n, root=root,
        evaluate_batch=evaluate_batch,
        payload_zero=lambda: torch.zeros(w, dtype=torch.int32, device=dev))


def make_dominating_set_py(graph: Graph) -> PyProblem:
    """numpy scalar mirror — branches identically to the batched form."""
    n, w = graph.n, graph.words
    cadj = _closed_adj(graph)
    fullm = full_mask(n)
    word = np.arange(n, dtype=np.int32) // 32
    shift = (np.arange(n, dtype=np.int32) % 32).astype(np.uint32)

    def vbit_np(v):
        out = np.zeros(w, np.uint32)
        out[v // 32] = np.uint32(1) << np.uint32(v % 32)
        return out

    def root():
        return (np.zeros(w, np.uint32), fullm.copy(),
                np.zeros(w, np.uint32), 0)

    def evaluate(state, best):
        dominated, cand, chosen, size = state
        cov = popcount_np(cadj & ~dominated[None, :]).sum(axis=1)
        cand_f = ((cand[word] >> shift) & np.uint32(1)) == 1
        cov = np.where(cand_f, cov, -1)

        u = int(popcount_np(fullm & ~dominated).sum())
        is_sol = u == 0

        best_cov = int(np.max(cov))
        if u > 0 and best_cov <= 0:
            lb = INF
        else:
            bc = max(best_cov, 1)
            lb = size + (u + bc - 1) // bc

        v = int(np.argmax(cov))
        bv = vbit_np(v)
        new_cand = cand & ~bv
        left = (dominated | cadj[v], new_cand, chosen | bv, size + 1)
        right = (dominated, new_cand, chosen, size)
        return PyNodeEval(is_sol, size, lb, left, right)

    return PyProblem(name=f"ds[{graph.name}]", max_depth=n, root=root,
                     evaluate=evaluate)

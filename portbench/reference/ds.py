"""Minimum dominating set: the plain reference of the ``ds-*``
configurations.

The paper's PARALLEL-DOMINATING-SET node (Abu-Khzam et al. 2013, §V), as
set cover over closed neighbourhoods: branch on the candidate ``v`` whose
closed neighbourhood covers the most undominated vertices (ties: smallest
id); the left child takes ``v``, the right child drops it as a candidate.
A node with nothing undominated is a solution of value |D|; its bound is
``|D| + ceil(undominated / best coverage)``, infinite when undominated
vertices remain that no candidate covers.

Computed from the dense adjacency with NumPy, with the payload check.
"""

from __future__ import annotations

import numpy as np

from portbench.reference.bits import first_argmax, num_words, onehot, pack, \
    unpack
from portbench.reference.engine import INF


class DominatingSet:
    """The node evaluation of one instance, batched over lanes."""

    leaves = ("dominated", "cand", "chosen", "size")

    def __init__(self, dense: np.ndarray):
        adj = np.asarray(dense, bool)
        self.n = adj.shape[0]
        self.closed = adj | np.eye(self.n, dtype=bool)
        self.closed_f = self.closed.astype(np.float32)
        self.payload_shape = (num_words(self.n),)

    def root(self) -> dict:
        w = num_words(self.n)
        return dict(dominated=np.zeros(w, np.uint32),
                    cand=pack(np.ones(self.n, bool)),
                    chosen=np.zeros(w, np.uint32), size=np.int32(0))

    def root_batch(self, inst: np.ndarray) -> dict:
        r = self.root()
        m = inst.shape[0]
        return {f: np.repeat(np.asarray(v)[None], m, axis=0)
                for f, v in r.items()}

    def evaluate(self, states: dict, inst=None) -> dict:
        n = self.n
        dominated = unpack(states["dominated"], n)
        cand = unpack(states["cand"], n)
        chosen = unpack(states["chosen"], n)
        size = states["size"].astype(np.int64)
        undom = ~dominated
        cov = (undom.astype(np.float32) @ self.closed_f).astype(np.int64)
        cov = np.where(cand, cov, -1)
        best_cov, v = first_argmax(cov)
        u = undom.sum(axis=1)
        infeasible = (u > 0) & (best_cov <= 0)
        c = np.maximum(best_cov, 1)
        lb = np.where(infeasible, INF, size + (u + c - 1) // c)
        bv = onehot(v, n)
        new_cand = pack(cand & ~bv)
        left = dict(dominated=pack(dominated | self.closed[v]),
                    cand=new_cand, chosen=pack(chosen | bv),
                    size=(size + 1).astype(np.int32))
        right = dict(dominated=np.asarray(states["dominated"], np.uint32),
                     cand=new_cand.copy(),
                     chosen=np.asarray(states["chosen"], np.uint32),
                     size=size.astype(np.int32))
        return dict(is_solution=u == 0, value=size, lower_bound=lb,
                    left=left, right=right,
                    payload=np.asarray(states["chosen"], np.uint32))


def payload_faults(dense: np.ndarray, payload: np.ndarray, value: int) -> int:
    """0 when ``payload`` is a dominating set of ``dense`` of exactly
    ``value`` vertices; else the undominated vertices plus 1 for a wrong
    size or a bit beyond the graph."""
    adj = np.asarray(dense, bool)
    n = adj.shape[0]
    words = np.asarray(payload, np.uint32)
    allbits = unpack(words, words.shape[-1] * 32)
    chosen = allbits[:n]
    closed = adj | np.eye(n, dtype=bool)
    undominated = int(np.count_nonzero(~closed[chosen].any(axis=0)))
    wrong = int(chosen.sum() != value) + int(allbits[n:].any())
    return undominated + wrong

#: The node evaluation of this family (the engine reference calls it).
NODE = DominatingSet

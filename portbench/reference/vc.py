"""Minimum vertex cover: the plain reference of the ``vc-*`` configurations.

The paper's PARALLEL-VERTEX-COVER node (Abu-Khzam et al. 2013, §V): branch
on an alive vertex ``v`` of maximum residual degree (ties: smallest id);
the left child puts ``v`` into the cover, the right child puts its alive
neighbours N(v) there.  A node without residual edges is a solution of
value |cover|; its bound is ``|cover| + ceil(m / Δ)``.

Computed from the dense adjacency with NumPy.  Also an exact serial
solver of its own (for the service's answers) and the payload check.
"""

from __future__ import annotations

import numpy as np

from portbench.reference.bits import first_argmax, num_words, onehot, pack, \
    unpack


class VertexCover:
    """The node evaluation of one instance, batched over lanes."""

    leaves = ("alive", "cover", "size")

    def __init__(self, dense: np.ndarray):
        self.adj = np.asarray(dense, bool)
        self.n = self.adj.shape[0]
        self.adj_f = self.adj.astype(np.float32)
        self.payload_shape = (num_words(self.n),)

    def root(self) -> dict:
        w = num_words(self.n)
        return dict(alive=pack(np.ones(self.n, bool)),
                    cover=np.zeros(w, np.uint32), size=np.int32(0))

    def root_batch(self, inst: np.ndarray) -> dict:
        r = self.root()
        m = inst.shape[0]
        return {f: np.repeat(np.asarray(v)[None], m, axis=0)
                for f, v in r.items()}

    def evaluate(self, states: dict, inst=None) -> dict:
        n = self.n
        alive = unpack(states["alive"], n)
        cover = unpack(states["cover"], n)
        size = states["size"].astype(np.int64)
        deg = (alive.astype(np.float32) @ self.adj_f).astype(np.int64)
        deg = np.where(alive, deg, -1)
        dmax, v = first_argmax(deg)
        m2 = np.maximum(deg, 0).sum(axis=1)
        d_eff = np.maximum(dmax, 1)
        lb = size + (m2 + 2 * d_eff - 1) // (2 * d_eff)
        bv = onehot(v, n)
        nb = self.adj[v] & alive
        left = dict(alive=pack(alive & ~bv), cover=pack(cover | bv),
                    size=(size + 1).astype(np.int32))
        right = dict(alive=pack(alive & ~(nb | bv)), cover=pack(cover | nb),
                     size=(size + nb.sum(axis=1)).astype(np.int32))
        return dict(is_solution=dmax <= 0, value=size, lower_bound=lb,
                    left=left, right=right,
                    payload=np.asarray(states["cover"], np.uint32))


def payload_faults(dense: np.ndarray, payload: np.ndarray, value: int) -> int:
    """0 when ``payload`` (uint32 words) is a vertex cover of ``dense`` of
    exactly ``value`` vertices; else the uncovered edges plus 1 for a
    wrong size or a bit beyond the graph."""
    dense = np.asarray(dense, bool)
    n = dense.shape[0]
    words = np.asarray(payload, np.uint32)
    allbits = unpack(words, words.shape[-1] * 32)
    inside = allbits[:n]
    iu, ju = np.nonzero(np.triu(dense, 1))
    uncovered = int(np.count_nonzero(~(inside[iu] | inside[ju])))
    wrong = int(inside.sum() != value) + int(allbits[n:].any())
    return uncovered + wrong


def optimum(dense: np.ndarray, slack: int = 0) -> int:
    """The minimum vertex cover's size, by a serial branch and bound of
    its own: vertices of degree 0 leave, a vertex of degree 1 puts its
    neighbour in, else branch on a vertex of maximum degree (it, or all
    its neighbours); bound: the larger of a greedy maximal matching and
    ceil(m / Δ).  ``slack`` > 0 prunes a subtree whose bound lies within
    ``slack`` of the incumbent: the control, which proves nothing."""
    dense = np.asarray(dense, bool)
    n = dense.shape[0]
    nbr = [sum(1 << int(u) for u in np.nonzero(dense[v])[0])
           for v in range(n)]
    best = [n]

    def rec(alive: int, size: int) -> None:
        while True:                       # degree-0 and degree-1 rules
            changed = False
            a = alive
            while a:
                low = a & -a
                v = low.bit_length() - 1
                a ^= low
                if not (alive >> v) & 1:
                    continue
                nb = nbr[v] & alive
                if nb == 0:
                    alive &= ~low
                    changed = True
                elif nb & (nb - 1) == 0:  # one neighbour: take it
                    alive &= ~(low | nb)
                    size += 1
                    changed = True
            if not changed:
                break
        if size >= best[0]:
            return
        if alive == 0:
            best[0] = size
            return
        degs = {}
        m2 = 0
        a = alive
        while a:
            low = a & -a
            v = low.bit_length() - 1
            a ^= low
            d = (nbr[v] & alive).bit_count()
            degs[v] = d
            m2 += d
        dmax = max(degs.values())
        matching, free = 0, alive
        while free:
            low = free & -free
            v = low.bit_length() - 1
            nb = nbr[v] & free & ~low
            free &= ~low
            if nb:
                free &= ~(nb & -nb)
                matching += 1
        need = max(matching, -(-m2 // (2 * dmax)))
        if size + need + slack >= best[0]:
            return
        v = min(u for u, d in degs.items() if d == dmax)
        rec(alive & ~(1 << v), size + 1)
        nb = nbr[v] & alive
        rec(alive & ~(nb | (1 << v)), size + nb.bit_count())

    rec((1 << n) - 1, 0)
    return best[0]

#: The node evaluation of this family (the engine reference calls it).
NODE = VertexCover

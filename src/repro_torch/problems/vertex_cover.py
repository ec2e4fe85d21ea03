"""VERTEX COVER by max-degree branching (paper §V), on PyTorch.

Counterpart of ``repro.problems.vertex_cover``.  Branch on an alive vertex
``v`` of maximum degree (ties: smallest id): the left child adds ``v`` to
the cover, the right child adds all alive neighbours N(v).  Bound:
``|cover| + ceil(m_alive / Δ_alive)``.

Every per-node quantity — the solution test, the bound and the branch
vertex — comes from ONE masked-popcount degree pass over all W lanes per
engine step: ``kernels.bitset_degree.degree_stats``, which launches the
CUDA kernel for tables on the card and runs the plain version for tables
on the CPU.  The tables live on the device the problem is built for.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.convert import words
from repro_torch.core.api import BinaryProblem, NodeEval, resolve_device
from repro_torch.core.serial import PyNodeEval, PyProblem
from repro_torch.kernels.bitset_degree import degree_stats
from repro_torch.kernels.ref import popcount
from repro_torch.problems.graphs import (Graph, full_mask,
                                         parse_graph_instance)
from repro_torch.problems.graphs import popcount as popcount_np
from repro_torch.registry import register_problem


class VCState(NamedTuple):
    alive: torch.Tensor    # int32[..., w] — vertices still in the residual graph
    cover: torch.Tensor    # int32[..., w] — vertices chosen into the cover
    size: torch.Tensor     # int32[...]    — |cover|


#: ``1 << b`` for b = 0..31 (bit 31 becomes INT32_MIN as an int32 word).
BIT_WORDS = np.left_shift(np.uint32(1), np.arange(32, dtype=np.uint32))


def vbit(v: torch.Tensor, w: int, bit_words: torch.Tensor) -> torch.Tensor:
    """int32[L, w] with only bit ``v[l]`` set in row l (v int32[L], >= 0;
    ``bit_words`` is ``BIT_WORDS`` on v's device)."""
    word = torch.arange(w, dtype=torch.int32, device=v.device)
    return torch.where(word[None, :] == (v // 32)[:, None],
                       bit_words[v % 32][:, None], 0)


@register_problem(
    "vc",
    parse=parse_graph_instance,
    oracle=lambda graph: make_vertex_cover_py(graph),
    doc="minimum vertex cover by max-degree branching (paper §V)",
)
def make_vertex_cover(graph: Graph, device: str = "cuda") -> BinaryProblem:
    """Batched BinaryProblem with its adjacency table on ``device``."""
    dev = resolve_device(device)
    n, w = graph.n, graph.words
    adj = words(graph.adj, dev)                       # int32[n, w]
    fullm = words(full_mask(n), dev)
    bit_words = words(BIT_WORDS, dev)

    def root() -> VCState:
        return VCState(alive=fullm.clone(),
                       cover=torch.zeros(w, dtype=torch.int32, device=dev),
                       size=torch.zeros((), dtype=torch.int32, device=dev))

    def evaluate_batch(states: VCState, best: torch.Tensor) -> NodeEval:
        # ONE degree pass covers every lane (one kernel launch on the card).
        out = degree_stats(adj, states.alive.contiguous())
        dmax, m2 = out[:, 0], out[:, 2]
        # The pass reports vertex -1 when nothing is alive; the reference
        # normalises it to 0 (vertex_cover.py:89 and :200), so dead states
        # yield the same (discarded) children.
        v = out[:, 1].clamp(min=0)

        edgeless = dmax <= 0                          # no residual edges
        d_eff = dmax.clamp(min=1)
        need = (m2 + 2 * d_eff - 1) // (2 * d_eff)    # ceil(m / Δ)
        lb = states.size + need

        bv = vbit(v, w, bit_words)
        nb = adj[v] & states.alive                    # alive neighbourhood
        nb_count = popcount(nb).sum(dim=1, dtype=torch.int32)
        left = VCState(alive=states.alive & ~bv, cover=states.cover | bv,
                       size=states.size + 1)
        right = VCState(alive=states.alive & ~(nb | bv),
                        cover=states.cover | nb, size=states.size + nb_count)
        return NodeEval(is_solution=edgeless, value=states.size,
                        lower_bound=lb, left=left, right=right,
                        payload=states.cover)

    return BinaryProblem(
        name=f"vc[{graph.name}]",
        max_depth=n,
        root=root,
        evaluate_batch=evaluate_batch,
        payload_zero=lambda: torch.zeros(w, dtype=torch.int32, device=dev),
    )


def make_vertex_cover_py(graph: Graph) -> PyProblem:
    """numpy scalar mirror — branches identically to the batched form."""
    n, w = graph.n, graph.words
    adj = graph.adj
    word_np = np.arange(n, dtype=np.int32) // 32
    shift_np = (np.arange(n, dtype=np.int32) % 32).astype(np.uint32)
    fullm = full_mask(n)

    def degrees(alive):
        degs = popcount_np(adj & alive[None, :]).sum(axis=1)
        alive_f = ((alive[word_np] >> shift_np) & np.uint32(1)) == 1
        return np.where(alive_f, degs, -1)

    def vbit_np(v):
        out = np.zeros(w, np.uint32)
        out[v // 32] = np.uint32(1) << np.uint32(v % 32)
        return out

    def root():
        return (fullm.copy(), np.zeros(w, np.uint32), 0)

    def evaluate(state, best):
        alive, cover, size = state
        degs = degrees(alive)                         # the ONE degree pass
        dmax = int(np.max(degs))
        edgeless = dmax <= 0

        d_eff = max(dmax, 1)
        m2 = int(np.maximum(degs, 0).sum())
        lb = size + (m2 + 2 * d_eff - 1) // (2 * d_eff)

        v = int(np.argmax(degs))
        bv = vbit_np(v)
        nb = adj[v] & alive
        left = (alive & ~bv, cover | bv, size + 1)
        right = (alive & ~(nb | bv), cover | nb,
                 size + int(popcount_np(nb).sum()))
        return PyNodeEval(edgeless, size, lb, left, right)

    return PyProblem(name=f"vc[{graph.name}]", max_depth=n, root=root,
                     evaluate=evaluate)

"""The public kernel library of the port (counterpart of
``repro.kernels.ops``): one name for each kernel, with the reference's
argument names and defaults.

The reference picks Pallas or its jnp oracle with ``use_pallas`` /
``interpret``; here the device of the tensors picks, in each kernel's own
wrapper: a CUDA tensor launches the hand-written Hopper kernel of
``csrc/`` (or raises), a CPU tensor runs the plain version of ``ref.py``.
The reference's bitset ``tile`` / ``stages`` knobs have no counterpart:
the port's bitset kernels have no such layouts.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import bitset_degree, bitset_ops
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import ssd_scan as _ssd


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: Optional[int] = None, softcap: float = 0.0,
                    query_scale: Optional[float] = None,
                    block_q: int = 128, block_k: int = 128) -> torch.Tensor:
    """Causal GQA attention, q [B, S, H, hd], k/v [B, S, G, hd] ->
    [B, S, H, hd].  ``block_q`` / ``block_k`` reach only the plain version
    (the CPU), whose blocks they are; the CUDA kernel tiles by itself."""
    return _flash.flash_attention(q, k, v, window=window, softcap=softcap,
                                  query_scale=query_scale, block_q=block_q,
                                  block_k=block_k)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, d: torch.Tensor, *,
             chunk: int = 64) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Mamba-2 SSD chunk scan -> (y [B, S, H, P], state [B, H, N, P])."""
    return _ssd.ssd_scan(x, dt, a, b, c, d, chunk=chunk)


def degree_stats(adj: torch.Tensor, alive: torch.Tensor) -> torch.Tensor:
    """(best_degree, best_vertex, degree_sum) per lane: the fused
    vertex-cover node statistics."""
    return bitset_degree.degree_stats(adj, alive)


def degree_argmax(adj: torch.Tensor, alive: torch.Tensor) -> torch.Tensor:
    """(best_degree, best_vertex) per lane."""
    return bitset_degree.degree_argmax(adj, alive)


def count_stats(table: torch.Tensor, mask: torch.Tensor,
                valid: torch.Tensor) -> torch.Tensor:
    """The universal masked-popcount pass (DESIGN.md §5.2):
    (best_count, best_vertex, count_sum, mask_count) per lane."""
    return bitset_ops.count_stats(table, mask, valid)


def stacked_count_stats(tables: torch.Tensor, inst: torch.Tensor,
                        mask: torch.Tensor,
                        valid: torch.Tensor) -> torch.Tensor:
    """The masked-popcount pass over stacked int32[K, n, w] tables
    (DESIGN.md §5.3): each lane against its instance's table; idle
    (inst < 0) lanes park on the (-1, -1, 0, 0) row."""
    return bitset_ops.stacked_count_stats(tables, inst, mask, valid)


def popcount_reduce(rows: torch.Tensor) -> torch.Tensor:
    """int32[L, w] -> int32[L] packed-set cardinalities."""
    return bitset_ops.popcount_reduce(rows)


def masked_row_reduce(table: torch.Tensor, select: torch.Tensor, *,
                      op: str = "or") -> torch.Tensor:
    """OR/AND-accumulate of the table rows selected by a bitset."""
    return bitset_ops.masked_row_reduce(table, select, op=op)


def domination_stats(cadj: torch.Tensor, dominated: torch.Tensor,
                     cand: torch.Tensor, fullm: torch.Tensor) -> torch.Tensor:
    """(best_coverage, branch_vertex, undominated) per lane: the fused
    dominating-set node statistics."""
    return bitset_ops.domination_stats(cadj, dominated, cand, fullm)

"""Vertex-cover degree statistics as a ``bitset_ops.count_stats`` binding
(counterpart of ``repro.kernels.bitset_degree``): mask = valid = the
alive set, so each count is a residual degree."""

from __future__ import annotations

import torch

from repro_torch.kernels import bitset_ops


def degree_stats(adj: torch.Tensor, alive: torch.Tensor) -> torch.Tensor:
    """adj: int32[n, w] packed adjacency; alive: int32[L, w] per-lane
    masks.  Returns int32[L, 3] = (best_degree, best_vertex, degree_sum);
    (-1, -1, 0) when no vertex is alive.  ``degree_sum`` is twice the
    residual edge count."""
    return bitset_ops.count_stats(adj, alive, alive)[:, :3]


def degree_argmax(adj: torch.Tensor, alive: torch.Tensor) -> torch.Tensor:
    """int32[L, 2] = (best_degree, best_vertex)."""
    return degree_stats(adj, alive)[:, :2]

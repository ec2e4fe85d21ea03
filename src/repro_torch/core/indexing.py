"""Indexed search trees, vectorised half (counterpart of
``repro.core.indexing`` lines 86-122), batched over a leading lane axis.

Binary-tree indices are bit paths: ``idx[j]`` is the branch taken from
depth ``j`` to ``j+1``.  ``idx[j] == LEFT`` means the right sibling at
depth ``j+1`` is still unexplored; the shallowest such slot is the
heaviest task (weight ``1/(d+1)``).  ``DELEGATED`` marks a right sibling
that was shipped to another lane.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.api import DELEGATED, LEFT, RIGHT, UNVISITED


def heaviest_open_slot(idx: torch.Tensor, base_depth: torch.Tensor,
                       depth: torch.Tensor) -> torch.Tensor:
    """Per-lane depth of the shallowest open (stealable) slot, or D_MAX.

    ``idx`` int8[W, D_MAX]; ``base_depth``/``depth`` int32[W].  A slot j
    is open iff ``base_depth <= j < depth`` and ``idx[j] == LEFT``.
    """
    d_max = idx.shape[-1]
    j = torch.arange(d_max, dtype=torch.int32, device=idx.device)
    open_mask = ((idx == LEFT) & (j >= base_depth[:, None])
                 & (j < depth[:, None]))
    return torch.where(open_mask, j, d_max).amin(dim=1).to(torch.int32)


def extract_task(idx: torch.Tensor, slot: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """GETHEAVIESTTASKINDEX + FIXINDEX for every lane at once.

    Returns ``(donor_idx, task_bits)``: the donor's index with
    ``idx[slot] = DELEGATED``, and the fixed index of the stolen node —
    the donor's path with delegation marks flattened to LEFT below
    ``slot``, RIGHT at ``slot``, UNVISITED beyond.
    """
    d_max = idx.shape[-1]
    j = torch.arange(d_max, dtype=torch.int32, device=idx.device)
    at = j == slot[:, None]
    donor_idx = torch.where(at, DELEGATED, idx)
    prefix = torch.where(idx < 0, LEFT, idx)
    bits = torch.where(j < slot[:, None], prefix, UNVISITED)
    bits = torch.where(at, RIGHT, bits)
    return donor_idx.to(torch.int8), bits.to(torch.int8)


def task_weight(slot: torch.Tensor) -> torch.Tensor:
    """Paper §II: w(N_{d,p}) = 1/(d+1); the stolen node is at depth slot+1."""
    return 1.0 / (slot.to(torch.float32) + 2.0)

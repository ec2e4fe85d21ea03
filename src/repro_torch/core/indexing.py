"""Indexed search trees (counterpart of ``repro.core.indexing``).

Two forms of the paper's index machinery (§IV-A, §IV-C):

1. the scalar transcriptions of Fig. 4 (``get_heaviest_task_index``,
   ``fix_index``) and ``ArbitraryIndex`` over Python lists and numpy, the
   oracles of the tests and of the simulator in ``core.serial``;
2. the vectorised forms the engine and the steal round use, batched over
   a leading lane axis.

Binary-tree indices are bit paths: ``idx[j]`` is the branch taken from
depth ``j`` to ``j+1``.  ``idx[j] == LEFT`` means the right sibling at
depth ``j+1`` is still unexplored; the shallowest such slot is the
heaviest task (weight ``1/(d+1)``).  ``DELEGATED`` marks a right sibling
that was shipped to another lane.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.api import DELEGATED, LEFT, RIGHT, UNVISITED

# -- 1. Scalar reference (paper Fig. 4) --------------------------------------


def get_heaviest_task_index(current_idx: List[int]) -> Optional[List[int]]:
    """Paper Fig. 4 (top): mark the first slot equal to 0 (left child in
    progress, right sibling pending) -1 in place and return the prefix
    ``current_idx[0..i]`` inclusive; None when no task is available."""
    for i in range(len(current_idx)):
        if current_idx[i] == 0:
            current_idx[i] = -1
            return list(current_idx[: i + 1])
    return None


def fix_index(temp_idx: List[int]) -> List[int]:
    """Paper Fig. 4 (bottom): interior negative entries (earlier
    delegations along the donor's path, which went left there) become 0
    and the last entry becomes 1, the stolen right sibling."""
    out = list(temp_idx)
    for i in range(len(out) - 1):
        if out[i] < 0:
            out[i] = 0
    out[-1] = 1
    return out


def index_to_position(bits: List[int]) -> Tuple[int, int]:
    """(depth, position) of the node addressed by a bit-path (paper §II)."""
    d = len(bits)
    p = 0
    for b in bits:
        p = (p << 1) | int(b)
    return d, p


# -- 2. Vectorised forms used by the engine ----------------------------------


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


# -- 3. Arbitrary branching factor (paper §IV-C) -----------------------------


class ArbitraryIndex:
    """Two-row index for trees with arbitrary branching factor (§IV-C).

    Row 0 (``idx1``): the child position taken at each depth.  Row 1
    (``idx2``): the number of unexplored right siblings at each depth.  The
    heaviest task is at the first depth whose ``idx2`` is non-zero;
    stealing takes a suffix of its siblings.  With branching factor 2 it
    is the binary scheme above.
    """

    def __init__(self, max_depth: int):
        self.max_depth = max_depth
        self.idx1 = np.full(max_depth, -2, dtype=np.int32)
        self.idx2 = np.full(max_depth, -2, dtype=np.int32)
        self.depth = 0

    def push_child(self, k: int, num_children: int) -> None:
        """Descend to the k-th child (0-based) of a node with
        ``num_children``."""
        self.idx1[self.depth] = k
        self.idx2[self.depth] = num_children - (k + 1)
        self.depth += 1

    def pop(self) -> None:
        self.depth -= 1
        self.idx1[self.depth] = -2
        self.idx2[self.depth] = -2

    def advance_sibling(self) -> bool:
        """Move to the next unexplored right sibling at the current depth;
        False when none remain (all explored or delegated)."""
        d = self.depth - 1
        if d < 0 or self.idx2[d] <= 0:
            return False
        self.idx1[d] += 1
        self.idx2[d] -= 1
        return True

    def heaviest_depth(self) -> Optional[int]:
        for x in range(self.depth):
            if self.idx2[x] > 0:
                return x
        return None

    def steal(self, take: int = 1) -> Optional[Tuple[np.ndarray, int, int]]:
        """Extract up to ``take`` trailing siblings of the heaviest depth:
        returns (path ``idx1[0..x]``, first stolen child position, count)
        and decrements ``idx2[x]`` (the paper's "S is a suffix" rule)."""
        x = self.heaviest_depth()
        if x is None:
            return None
        s = min(take, int(self.idx2[x]))
        first = self.idx1[x] + (self.idx2[x] - s) + 1
        self.idx2[x] -= s
        return self.idx1[: x + 1].copy(), int(first), s

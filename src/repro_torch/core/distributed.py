"""The single-device round (counterpart of ``repro.core.distributed``'s
``SolveStats`` and ``make_round`` with no mesh axes).

    round := expand(R engine steps) → intra-device steal → open-work count

The cross-device steal and the mesh code come with the multi-GPU slice.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import torch

from repro_torch.core import steal
from repro_torch.core.api import BinaryProblem
from repro_torch.core.engine import Lanes, make_expand


class SolveStats(NamedTuple):
    best: int
    rounds: int
    nodes: int
    t_s: int           # total tasks received (paper's T_S numerator)
    t_r: int           # total task requests (paper's T_R numerator)
    donated: int
    lanes: int
    t_c: int = 0       # tasks received cross-device (subset of t_s)


def make_round(problem: BinaryProblem, steps_per_round: int,
               fused_steps: int = 1
               ) -> Callable[[Lanes], Tuple[Lanes, torch.Tensor]]:
    """Build the round body (expand → steal → count).  Returns
    ``(lanes, open_work)`` with ``open_work`` int32[K] on the device:
    per instance, active lanes plus donatable slots (0 means drained)."""
    expand = make_expand(problem, steps_per_round, fused_steps)

    def round_fn(lanes: Lanes) -> Tuple[Lanes, torch.Tensor]:
        lanes = expand(lanes)
        lanes = steal.balance_device(problem, lanes)
        k = lanes.best.shape[0]
        safe_inst = lanes.inst.clamp(0, k - 1)
        slots = steal.donor_slots(lanes)
        contrib = (lanes.active.to(torch.int32)
                   + (lanes.active & (slots < lanes.idx.shape[1])
                      ).to(torch.int32))
        open_work = torch.zeros(k, dtype=torch.int32,
                                device=lanes.idx.device).index_add(
            0, safe_inst, contrib)
        return lanes, open_work

    return round_fn

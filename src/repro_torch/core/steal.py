"""Heaviest-task work stealing between lanes on one device (counterpart of
the single-device part of ``repro.core.steal``; paper §IV-A/B).

Every steal round, idle lanes (*thieves*) are matched with active lanes
that have an open right branch (*donors*), heaviest task first (the
shallowest open slot, lane id breaking ties).  Extraction is
GETHEAVIESTTASKINDEX (mark DELEGATED, ship the prefix) and installation
is FIXINDEX + CONVERTINDEX (replay).  Matching is scoped by instance: a
thief only takes work of its own instance, and unbound lanes neither
steal nor donate.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.api import UNVISITED, BinaryProblem, bcast, tree_map
from repro_torch.core.engine import Lanes, replay_path
from repro_torch.core.indexing import extract_task, heaviest_open_slot


def donor_slots(lanes: Lanes) -> torch.Tensor:
    """Per-lane shallowest open slot (IDX_LEN = no donatable work)."""
    return heaviest_open_slot(lanes.idx, lanes.base, lanes.depth)


def donor_mask(lanes: Lanes, slots: torch.Tensor) -> torch.Tensor:
    """Lanes that could donate: active, bound to an instance, open slot."""
    il = lanes.idx.shape[1]
    return lanes.active & (lanes.inst >= 0) & (slots < il)


def thief_mask(lanes: Lanes) -> torch.Tensor:
    """Lanes that may receive work: idle but bound to an instance."""
    return ~lanes.active & (lanes.inst >= 0)


def _rank_within_instance(member: torch.Tensor, key: torch.Tensor,
                          inst: torch.Tensor) -> torch.Tensor:
    """Rank of each member lane among same-instance members, by ``key``
    (an O(W^2) boolean reduction)."""
    same = inst[:, None] == inst[None, :]
    better = member[None, :] & same & (key[None, :] < key[:, None])
    return better.sum(dim=1, dtype=torch.int32)


def match_thieves_to_donors(lanes: Lanes, slots: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Instance-scoped ranked matching: the r-th thief of an instance (in
    lane order) takes the r-th donor of that instance (heaviest first).

    Returns ``(src, matched, is_donor)``: each thief's donor lane (0 where
    unmatched, as the reference's argmax gives), the "got a task" mask and
    the "was drained" mask.
    """
    w = lanes.idx.shape[0]
    lane_ids = torch.arange(w, dtype=torch.int32, device=lanes.idx.device)
    donors = donor_mask(lanes, slots)
    thieves = thief_mask(lanes)
    dkey = slots * w + lane_ids                    # weight-major, lane tiebreak
    drank = _rank_within_instance(donors, dkey, lanes.inst)
    trank = _rank_within_instance(thieves, lane_ids, lanes.inst)
    same = lanes.inst[:, None] == lanes.inst[None, :]
    pair = (thieves[:, None] & donors[None, :] & same
            & (trank[:, None] == drank[None, :]))
    # The first True of each row, explicitly: the smallest matching lane.
    first = torch.where(pair, lane_ids[None, :], w).amin(dim=1)
    src = torch.where(first == w, 0, first)
    return src, pair.any(dim=1), pair.any(dim=0)


def install_tasks(problem: BinaryProblem, lanes: Lanes, bits: torch.Tensor,
                  tdepth: torch.Tensor, tinst: torch.Tensor,
                  valid: torch.Tensor) -> Lanes:
    """Install per-lane task rows (row i goes to lane i; ``valid`` gates
    installation and only idle lanes take a row).  Receiving lanes replay
    the index from their instance's root (CONVERTINDEX) and own the
    stolen subtree from ``base = task depth``."""
    my_valid = valid & ~lanes.active
    new_stack = replay_path(problem, bits, tdepth, lanes.stack, tinst)
    stack = tree_map(lambda new, old: torch.where(bcast(my_valid, old), new,
                                                  old),
                     new_stack, lanes.stack)
    return lanes._replace(
        idx=torch.where(my_valid[:, None], bits, lanes.idx),
        depth=torch.where(my_valid, tdepth, lanes.depth),
        base=torch.where(my_valid, tdepth, lanes.base),
        inst=torch.where(my_valid, tinst, lanes.inst),
        active=lanes.active | my_valid,
        stack=stack,
        t_s=lanes.t_s + my_valid.to(torch.int32),
    )


def balance_device(problem: BinaryProblem, lanes: Lanes) -> Lanes:
    """One intra-device steal round: same-instance thief/donor matching."""
    slots = donor_slots(lanes)
    thieves = thief_mask(lanes)
    # Every bound idle lane "requests" this round (paper's T_R accounting).
    lanes = lanes._replace(t_r=lanes.t_r + thieves.to(torch.int32))
    src, matched, is_donor = match_thieves_to_donors(lanes, slots)

    new_idx_all, bits_all = extract_task(lanes.idx, slots)
    lanes = lanes._replace(
        idx=torch.where(is_donor[:, None], new_idx_all, lanes.idx),
        donated=lanes.donated + is_donor.to(torch.int32))

    bits = torch.where(matched[:, None], bits_all[src], UNVISITED).to(
        torch.int8)
    tdepth = torch.where(matched, slots[src] + 1, 0).to(torch.int32)
    tinst = torch.where(matched, lanes.inst[src], 0).to(torch.int32)
    return install_tasks(problem, lanes, bits, tdepth, tinst, matched)

"""Heaviest-task work stealing between lanes (counterpart of
``repro.core.steal``; paper §IV-A/B).

Every steal round, idle lanes (*thieves*) are matched with active lanes
that have an open right branch (*donors*), heaviest task first (the
shallowest open slot, lane id breaking ties).  Extraction is
GETHEAVIESTTASKINDEX (mark DELEGATED, ship the prefix) and installation
is FIXINDEX + CONVERTINDEX (replay).  Matching is scoped by instance: a
thief only takes work of its own instance, and unbound lanes neither
steal nor donate.

``extract_tasks`` and ``claim_tasks`` are the two lane-local halves of the
cross-device steal (``repro_torch.core.distributed.cross_device_steal``):
a shard extracts its per-instance quota of heaviest tasks, and its idle
lanes claim the shipped rows by global rank.

The single-device round replays in chunks (:func:`replay_begin`,
:func:`replay_chunk`): the round's plan installs the tasks and reports
``need``, the deepest task a lane received, and the host then runs
``ceil(need / REPLAY_CHUNK)`` chunks of passes, none on a round where no
lane received a task (``core.distributed.make_round``).  The mesh's
whole replay (:func:`replay_received`) runs the same passes, IDX_LEN of
them.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.core.api import (UNVISITED, BinaryProblem, bcast, root_of,
                                  tree_map)
from repro_torch.core.engine import Lanes
from repro_torch.core.indexing import extract_task, heaviest_open_slot
from repro_torch.obs import spans


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
    return _first_true(pair), pair.any(dim=1), pair.any(dim=0)


def _first_true(pair: torch.Tensor) -> torch.Tensor:
    """Column of the first True in each row of ``pair`` (0 where none), as
    the reference's ``argmax`` over a boolean row gives it."""
    cols = pair.shape[1]
    ids = torch.arange(cols, dtype=torch.int32, device=pair.device)
    first = torch.where(pair, ids[None, :], cols).amin(dim=1)
    return torch.where(first == cols, 0, first)


def extract_tasks(lanes: Lanes, quota: torch.Tensor, max_tasks: int
                  ) -> Tuple[Lanes, torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor, torch.Tensor]:
    """Extract the ``quota[i]`` heaviest tasks of each instance i.

    ``quota`` is int32[K].  Returns ``(lanes', bits[S, IDX_LEN],
    task_depth[S], task_inst[S], task_rank[S], valid[S])`` with S =
    min(W, max_tasks): the tasks come from distinct lanes in (instance,
    weight) order, and ``task_rank`` is a task's rank within its instance
    on this shard (the cross-device claim key).  Donor lanes get their
    slot marked DELEGATED and ``donated`` incremented.  The rows are
    ordered by a stable sort, as the reference's ``argsort``: another tie
    order would ship, and grow, a different tree.
    """
    w, il = lanes.idx.shape
    k = quota.shape[0]
    lane_ids = torch.arange(w, dtype=torch.int32, device=lanes.idx.device)
    slots = donor_slots(lanes)
    can = donor_mask(lanes, slots)
    dkey = slots * w + lane_ids
    drank = _rank_within_instance(can, dkey, lanes.inst)
    safe_inst = lanes.inst.clamp(0, k - 1)
    is_donor = can & (drank < quota[safe_inst])

    new_idx_all, bits_all = extract_task(lanes.idx, slots)
    lanes = lanes._replace(
        idx=torch.where(is_donor[:, None], new_idx_all, lanes.idx),
        donated=lanes.donated + is_donor.to(torch.int32))

    # Ship rows in (instance, weight) order: instance-major key sort.
    key = torch.where(is_donor, safe_inst * (il * w) + dkey, k * il * w + w)
    sel = torch.argsort(key, stable=True)[:max_tasks]
    valid = is_donor[sel]
    bits = torch.where(valid[:, None], bits_all[sel], UNVISITED).to(
        torch.int8)
    tdepth = torch.where(valid, slots[sel] + 1, 0).to(torch.int32)
    tinst = torch.where(valid, safe_inst[sel], 0).to(torch.int32)
    trank = torch.where(valid, drank[sel], 0).to(torch.int32)
    return lanes, bits, tdepth, tinst, trank, valid


def claim_tasks(thieves: torch.Tensor, inst: torch.Tensor,
                my_grank: torch.Tensor, w_inst: torch.Tensor,
                w_grank: torch.Tensor, w_valid: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-instance rank-arithmetic claim (cross-device step 4).

    ``thieves``/``inst``/``my_grank`` describe this shard's lanes (bool[W],
    int32[W], int32[W]); ``w_inst``/``w_grank``/``w_valid`` the gathered
    world task rows ([D*S]).  Returns ``(src, claim)``: the row each lane
    claims (0 where it claims none) and the claim mask.  When ``(inst,
    grank)`` is unique among valid rows and among thieves, which the quota
    construction guarantees, the claims are a bijection between matching
    rows and thieves, and a thief only claims a row of its own instance.
    """
    pair = (thieves[:, None] & w_valid[None, :]
            & (w_inst[None, :] == inst[:, None])
            & (w_grank[None, :] == my_grank[:, None]))       # [W, D*S]
    return _first_true(pair), pair.any(dim=1)


def assign_tasks(lanes: Lanes, bits: torch.Tensor, tdepth: torch.Tensor,
                 tinst: torch.Tensor, valid: torch.Tensor,
                 cross: bool = False) -> Tuple[Lanes, torch.Tensor]:
    """FIXINDEX for per-lane task rows (row i goes to lane i; ``valid``
    gates installation and only idle lanes take a row): every field but
    the state stack.  Returns the lanes and the mask of those that took a
    row, which :func:`replay_received` (on one device,
    :func:`replay_begin` and :func:`replay_chunk`) then rebuilds.
    ``cross`` (set by the cross-device steal) also counts each receipt in
    ``t_c``."""
    with spans.span("balance", device=True):
        my_valid = valid & ~lanes.active
        recv = my_valid.to(torch.int32)
        return lanes._replace(
            idx=torch.where(my_valid[:, None], bits, lanes.idx),
            depth=torch.where(my_valid, tdepth, lanes.depth),
            base=torch.where(my_valid, tdepth, lanes.base),
            inst=torch.where(my_valid, tinst, lanes.inst),
            active=lanes.active | my_valid,
            t_s=lanes.t_s + recv,
            t_c=lanes.t_c + recv if cross else lanes.t_c,
        ), my_valid


def replay_received(problem: BinaryProblem, lanes: Lanes,
                    received: torch.Tensor) -> Lanes:
    """CONVERTINDEX for the lanes in ``received``: each replays its own
    index from its instance's root and owns the stolen subtree from
    ``base`` = its depth; the other lanes keep their stacks.  The whole
    replay, eager: :func:`replay_begin`, then IDX_LEN passes of
    :func:`replay_chunk` into a copy of the stack.  Lane-local, so lanes
    of several shards on one device replay in one batch."""
    with spans.span("replay", device=True):
        lanes = lanes._replace(stack=tree_map(torch.clone, lanes.stack))
        replay, _ = replay_begin(problem, lanes, received)
        replay_chunk(problem, lanes, replay, passes=lanes.idx.shape[1])
        return lanes


#: CONVERTINDEX passes a replay chunk runs.  The card's reading (an NVIDIA
#: H100, PERF.md §6) put the deepest received task at 0 in every window
#: round of both saturated cells (920 and 941 rounds) and at 6-24 in the
#: service's (17-24 in 1,151 of 1,176 rounds): chunks of 8 run 24 passes
#: there where chunks of 16 would run 32.
REPLAY_CHUNK = 8

#: Single-device rounds since the last ``reset_replays()``: the rounds,
#: those in which no lane received a task (no chunk ran), the chunks
#: launched, the passes they ran (``REPLAY_CHUNK`` a chunk) and the passes
#: a whole replay would have run (IDX_LEN a round).
REPLAYS: Dict[str, int] = dict.fromkeys(
    ("rounds", "no_receiver", "chunks", "passes", "full_passes"), 0)


def reset_replays() -> None:
    for name in REPLAYS:
        REPLAYS[name] = 0


class Replay(NamedTuple):
    """What the round's replay chunks read besides the lanes: the lanes
    that received a task this round and the next pass to run."""

    received: torch.Tensor    # bool  [W]
    row: torch.Tensor         # int32 []


def replay_begin(problem: BinaryProblem, lanes: Lanes,
                 received: torch.Tensor) -> Tuple[Replay, torch.Tensor]:
    """Start the CONVERTINDEX of the lanes in ``received``: row 0 of each
    becomes its instance's root, written in place into ``lanes.stack``,
    which the caller owns.  Returns the :class:`Replay` that
    :func:`replay_chunk` continues (pass 0 next) and ``need``, the
    deepest task received (int32 [], 0 when no lane received one): the
    passes the replay has to run."""
    inst = torch.where(received, lanes.inst, 0).to(torch.int32)
    tree_map(lambda s, r: s[:, 0].copy_(
        torch.where(bcast(received, r), r, s[:, 0])),
        lanes.stack, root_of(problem, inst))
    need = torch.where(received, lanes.depth, 0).amax()
    row = torch.zeros((), dtype=torch.int32, device=need.device)
    return Replay(received, row), need.to(torch.int32)


def replay_chunk(problem: BinaryProblem, lanes: Lanes, replay: Replay,
                 passes: int = REPLAY_CHUNK) -> None:
    """``passes`` CONVERTINDEX passes from pass ``replay.row``, in place:
    pass j rebuilds row j + 1 of each receiving lane with j < ``depth``
    from its row j and path bit j; every other row keeps its contents.
    Advances ``replay.row`` on the device, so that the host launches
    chunks without writing.  The rows are those of
    ``engine.replay_path`` with as many passes."""
    il = lanes.idx.shape[1]
    js = replay.row + torch.arange(passes, dtype=torch.int32,
                                   device=replay.row.device)
    src = js.clamp(max=il - 1).long()        # passes past IDX_LEN take none
    dst = (js + 1).clamp(max=il).long()
    for i in range(passes):
        take = replay.received & (js[i] < lanes.depth)
        at, to = src[i:i + 1], dst[i:i + 1]
        bit = lanes.idx.index_select(1, at)[:, 0].to(torch.int32).clamp(0, 1)
        state = tree_map(lambda s: s.index_select(1, at)[:, 0], lanes.stack)
        child = problem.apply(state, bit)
        tree_map(lambda s, c: s.index_copy_(1, to, torch.where(
            bcast(take, c), c, s.index_select(1, to)[:, 0]).unsqueeze(1)),
            lanes.stack, child)
    replay.row.add_(passes)


def replay_chunks(need: int, idx_len: int) -> int:
    """The chunks a round runs for ``need`` passes, counted in
    :data:`REPLAYS` against the ``idx_len`` passes of a whole replay."""
    chunks = -(-need // REPLAY_CHUNK)
    REPLAYS["rounds"] += 1
    REPLAYS["no_receiver"] += chunks == 0
    REPLAYS["chunks"] += chunks
    REPLAYS["passes"] += chunks * REPLAY_CHUNK
    REPLAYS["full_passes"] += idx_len
    return chunks


def install_tasks(problem: BinaryProblem, lanes: Lanes, bits: torch.Tensor,
                  tdepth: torch.Tensor, tinst: torch.Tensor,
                  valid: torch.Tensor, cross: bool = False) -> Lanes:
    """Install per-lane task rows: :func:`assign_tasks`, then the
    receiving lanes replay the index from their instance's root
    (:func:`replay_received`)."""
    lanes, received = assign_tasks(lanes, bits, tdepth, tinst, valid, cross)
    return replay_received(problem, lanes, received)


def balance_plan(lanes: Lanes) -> Tuple[Lanes, torch.Tensor, torch.Tensor,
                                        torch.Tensor, torch.Tensor]:
    """The matching and extraction of one intra-device steal round:
    ``(lanes', bits, task_depth, task_inst, matched)``, thief i's row in
    row i, for :func:`install_tasks` (or :func:`assign_tasks`)."""
    with spans.span("balance", device=True):
        slots = donor_slots(lanes)
        thieves = thief_mask(lanes)
        # Every bound idle lane "requests" this round (paper's T_R
        # accounting).
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
        return lanes, bits, tdepth, tinst, matched


def balance_device(problem: BinaryProblem, lanes: Lanes) -> Lanes:
    """One intra-device steal round: same-instance thief/donor matching."""
    return install_tasks(problem, *balance_plan(lanes))

"""The bitset kernel library (counterpart of ``repro.kernels.bitset_ops``;
DESIGN.md §5.2-5.3 state the contract): the masked-popcount passes, the
dominating-set binding, row popcounts and masked row reductions.

``count_stats`` (one table), ``stacked_count_stats`` (K stacked tables,
one per service slot), ``popcount_reduce`` and ``masked_row_reduce``
dispatch by the device of their tensors: on a CUDA tensor they launch the
hand-written Hopper kernels ``csrc/<name>.cu`` (or raise), on a CPU
tensor they run the plain versions in ``ref.py``.  There is no fallback
from one to the other.  The reference's ``tile`` / ``stages`` /
``interpret`` knobs have no counterpart: one CUDA kernel replaces each
Pallas layout.  The two count kernels each have two routes, ``narrow``
(w <= 32) and ``wide``; ``autotune.choose`` names the one a launch takes
and the wrapper passes it to the launcher.

On ``meta`` tensors (a dry run, ``roofline.analyze``) each wrapper takes
the card's route with the launch replaced by its abstract form: the
output is allocated, the kernel's cost function (``<name>_cost``) is
recorded, nothing runs.  Where the work depends on the data (valid
vertices, selected rows) a cost function takes the data's count as an
argument (``chip_smoke.py`` counts it on the card) and otherwise counts
the most the shapes allow.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build, autotune, ref

#: Column layout of the ``count_stats`` output.
BEST, ARG, SUM, MASK_COUNT = 0, 1, 2, 3

#: Launches of each CUDA kernel since the last ``reset_launches()`` (one
#: registry for all the port's kernels, kept in ``_build``).
LAUNCHES = _build.LAUNCHES
reset_launches = _build.reset_launches

_PTR, _INT = ctypes.c_void_p, ctypes.c_int


def _check(table: torch.Tensor, mask: torch.Tensor,
           valid: torch.Tensor) -> None:
    if table.dim() != 2 or mask.dim() != 2 or valid.dim() != 2:
        raise ValueError("count_stats wants table [n, w], mask and valid "
                         "[L, w]")
    n, w = table.shape
    if mask.shape != valid.shape or mask.shape[1] != w:
        raise ValueError(f"count_stats: table {tuple(table.shape)} does not "
                         f"match mask {tuple(mask.shape)} / valid "
                         f"{tuple(valid.shape)}")
    if n < 1 or mask.shape[0] < 1 or n > 32 * w:
        raise ValueError(f"count_stats: bad shape n={n}, w={w}, "
                         f"L={mask.shape[0]}")
    for name, t in (("table", table), ("mask", mask), ("valid", valid)):
        if t.dtype != torch.int32:
            raise TypeError(f"count_stats: {name} must be int32 (uint32 "
                            f"bits), got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"count_stats: {name} must be contiguous")
        if t.device != table.device:
            raise ValueError(f"count_stats: {name} is on {t.device}, table "
                             f"on {table.device}")


def _route(name: str, route, n: int, w: int, lanes: int, k: int) -> str:
    """The route a launch takes: ``route``, or ``autotune.choose``'s pick
    when it is None (the launcher's ``wide`` flag is ``route == "wide"``)."""
    if route is None:
        route = autotune.choose(n, w, lanes, k).route
    if route not in autotune.routes(w):
        raise ValueError(f"{name}: route {route!r} does not take w={w} "
                         f"(routes: {autotune.routes(w)})")
    return route


def _roofline_cost(rl: autotune.Roofline) -> autotune.KernelCost:
    return autotune.KernelCost(0.0, rl.popcount_s, rl.nbytes)


def count_stats_cost(table: torch.Tensor, mask: torch.Tensor,
                     valid: torch.Tensor, *, sms: int = autotune.SMS,
                     clock_hz: float = autotune.SM_CLOCK_HZ
                     ) -> autotune.KernelCost:
    """``autotune.roofline`` of one ``count_stats`` launch: its bytes
    (its AND-popcounts are binary products on the tensor cores, which
    bound nothing)."""
    n, w = table.shape
    return _roofline_cost(autotune.roofline(n, w, mask.shape[0], sms=sms,
                                            clock_hz=clock_hz))


def stacked_count_stats_cost(tables: torch.Tensor, inst: torch.Tensor,
                             mask: torch.Tensor, valid: torch.Tensor, *,
                             valid_pairs: Optional[int] = None,
                             sms: int = autotune.SMS,
                             clock_hz: float = autotune.SM_CLOCK_HZ
                             ) -> autotune.KernelCost:
    """``autotune.roofline`` of one ``stacked_count_stats`` launch: a
    ``__popc`` per word of each of the ``valid_pairs`` valid (lane,
    vertex) pairs of unparked lanes (default: every vertex of every
    lane), or its bytes."""
    k, n, w = tables.shape
    return _roofline_cost(autotune.roofline(
        n, w, mask.shape[0], k, valid_pairs=valid_pairs, sms=sms,
        clock_hz=clock_hz))


def popcount_reduce_cost(rows: torch.Tensor, *, sms: int = autotune.SMS,
                         clock_hz: float = autotune.SM_CLOCK_HZ
                         ) -> autotune.KernelCost:
    """A ``__popc`` per word at its issue rate, or the rows read and the
    counts written."""
    lanes, w = rows.shape
    return autotune.KernelCost(
        0.0, autotune.issue_s(lanes * w, autotune.POPC_PER_CLOCK_PER_SM,
                              sms, clock_hz), 4 * (lanes * w + lanes))


def masked_row_reduce_cost(table: torch.Tensor, select: torch.Tensor, *,
                           selected: Optional[int] = None,
                           sms: int = autotune.SMS,
                           clock_hz: float = autotune.SM_CLOCK_HZ
                           ) -> autotune.KernelCost:
    """One LOP3 takes three inputs, so it folds two selected rows into a
    word's accumulator (acc | a | b, acc & a & b): the least work is
    ``selected`` (lane, row) pairs (default: every row of every lane)
    times w / 2 LOP3s at the 32-bit logic rate; or the table and the
    selects read and the output written."""
    n, w = table.shape
    lanes = select.shape[0]
    if selected is None:
        selected = lanes * n
    lop3s = (selected * w + 1) // 2
    return autotune.KernelCost(
        0.0, autotune.issue_s(lop3s, autotune.LOGIC_PER_CLOCK_PER_SM, sms,
                              clock_hz), 4 * (n * w + 2 * lanes * w))


def count_stats(table: torch.Tensor, mask: torch.Tensor,
                valid: torch.Tensor, *,
                route: Optional[str] = None) -> torch.Tensor:
    """The masked-popcount pass: table int32[n, w]; mask/valid int32[L, w]
    -> int32[L, 4] = (best_count, best_vertex, count_sum, mask_count); see
    ``ref.count_stats_ref`` for the contract.  ``route`` ("narrow" or
    "wide") overrides ``autotune.choose`` on the card."""
    _check(table, mask, valid)
    n, w = table.shape
    lanes = mask.shape[0]
    if table.device.type == "cpu":
        if route is not None:
            _route("count_stats", route, n, w, lanes, 1)
        return ref.count_stats_ref(table, mask, valid)
    if table.device.type not in ("cuda", "meta"):
        raise ValueError(f"count_stats has no kernel for {table.device}")
    route = _route("count_stats", route, n, w, lanes, 1)
    out = torch.empty((lanes, 4), dtype=torch.int32, device=table.device)
    if table.device.type == "meta":
        _build.abstract("count_stats", count_stats_cost(table, mask, valid))
    else:
        _build.launch("count_stats", [_PTR] * 4 + [_INT] * 4,
                      [table.data_ptr(), mask.data_ptr(), valid.data_ptr(),
                       out.data_ptr(), n, w, lanes, int(route == "wide")],
                      table.device, route=route)
    return out


def stacked_count_stats(tables: torch.Tensor, inst: torch.Tensor,
                        mask: torch.Tensor, valid: torch.Tensor, *,
                        route: Optional[str] = None) -> torch.Tensor:
    """``count_stats`` over stacked tables: tables int32[K, n, w]; inst
    int32[L]; mask/valid int32[L, w] -> int32[L, 4], lane l reduced
    against ``tables[inst[l]]``; see ``ref.stacked_count_stats_ref``.

    A lane with ``inst < 0`` is parked at (-1, -1, 0, 0) and reads no
    table.  Ids must stay below K: the reference's two layouts disagree
    on ``inst >= K`` (one clips, one parks), so the contract excludes it.
    This wrapper raises on it where ``inst`` already lies on the host; on
    the card checking would cost a device sync, and the kernel parks such
    a lane rather than read outside the tables.  ``route`` as for
    ``count_stats``.
    """
    if tables.dim() != 3 or inst.dim() != 1:
        raise ValueError("stacked_count_stats wants tables [K, n, w], inst "
                         "[L], mask and valid [L, w]")
    k = tables.shape[0]
    if k < 1 or inst.shape[0] != mask.shape[0]:
        raise ValueError(f"stacked_count_stats: K={k} tables, inst "
                         f"{tuple(inst.shape)} for {mask.shape[0]} lanes")
    _check(tables[0], mask, valid)
    if inst.dtype != torch.int32:
        raise TypeError(f"stacked_count_stats: inst must be int32, got "
                        f"{inst.dtype}")
    for name, t in (("tables", tables), ("inst", inst)):
        if not t.is_contiguous():
            raise ValueError(f"stacked_count_stats: {name} must be "
                             f"contiguous")
        if t.device != mask.device:
            raise ValueError(f"stacked_count_stats: {name} is on "
                             f"{t.device}, mask on {mask.device}")
    _, n, w = tables.shape
    lanes = mask.shape[0]
    if tables.device.type == "cpu":
        if route is not None:
            _route("stacked_count_stats", route, n, w, lanes, k)
        if int(inst.max()) >= k:
            raise ValueError(f"stacked_count_stats: instance id "
                             f"{int(inst.max())} >= K={k}")
        return ref.stacked_count_stats_ref(tables, inst, mask, valid)
    if tables.device.type not in ("cuda", "meta"):
        raise ValueError(f"stacked_count_stats has no kernel for "
                         f"{tables.device}")
    route = _route("stacked_count_stats", route, n, w, lanes, k)
    out = torch.empty((lanes, 4), dtype=torch.int32, device=tables.device)
    if tables.device.type == "meta":
        _build.abstract("stacked_count_stats", stacked_count_stats_cost(
            tables, inst, mask, valid))
    else:
        _build.launch("stacked_count_stats", [_PTR] * 5 + [_INT] * 5,
                      [tables.data_ptr(), inst.data_ptr(), mask.data_ptr(),
                       valid.data_ptr(), out.data_ptr(), k, n, w, lanes,
                       int(route == "wide")], tables.device, route=route)
    return out


def _check_words(name: str, **tensors: torch.Tensor) -> torch.device:
    """Every operand int32 (uint32 bits), 2-D, contiguous, on one device."""
    device = None
    for arg, t in tensors.items():
        if t.dim() != 2:
            raise ValueError(f"{name}: {arg} must be [rows, w], got "
                             f"{tuple(t.shape)}")
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: {arg} must be int32 (uint32 bits), "
                            f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
        if device is not None and t.device != device:
            raise ValueError(f"{name}: operands on {device} and {t.device}")
        device = t.device
    if device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"{name} has no kernel for {device}")
    return device


def popcount_reduce(rows: torch.Tensor) -> torch.Tensor:
    """int32[L, w] -> int32[L]: the popcount of each packed row (the size
    of each set)."""
    device = _check_words("popcount_reduce", rows=rows)
    if device.type == "cpu":
        return ref.popcount_reduce_ref(rows)
    lanes, w = rows.shape
    out = torch.empty((lanes,), dtype=torch.int32, device=device)
    if lanes:
        if device.type == "meta":
            _build.abstract("popcount_reduce", popcount_reduce_cost(rows))
        else:
            _build.launch("popcount_reduce", [_PTR] * 2 + [_INT] * 2,
                          [rows.data_ptr(), out.data_ptr(), lanes, w],
                          device)
    return out


def masked_row_reduce(table: torch.Tensor, select: torch.Tensor, *,
                      op: str = "or") -> torch.Tensor:
    """Bitwise OR (or AND) of the rows of ``table`` (int32[n, w]) whose
    bit is set in ``select`` (int32[L, w]) -> int32[L, w].  Bits at or
    above n select nothing; an empty selection gives the identity (0 for
    OR, -1 = 0xFFFFFFFF for AND).  The OR form with an adjacency table is
    N(S) of the selected set S; the AND form intersects constraint rows."""
    if op not in ("or", "and"):
        raise ValueError(f"unknown reduce op {op!r}")
    device = _check_words("masked_row_reduce", table=table, select=select)
    n, w = table.shape
    lanes = select.shape[0]
    if select.shape[1] != w or n < 1 or n > 32 * w:
        raise ValueError(f"masked_row_reduce: table {tuple(table.shape)} "
                         f"does not match select {tuple(select.shape)}")
    if device.type == "cpu":
        return ref.masked_row_reduce_ref(table, select, op=op)
    out = torch.empty((lanes, w), dtype=torch.int32, device=device)
    if lanes:
        if device.type == "meta":
            _build.abstract("masked_row_reduce",
                            masked_row_reduce_cost(table, select))
        else:
            _build.launch("masked_row_reduce", [_PTR] * 3 + [_INT] * 4,
                          [table.data_ptr(), select.data_ptr(),
                           out.data_ptr(), n, w, lanes, int(op == "and")],
                          device)
    return out


def domination_stats(cadj: torch.Tensor, dominated: torch.Tensor,
                     cand: torch.Tensor, fullm: torch.Tensor) -> torch.Tensor:
    """Dominating set's node statistics as a ``count_stats`` binding:
    mask = the undominated set, valid = the candidate set.  ``cadj``:
    int32[n, w] CLOSED adjacency; ``dominated``/``cand``: int32[L, w];
    ``fullm``: int32[w] real-vertex mask.  Returns int32[L, 3] =
    ``(best_coverage, branch_vertex, undominated)``."""
    mask = fullm[None, :] & ~dominated
    out = count_stats(cadj, mask, cand)
    # A list index would become a host tensor copied to the card at every
    # call, a copy a CUDA graph's capture refuses: stack the columns.
    return torch.stack((out[:, BEST], out[:, ARG], out[:, MASK_COUNT]), dim=1)

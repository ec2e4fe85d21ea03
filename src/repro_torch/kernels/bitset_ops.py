"""The masked-popcount passes and the dominating-set binding (counterpart
of ``repro.kernels.bitset_ops``; DESIGN.md §5.2-5.3 state the contract).

``count_stats`` (one table) and ``stacked_count_stats`` (K stacked
tables, one per service slot) dispatch by the device of their tensors: on
a CUDA tensor they launch the hand-written Hopper kernels
``csrc/count_stats.cu`` and ``csrc/stacked_count_stats.cu`` (or raise), on
a CPU tensor they run the plain versions in ``ref.py``.  There is no
fallback from one to the other.  The reference's ``tile`` /
``stages`` / ``interpret`` knobs have no counterpart: one CUDA kernel
replaces both Pallas layouts.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Dict

import torch

from repro_torch.kernels import _build, ref

#: Column layout of the ``count_stats`` output.
BEST, ARG, SUM, MASK_COUNT = 0, 1, 2, 3

#: Largest row width (in 32-bit words) the CUDA kernel takes: n <= 1024.
MAX_WORDS = 32

#: Launches of each CUDA kernel since the last ``reset_launches()``.
LAUNCHES: Dict[str, int] = {"count_stats": 0, "stacked_count_stats": 0}

_ENTRY: Dict[str, Callable] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _entry(name: str, pointers: int, ints: int) -> Callable:
    """``<name>_launch`` of ``csrc/<name>.cu``, built and bound at first
    use: ``pointers`` device pointers, then ``ints`` ints, then the
    stream; returns the CUDA error code."""
    fn = _ENTRY.get(name)
    if fn is None:
        fn = getattr(_build.load(name), f"{name}_launch")
        fn.argtypes = ([ctypes.c_void_p] * pointers + [ctypes.c_int] * ints
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _ENTRY[name] = fn
    return fn


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


def count_stats(table: torch.Tensor, mask: torch.Tensor,
                valid: torch.Tensor) -> torch.Tensor:
    """The masked-popcount pass: table int32[n, w]; mask/valid int32[L, w]
    -> int32[L, 4] = (best_count, best_vertex, count_sum, mask_count); see
    ``ref.count_stats_ref`` for the contract."""
    _check(table, mask, valid)
    if table.device.type == "cpu":
        return ref.count_stats_ref(table, mask, valid)
    if table.device.type != "cuda":
        raise ValueError(f"count_stats has no kernel for {table.device}")
    n, w = table.shape
    lanes = mask.shape[0]
    if w > MAX_WORDS:
        raise ValueError(f"count_stats kernel takes w <= {MAX_WORDS} words "
                         f"(n <= {32 * MAX_WORDS}), got w={w}")
    out = torch.empty((lanes, 4), dtype=torch.int32, device=table.device)
    stream = torch.cuda.current_stream(table.device).cuda_stream
    err = _entry("count_stats", 4, 3)(table.data_ptr(), mask.data_ptr(),
                                      valid.data_ptr(), out.data_ptr(), n, w,
                                      lanes, stream)
    if err != 0:
        raise RuntimeError(f"count_stats launch failed: CUDA error {err}")
    LAUNCHES["count_stats"] += 1
    return out


def stacked_count_stats(tables: torch.Tensor, inst: torch.Tensor,
                        mask: torch.Tensor,
                        valid: torch.Tensor) -> torch.Tensor:
    """``count_stats`` over stacked tables: tables int32[K, n, w]; inst
    int32[L]; mask/valid int32[L, w] -> int32[L, 4], lane l reduced
    against ``tables[inst[l]]``; see ``ref.stacked_count_stats_ref``.

    A lane with ``inst < 0`` is parked at (-1, -1, 0, 0) and reads no
    table.  Ids must stay below K: the reference's two layouts disagree
    on ``inst >= K`` (one clips, one parks), so the contract excludes it.
    This wrapper raises on it where ``inst`` already lies on the host; on
    the card checking would cost a device sync, and the kernel parks such
    a lane rather than read outside the tables.
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
    if tables.device.type == "cpu":
        if int(inst.max()) >= k:
            raise ValueError(f"stacked_count_stats: instance id "
                             f"{int(inst.max())} >= K={k}")
        return ref.stacked_count_stats_ref(tables, inst, mask, valid)
    if tables.device.type != "cuda":
        raise ValueError(f"stacked_count_stats has no kernel for "
                         f"{tables.device}")
    _, n, w = tables.shape
    lanes = mask.shape[0]
    if w > MAX_WORDS:
        raise ValueError(f"stacked_count_stats kernel takes w <= "
                         f"{MAX_WORDS} words (n <= {32 * MAX_WORDS}), got "
                         f"w={w}")
    out = torch.empty((lanes, 4), dtype=torch.int32, device=tables.device)
    stream = torch.cuda.current_stream(tables.device).cuda_stream
    err = _entry("stacked_count_stats", 5, 4)(
        tables.data_ptr(), inst.data_ptr(), mask.data_ptr(),
        valid.data_ptr(), out.data_ptr(), k, n, w, lanes, stream)
    if err != 0:
        raise RuntimeError(f"stacked_count_stats launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["stacked_count_stats"] += 1
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
    return out[:, [BEST, ARG, MASK_COUNT]]

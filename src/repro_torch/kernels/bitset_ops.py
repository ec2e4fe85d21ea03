"""The masked-popcount pass and its dominating-set binding (counterpart of
``repro.kernels.bitset_ops``; DESIGN.md §5.2 states the contract).

``count_stats`` dispatches by the device of its tensors: on a CUDA tensor
it launches the hand-written Hopper kernel ``csrc/count_stats.cu`` (or
raises), on a CPU tensor it runs the plain version in ``ref.py``.  There
is no fallback from one to the other.  The reference's ``tile`` /
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
LAUNCHES: Dict[str, int] = {"count_stats": 0}

_ENTRY: Dict[str, Callable] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _count_stats_entry() -> Callable:
    fn = _ENTRY.get("count_stats")
    if fn is None:
        fn = _build.load("count_stats").count_stats_launch
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _ENTRY["count_stats"] = fn
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
    err = _count_stats_entry()(table.data_ptr(), mask.data_ptr(),
                               valid.data_ptr(), out.data_ptr(), n, w, lanes,
                               stream)
    if err != 0:
        raise RuntimeError(f"count_stats launch failed: CUDA error {err}")
    LAUNCHES["count_stats"] += 1
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

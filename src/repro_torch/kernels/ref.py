"""Plain PyTorch versions of the port's kernels (counterpart of
``repro.kernels.ref``).

flash_attention -> repro_torch.models.attention.blocked_attention
ssd_scan        -> repro_torch.models.ssm.ssd_chunked
bitset kernels  -> count_stats / stacked_count_stats / popcount_reduce /
                   masked_row_reduce / domination_stats / degree_stats below

The CPU runs these; ``chip_smoke.py`` holds each CUDA kernel against them
on the card.  Bitsets are ``int32`` tensors holding ``uint32`` bits (the
AND identity 0xFFFFFFFF is -1).  The popcount is SWAR in int64: PyTorch
has no popcount, and int32 SWAR would overflow in the final multiply and
shift arithmetically.
"""

from __future__ import annotations

import torch

from repro_torch.models.attention import \
    blocked_attention as flash_attention_ref  # noqa: F401
from repro_torch.models.ssm import ssd_chunked


def ssd_scan_ref(x, dt, a, b, c, d, chunk: int = 64):
    return ssd_chunked(x, dt, a, b, c, d, chunk=chunk)


def popcount(words: torch.Tensor) -> torch.Tensor:
    """Per-word popcount of int32-held uint32 words (int32, same shape)."""
    x = words.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (((x * 0x01010101) & 0xFFFFFFFF) >> 24).to(torch.int32)


def bit_set(words: torch.Tensor, n: int) -> torch.Tensor:
    """bool[L, n]: is bit v of each packed row ``words`` [L, w] set?"""
    vid = torch.arange(n, device=words.device)
    return ((words[:, vid // 32] >> (vid % 32).to(torch.int32)) & 1) == 1


def count_stats_ref(table: torch.Tensor, mask: torch.Tensor,
                    valid: torch.Tensor) -> torch.Tensor:
    """The masked-popcount pass: table int32[n, w]; mask/valid int32[L, w]
    -> int32[L, 4] = (best_count, best_vertex, count_sum, mask_count).

    ``count[v] = popcount(table[v] & mask)`` for vertices whose ``valid``
    bit is set (-1 otherwise); ``best_vertex`` is the smallest id reaching
    the max (-1 when nothing is valid); ``count_sum = Σ max(count, 0)``;
    ``mask_count = popcount(mask)``.
    """
    return _count_stats_rows(table[None, :, :], mask, valid)


def stacked_count_stats_ref(tables: torch.Tensor, inst: torch.Tensor,
                            mask: torch.Tensor,
                            valid: torch.Tensor) -> torch.Tensor:
    """``count_stats_ref`` of lane l against ``tables[inst[l]]``: tables
    int32[K, n, w]; inst int32[L]; mask/valid int32[L, w] -> int32[L, 4].

    A lane with ``inst < 0`` (the service's NO_INSTANCE) is parked: its
    masks are zeroed, so it gives the no-valid row (-1, -1, 0, 0).
    Ids at or above K lie outside the contract.
    """
    k = tables.shape[0]
    idle = (inst < 0)[:, None]
    mask = torch.where(idle, 0, mask)
    valid = torch.where(idle, 0, valid)
    rows = tables[inst.clamp(0, k - 1).long()]              # [L, n, w]
    return _count_stats_rows(rows, mask, valid)


def _count_stats_rows(rows: torch.Tensor, mask: torch.Tensor,
                      valid: torch.Tensor) -> torch.Tensor:
    """The pass against ``rows`` [1 or L, n, w] (one table for every lane,
    or one per lane)."""
    n = rows.shape[1]
    counts = popcount(rows & mask[:, None, :]).sum(
        dim=2, dtype=torch.int32)                          # [L, n]
    counts = torch.where(bit_set(valid, n), counts, -1)
    best = counts.amax(dim=1)
    vid = torch.arange(n, dtype=torch.int32, device=rows.device)
    first = torch.where(counts == best[:, None], vid, n).amin(dim=1)
    arg = torch.where(best < 0, -1, first)
    total = counts.clamp(min=0).sum(dim=1, dtype=torch.int32)
    mcount = popcount(mask).sum(dim=1, dtype=torch.int32)
    return torch.stack([best, arg, total, mcount], dim=1).to(torch.int32)


def popcount_reduce_ref(rows: torch.Tensor) -> torch.Tensor:
    """int32[L, w] -> int32[L]: the popcount of each packed row."""
    return popcount(rows).sum(dim=-1, dtype=torch.int32)


def masked_row_reduce_ref(table: torch.Tensor, select: torch.Tensor, *,
                          op: str = "or") -> torch.Tensor:
    """table int32[n, w]; select int32[L, w] -> int32[L, w]: OR (AND) of
    the rows whose bit is set in ``select`` (bits >= n select nothing;
    the identity, 0 or -1, for an empty selection)."""
    if op not in ("or", "and"):
        raise ValueError(f"unknown reduce op {op!r}")
    n = table.shape[0]
    ident = 0 if op == "or" else -1
    rows = torch.where(bit_set(select, n)[:, :, None], table[None],
                       ident)                              # [L, n, w]
    while rows.shape[1] > 1:                # log2 tree over the rows
        if rows.shape[1] % 2:
            rows = torch.cat([rows, torch.full_like(rows[:, :1], ident)], 1)
        half = rows.shape[1] // 2
        lo, hi = rows[:, :half], rows[:, half:]
        rows = lo | hi if op == "or" else lo & hi
    return rows[:, 0].to(torch.int32)


def degree_stats_ref(adj: torch.Tensor, alive: torch.Tensor) -> torch.Tensor:
    """adj int32[n, w]; alive int32[L, w] -> int32[L, 3] of
    (best_degree, best_vertex, degree_sum); (-1, -1, 0) when nothing is
    alive."""
    return count_stats_ref(adj, alive, alive)[:, :3]


def domination_stats_ref(cadj: torch.Tensor, dominated: torch.Tensor,
                         cand: torch.Tensor, fullm: torch.Tensor
                         ) -> torch.Tensor:
    """Dominating set's (best_coverage, branch_vertex, undominated)."""
    mask = fullm[None, :] & ~dominated
    out = count_stats_ref(cadj, mask, cand)
    return out[:, [0, 1, 3]]

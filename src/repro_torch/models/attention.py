"""Attention in plain PyTorch (counterpart of ``repro.models.attention``):
RoPE, blocked causal attention (GQA / SWA / softcap) and one-token
decode attention against a (rolling) KV cache.

A blocked online softmax with f32 running (max, sum, acc), KV block by KV
block.  It is the plain version of the ``flash_attention`` kernel
(``kernels/csrc/flash_attention.cu``) and keeps the reference's
arithmetic: f32 scores from the inputs' own values, masked scores set to
``NEG_INF``, ``p`` cast to ``v``'s dtype before the PV product (the bf16
quirk of the flash convention), ``l`` clamped at 1e-30.  Unlike the
reference's nested scans, the query blocks run side by side: each query
row sees the same KV blocks in the same order, so its arithmetic is the
same.  The int8 KV cache: ``quantize_kv`` (per-(token, head) absmax
scales) and ``decode_attention_quant`` (one token against it, dequantized
block by block under an online softmax, over a block count fixed by the
cache's shape).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# RoPE (partial-fraction capable: glm4 rotates half the head dim).
# ---------------------------------------------------------------------------


def rope_tables(positions: torch.Tensor, head_dim: int, fraction: float,
                theta: float):
    """cos/sin tables [..., rot/2] (f32) for the rotated prefix of the
    head dim, and ``rot``."""
    rot = int(head_dim * fraction)
    rot -= rot % 2
    freqs = theta ** (-torch.arange(0, rot, 2, dtype=torch.float32,
                                    device=positions.device) / rot)
    ang = positions[..., None].float() * freqs               # [..., rot/2]
    return torch.cos(ang), torch.sin(ang), rot


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               rot: int) -> torch.Tensor:
    """x: [B, S, H, hd]; cos/sin: [B, S, rot/2] (broadcast over heads).
    Pairs (2i, 2i + 1) of the first ``rot`` dims rotate; the rest pass."""
    if rot == 0:
        return x
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    c, s = cos[..., None, :], sin[..., None, :]               # head axis
    o1 = x1 * c - x2 * s
    o2 = x2 * c + x1 * s
    # Back to the input dtype before the concat, as the reference does
    # (its bf16 K/Q buffers are rounded there).
    out = torch.stack([o1, o2], dim=-1).reshape(xr.shape).to(x.dtype)
    return torch.cat([out, xp], dim=-1)


def _block_scores(qb: torch.Tensor, kb: torch.Tensor, scale: float,
                  softcap: float) -> torch.Tensor:
    """qb [B, nq, Q, G, R, hd], kb [B, K, G, hd] -> s [B, nq, G, R, Q, K]
    in f32.  bf16 operands are widened exactly (a bf16 product fits in
    f32), so this is the reference's f32-accumulated product."""
    s = torch.einsum("bnqgrd,bkgd->bngrqk", qb.float(), kb.float()) * scale
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    return s


def _mask(qpos: torch.Tensor, kpos: torch.Tensor,
          window: Optional[int]) -> torch.Tensor:
    """bool[..., Q, K]: key ``kpos`` visible from query ``qpos``."""
    ok = kpos[None, :] <= qpos[..., None]
    if window is not None:
        ok &= (qpos[..., None] - kpos[None, :]) < window
    return ok


def blocked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      window: Optional[int] = None,
                      softcap: float = 0.0,
                      query_scale: Optional[float] = None,
                      q_offset: int = 0,
                      block_q: int = 256,
                      block_k: int = 256,
                      skip_masked_blocks: bool = False) -> torch.Tensor:
    """Causal attention.  q: [B, S, H, hd]; k, v: [B, S, G, hd]; returns
    [B, S, H, hd] in q's dtype.  H = G * R (GQA): head h reads KV head
    h // R.  S is padded to the lcm of the blocks; padded keys sit beyond
    every real query, so the causal mask removes them."""
    b, s_orig, h, hd = q.shape
    g = k.shape[2]
    r = h // g
    scale = query_scale if query_scale is not None else 1.0 / math.sqrt(hd)

    blk = block_q * block_k // math.gcd(block_q, block_k)   # lcm
    pad = (-s_orig) % blk
    if pad:
        q, k, v = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad))
                   for t in (q, k, v))
    s = s_orig + pad
    nq, nk = s // block_q, s // block_k

    qb = q.reshape(b, nq, block_q, g, r, hd).float()    # exact widening
    kb = k.reshape(b, nk, block_k, g, hd)
    vb = v.reshape(b, nk, block_k, g, hd)
    q_pos = q_offset + torch.arange(s, device=q.device).reshape(nq, block_q)

    m = torch.full((b, nq, g, r, block_q), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    o = torch.zeros((b, nq, g, r, block_q, hd), dtype=torch.float32,
                    device=q.device)
    for kj in range(nk):
        k_pos = kj * block_k + torch.arange(block_k, device=q.device)
        sblk = _block_scores(qb, kb[:, kj], scale, softcap)
        ok = _mask(q_pos, k_pos, window)                    # [nq, Q, K]
        sblk = torch.where(ok[None, :, None, None], sblk, NEG_INF)
        m_new = torch.maximum(m, sblk.amax(dim=-1))
        p = torch.exp(sblk - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l_new = l * alpha + p.sum(dim=-1)
        pv = torch.einsum("bngrqk,bkgd->bngrqd", p.to(v.dtype).float(),
                          vb[:, kj].float())
        o_new = o * alpha[..., None] + pv
        if skip_masked_blocks:
            # A block is dead for a query block when its first key is
            # after the block's last query, or (window) its last key is
            # out of reach of the block's first query.
            first_q, last_q = q_pos[:, 0], q_pos[:, -1]
            live = kj * block_k <= last_q
            if window is not None:
                live &= (kj * block_k + block_k - 1) > first_q - window
            keep = live[None, :, None, None, None]
            m_new = torch.where(keep, m_new, m)
            l_new = torch.where(keep, l_new, l)
            o_new = torch.where(keep[..., None], o_new, o)
        m, l, o = m_new, l_new, o_new
    out = o / torch.clamp(l, min=1e-30)[..., None]
    # [B, nq, G, R, Q, hd] -> [B, nq, Q, G, R, hd] -> [B, S, H, hd]
    out = out.permute(0, 1, 4, 2, 3, 5).reshape(b, s, h, hd)
    return out[:, :s_orig].to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: int, *,
                     window: Optional[int] = None,
                     softcap: float = 0.0,
                     query_scale: Optional[float] = None,
                     k_positions: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """One-token attention against a cache.

    q: [B, 1, H, hd]; caches: [B, S, G, hd]; ``pos`` the new token's
    position (one for the whole batch: the serving driver runs its slots
    in lockstep).  ``k_positions`` [S] gives the absolute position held
    by each cache slot (rolling-window caches; negative for a slot not
    written yet); defaults to arange(S).  Returns [B, 1, H, hd] in q's
    dtype.  Scores and the PV product accumulate in f32 from the
    operands' own values; p is rounded to q's dtype first.
    """
    b, _, h, hd = q.shape
    s, g = k_cache.shape[1], k_cache.shape[2]
    r = h // g
    scale = query_scale if query_scale is not None else 1.0 / math.sqrt(hd)
    qh = q.reshape(b, 1, g, r, hd)
    sc = torch.einsum("bqgrd,bkgd->bgrqk", qh.float(),
                      k_cache.to(q.dtype).float()) * scale
    if softcap > 0.0:
        sc = softcap * torch.tanh(sc / softcap)
    kpos = (torch.arange(s, device=q.device) if k_positions is None
            else k_positions)
    ok = (kpos <= pos) & (kpos >= 0)                            # [S]
    if window is not None:
        ok &= (pos - kpos) < window
    sc = torch.where(ok, sc, NEG_INF)
    p = torch.softmax(sc, dim=-1)
    out = torch.einsum("bgrqk,bkgd->bgrqd", p.to(q.dtype).float(),
                       v_cache.to(q.dtype).float())
    return out.reshape(b, 1, h, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# int8-quantized KV cache (serving): per-(token, head) absmax scales.
# ---------------------------------------------------------------------------


def quantize_kv(x: torch.Tensor):
    """x: [..., hd] -> (int8 [..., hd], float32 [..., 1] scale); round
    half to even, as the reference."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=1e-6) / 127.0
    q8 = torch.clamp(torch.round(xf / scale), -127, 127)
    return q8.to(torch.int8), scale


def decode_attention_quant(q: torch.Tensor, k8: torch.Tensor,
                           v8: torch.Tensor, ks: torch.Tensor,
                           vs: torch.Tensor, pos: int, *,
                           window: Optional[int] = None,
                           softcap: float = 0.0,
                           query_scale: Optional[float] = None,
                           k_positions: Optional[torch.Tensor] = None,
                           block: int = 2048) -> torch.Tensor:
    """One-token attention over an int8 cache, dequantized block by block
    (k8 * ks and v8 * vs rounded to bfloat16, as the reference) with an
    online softmax, so no full-cache copy is made.  q: [B, 1, H, hd];
    k8, v8: [B, S, G, hd] int8; ks, vs: [B, S, G, 1] float32; ``pos`` and
    ``k_positions`` as in :func:`decode_attention`.  The block count is
    ceil(S / block): fixed by the shapes, no host sync."""
    b, _, h, hd = q.shape
    s, g = k8.shape[1], k8.shape[2]
    r = h // g
    scale = query_scale if query_scale is not None else 1.0 / math.sqrt(hd)
    block = min(block, s)
    nb = -(-s // block)
    pad = nb * block - s
    kpos = (torch.arange(s, device=q.device) if k_positions is None
            else k_positions)
    if pad:
        k8, v8, ks, vs = (torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
                          for x in (k8, v8, ks, vs))
        kpos = torch.nn.functional.pad(kpos, (0, pad), value=-1)
    qh = q.reshape(b, 1, g, r, hd).float()          # exact widening
    bf16 = torch.bfloat16
    m = torch.full((b, g, r, 1), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    o = torch.zeros((b, g, r, 1, hd), dtype=torch.float32, device=q.device)
    for j in range(nb):
        blk = slice(j * block, (j + 1) * block)
        kb = k8[:, blk].to(bf16) * ks[:, blk].to(bf16)     # [B, blk, G, hd]
        sc = torch.einsum("bqgrd,bkgd->bgrqk", qh, kb.float()) * scale
        if softcap > 0.0:
            sc = softcap * torch.tanh(sc / softcap)
        kp = kpos[blk]
        ok = (kp <= pos) & (kp >= 0)
        if window is not None:
            ok &= (pos - kp) < window
        sc = torch.where(ok, sc, NEG_INF)
        m_new = torch.maximum(m, sc.amax(dim=-1))
        p = torch.exp(sc - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        vb = v8[:, blk].to(bf16) * vs[:, blk].to(bf16)
        pv = torch.einsum("bgrqk,bkgd->bgrqd", p.to(bf16).float(),
                          vb.float())
        o = o * alpha[..., None] + pv
        m = m_new
    out = o / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, 1, h, hd).to(q.dtype)

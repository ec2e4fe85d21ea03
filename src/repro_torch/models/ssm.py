"""The Mamba-2 SSD scan (state-space duality, arXiv:2405.21060) and the
mixer's causal depthwise conv in plain PyTorch (counterpart of
``repro.models.ssm``).

``ssd_chunked`` is the plain version of the ``ssd_scan`` kernel
(``kernels/csrc/ssd_scan.cu``): the sequence is cut into chunks of Q;
each chunk's output is a decay-masked quadratic form over the chunk plus
the contribution of the state carried in from the chunks before it.  All
internals run in f32; y comes back in x's dtype.  The projections and
gating of the mixer are ``models.blocks.apply_mamba_layer``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor, c: torch.Tensor, d: torch.Tensor,
                chunk: int, state_in: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD over a full sequence.

    x:  [B, S, H, P]  (bf16 ok)       dt: [B, S, H]   (f32, post-softplus)
    a:  [H]           (f32, negative) b/c: [B, S, G, N] (bf16 ok)
    d:  [H]           (f32 skip gain) state_in: [B, H, N, P] or None
    Returns (y [B, S, H, P] in x's dtype, final state [B, H, N, P] f32).
    Head h reads B/C group h // (H / G).
    """
    B, S_orig, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    rep = H // G
    f32 = torch.float32

    # Zero-pad to the chunk grid; exact: dt = 0 gives decay exp(0) = 1 and
    # a zero state update, C = 0 gives zero output at pad positions.
    pad = (-S_orig) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, 0, 0, pad))
    S = S_orig + pad
    nc = S // chunk

    xc = x.reshape(B, nc, chunk, H, P).to(f32)
    dtc = dt.reshape(B, nc, chunk, H).to(f32)
    bh = b.reshape(B, nc, chunk, G, N).to(f32).repeat_interleave(rep, dim=3)
    ch = c.reshape(B, nc, chunk, G, N).to(f32).repeat_interleave(rep, dim=3)

    da = dtc * a[None, None, None, :]                    # [B,nc,Q,H]
    cum = torch.cumsum(da, dim=2)
    total = cum[:, :, -1:, :]                            # [B,nc,1,H]

    # Intra-chunk (masked quadratic form).  The mask sits INSIDE the
    # exponent: for i < j the difference is positive and can overflow to
    # inf, and inf * 0 would poison the chunk with NaNs.
    ii = torch.arange(chunk, device=x.device)
    mask = ii[:, None] >= ii[None, :]                    # [i, j]
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # [B,nc,i,j,H]
    diff = torch.where(mask[None, None, :, :, None], diff, -torch.inf)
    seg = torch.exp(diff)
    scores = torch.einsum("bcihn,bcjhn->bcijh", ch, bh)  # [B,nc,i,j,H]
    w = scores * seg
    w = w * dtc[:, :, None, :, :]                        # dt_j
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", w, xc)

    # Per-chunk states: S_c = sum_j exp(total - cum_j) dt_j B_j x_j^T.
    decay_to_end = torch.exp(total - cum)                # [B,nc,Q,H]
    sb = bh * (decay_to_end * dtc)[..., None]            # [B,nc,Q,H,N]
    chunk_states = torch.einsum("bcjhn,bcjhp->bchnp", sb, xc)

    # Inter-chunk recurrence: the state before each chunk.
    chunk_decay = torch.exp(total[:, :, 0, :])           # [B,nc,H]
    state = (torch.zeros((B, H, N, P), dtype=f32, device=x.device)
             if state_in is None else state_in.to(f32))
    prevs = []
    for ci in range(nc):
        prevs.append(state)
        state = state * chunk_decay[:, ci, :, None, None] + chunk_states[:, ci]
    prev_states = torch.stack(prevs, dim=1)              # [B,nc,H,N,P]

    y_inter = torch.einsum("bcihn,bchnp->bcihp",
                           ch * torch.exp(cum)[..., None], prev_states)

    y = (y_intra + y_inter).reshape(B, S, H, P)
    y = y + xc.reshape(B, S, H, P) * d[None, None, :, None]
    return y[:, :S_orig].to(x.dtype), state


def ssd_decode_step(state: torch.Tensor, x: torch.Tensor, dt: torch.Tensor,
                    a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                    d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-token SSD update.

    state: [B, H, N, P]; x: [B, H, P]; dt: [B, H]; b/c: [B, G, N].
    Returns (y [B, H, P] in x's dtype, new state).
    """
    B, H = state.shape[:2]
    G, N = b.shape[1], b.shape[2]
    f32 = torch.float32
    xf, dtf = x.to(f32), dt.to(f32)
    # Groups -> heads (head h reads group h // (H / G)) by a broadcast:
    # ``repeat_interleave`` may read its repeat count back from the card.
    bh = b.to(f32)[:, :, None, :].expand(B, G, H // G, N).reshape(B, H, N)
    ch = c.to(f32)[:, :, None, :].expand(B, G, H // G, N).reshape(B, H, N)
    dec = torch.exp(dtf * a[None, :])                    # [B,H]
    upd = (dtf[..., None] * bh)[..., None] * xf[:, :, None, :]   # [B,H,N,P]
    new_state = state * dec[..., None, None] + upd
    y = torch.einsum("bhn,bhnp->bhp", ch, new_state)
    y = y + xf * d[None, :, None]
    return y.to(x.dtype), new_state


# ---------------------------------------------------------------------------
# Causal depthwise conv (the short conv in the mamba2 block).
# ---------------------------------------------------------------------------


def causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: [B, S, C]; w: [K, C] depthwise taps.  Causal (left) padding;
    f32 accumulation, the result in x's dtype."""
    k = w.shape[0]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(k):                                    # K is 4: unrolled
        out = out + xp[:, i:i + x.shape[1], :].float() * w[i].float()
    return out.to(x.dtype)


def causal_conv_step(cache: torch.Tensor, xt: torch.Tensor, w: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cache: [B, K-1, C] (the previous inputs); xt: [B, C].  Returns
    (yt [B, C] in xt's dtype, the new cache [B, K-1, C])."""
    window = torch.cat([cache, xt[:, None, :]], dim=1)        # [B, K, C]
    yt = torch.einsum("bkc,kc->bc", window.float(), w.float())
    return yt.to(xt.dtype), window[:, 1:, :]

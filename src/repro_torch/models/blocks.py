"""Layer blocks of the families the port serves (counterpart of
``repro.models.blocks``): the transformer layer (dense, moe, vlm, audio,
gemma2's local/global pairs, zamba2's shared block; its FFN an MLP or the
MoE of ``models.moe``) and the Mamba-2 layer (ssm and the hybrid
backbone).

Each block runs in one of three modes:
  train / prefill : the full sequence; attention through the
                    ``flash_attention`` kernel and the SSD through the
                    ``ssd_scan`` kernel (each on CUDA tensors; their plain
                    versions on CPU tensors); prefill also returns the
                    block's cache entries;
  decode          : one token against a cache (KV, rolling-window KV,
                    the int8 KV cache with its scales, or SSM state + conv
                    tail), plain PyTorch.  The cache tensors passed in are
                    written in place: the slot's K/V row (and scales), the
                    new state and the new conv tail.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.models import ssm
from repro_torch.models.attention import (apply_rope, decode_attention,
                                          decode_attention_quant,
                                          quantize_kv, rope_tables)
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import (apply_mlp, attn_decls, mlp_decls,
                                       norm_decl, rmsnorm)
from repro_torch.models.moe import moe_decls, moe_ffn
from repro_torch.models.params import ParamDecl

Cache = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Ctx:
    """Per-call context threaded through the blocks.  ``block_q`` /
    ``block_k`` are the blocks of attention's plain version (the CPU);
    the CUDA kernel tiles by itself."""
    cfg: ArchConfig
    mode: str                   # train | prefill | decode
    pos: int = 0                # decode: the new token's position
    block_q: int = 256
    block_k: int = 256
    kv_quant: bool = False      # the int8 KV cache (serving)

    @property
    def decode(self) -> bool:
        return self.mode == "decode"


# ---------------------------------------------------------------------------
# Attention sublayer (dense / moe / vlm / audio / gemma2 / zamba2's shared
# block).
# ---------------------------------------------------------------------------


def attention_sublayer(p: Dict[str, torch.Tensor], h: torch.Tensor,
                       ctx: Ctx, window: Optional[int],
                       cache: Optional[Cache] = None
                       ) -> Tuple[torch.Tensor, Optional[Cache]]:
    """h -> (attn_out, cache).  Cache: {"k", "v"} [B, Sc, G, hd], with
    ``ctx.kv_quant`` int8 and their float32 scales {"ks", "vs"} [B, Sc,
    G, 1]; slot ``pos % Sc`` holds position pos (the rolling layout when
    Sc is less than the sequence)."""
    cfg = ctx.cfg
    b, s, _ = h.shape
    hn, g, hd = cfg.n_heads, cfg.n_kv, cfg.head_dim

    q = h @ p["wq"]
    k = h @ p["wk"]
    v = h @ p["wv"]
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    q = q.reshape(b, s, hn, hd)
    k = k.reshape(b, s, g, hd)
    v = v.reshape(b, s, g, hd)

    if ctx.decode:
        positions = torch.full((b, 1), ctx.pos, dtype=torch.int32,
                               device=h.device)
    else:
        positions = torch.arange(s, device=h.device)[None, :].expand(b, s)
    cos, sin, rot = rope_tables(positions, hd, cfg.rope_fraction,
                                cfg.rope_theta)
    q = apply_rope(q, cos, sin, rot)
    k = apply_rope(k, cos, sin, rot)

    new_cache = None
    if ctx.decode:
        sc = cache["k"].shape[1]
        slot = ctx.pos % sc
        # Rolling layout: slot i holds position pos - ((pos - i) mod Sc).
        # For a full-length cache (pos < Sc) that is i for i <= pos and a
        # negative (masked) value for the slots not written yet.
        idx = torch.arange(sc, device=h.device)
        kpos = ctx.pos - ((ctx.pos - idx) % sc)
        kw = dict(window=window, softcap=cfg.attn_softcap,
                  query_scale=cfg.query_scale, k_positions=kpos)
        if ctx.kv_quant:
            for name, x in (("k", k), ("v", v)):
                x8, xs = quantize_kv(x[:, 0])
                cache[name][:, slot] = x8
                cache[name + "s"][:, slot] = xs
            attn = decode_attention_quant(q, cache["k"], cache["v"],
                                          cache["ks"], cache["vs"],
                                          ctx.pos, **kw)
        else:
            cache["k"][:, slot] = k[:, 0]
            cache["v"][:, slot] = v[:, 0]
            attn = decode_attention(q, cache["k"], cache["v"], ctx.pos,
                                    **kw)
        new_cache = cache
    else:
        attn = _flash.flash_attention(
            q, k, v, window=window, softcap=cfg.attn_softcap,
            query_scale=cfg.query_scale, block_q=min(ctx.block_q, s),
            block_k=min(ctx.block_k, s))
        if ctx.mode == "prefill":
            keep = window if (window is not None and window < s) else s
            new_cache = {"k": k[:, -keep:], "v": v[:, -keep:]}
            if ctx.kv_quant:
                (k8, ks), (v8, vs) = (quantize_kv(new_cache[name])
                                      for name in ("k", "v"))
                new_cache = {"k": k8, "v": v8, "ks": ks, "vs": vs}

    out = attn.reshape(b, s, hn * hd) @ p["wo"]
    return out, new_cache


# ---------------------------------------------------------------------------
# Transformer layer (attention + MLP or MoE): dense, moe, vlm, audio,
# gemma2, zamba2's shared block.
# ---------------------------------------------------------------------------


def _zero_norm(d: int) -> ParamDecl:
    # gemma-style scale is (1 + w): init w = 0.
    return ParamDecl((d,), init="zeros")


def transformer_decls(cfg: ArchConfig, use_moe: bool) -> Dict[str, Any]:
    d = cfg.d_model
    gstyle = cfg.post_norms
    norm = _zero_norm if gstyle else norm_decl
    decls: Dict[str, Any] = {"attn": attn_decls(cfg), "ln1": norm(d),
                             "ln2": norm(d)}
    if gstyle:
        decls["ln1_post"] = _zero_norm(d)
        decls["ln2_post"] = _zero_norm(d)
    if use_moe:
        decls["moe"] = moe_decls(d, cfg.moe)
    else:
        decls["mlp"] = mlp_decls(d, cfg.d_ff, cfg.mlp_gated)
    return decls


def apply_transformer_layer(p: Dict[str, Any], h: torch.Tensor, ctx: Ctx,
                            window: Optional[int],
                            cache: Optional[Cache] = None
                            ) -> Tuple[torch.Tensor, Optional[Cache]]:
    cfg = ctx.cfg
    gstyle = cfg.post_norms
    hn = rmsnorm(h, p["ln1"], cfg.norm_eps, gemma_style=gstyle)
    attn, new_cache = attention_sublayer(p["attn"], hn, ctx, window, cache)
    if gstyle:
        attn = rmsnorm(attn, p["ln1_post"], cfg.norm_eps, gemma_style=True)
    h = h + attn

    hn = rmsnorm(h, p["ln2"], cfg.norm_eps, gemma_style=gstyle)
    if "moe" in p:
        b, s, d = hn.shape
        ff = moe_ffn(hn.reshape(b * s, d), p["moe"], cfg.moe).reshape(b, s, d)
    else:
        ff = apply_mlp(p["mlp"], hn, cfg.mlp_gated)
    if gstyle:
        ff = rmsnorm(ff, p["ln2_post"], cfg.norm_eps, gemma_style=True)
    return h + ff, new_cache


# ---------------------------------------------------------------------------
# Mamba-2 layer (ssm family and the hybrid backbone).
# ---------------------------------------------------------------------------


def mamba_decls(cfg: ArchConfig) -> Dict[str, ParamDecl]:
    s = cfg.ssm
    d, din, gn, hh = cfg.d_model, s.d_inner, s.n_groups * s.d_state, s.n_heads
    conv_dim = din + 2 * gn
    f32 = torch.float32
    return {
        "ln": norm_decl(d),
        "wz": ParamDecl((d, din)),
        "wx": ParamDecl((d, din)),
        "wb": ParamDecl((d, gn)),
        "wc": ParamDecl((d, gn)),
        "wdt": ParamDecl((d, hh)),
        "conv_w": ParamDecl((s.d_conv, conv_dim)),
        "conv_b": ParamDecl((conv_dim,), init="zeros"),
        "dt_bias": ParamDecl((hh,), f32, init="ssm_dt"),
        "a_log": ParamDecl((hh,), f32, init="ssm_a"),
        "d_skip": ParamDecl((hh,), f32, init="ones"),
        "gnorm": ParamDecl((din,), init="ones"),
        "out_proj": ParamDecl((din, d)),
    }


def apply_mamba_layer(p: Dict[str, torch.Tensor], h: torch.Tensor,
                      ctx: Ctx, cache: Optional[Cache] = None
                      ) -> Tuple[torch.Tensor, Optional[Cache]]:
    """cache: {"state": [B, H, N, P] f32, "conv": [B, K-1, conv_dim]}."""
    cfg = ctx.cfg
    s = cfg.ssm
    b, sl, _ = h.shape
    din, gn = s.d_inner, s.n_groups * s.d_state
    hh, pp, nn, gg = s.n_heads, s.head_dim, s.d_state, s.n_groups

    hn = rmsnorm(h, p["ln"], cfg.norm_eps)
    z = hn @ p["wz"]
    xbc_pre = torch.cat([hn @ p["wx"], hn @ p["wb"], hn @ p["wc"]], dim=-1)
    dt_raw = hn @ p["wdt"]
    a = -torch.exp(p["a_log"].float())
    new_cache = None

    if ctx.decode:
        xbc_t, conv_tail = ssm.causal_conv_step(cache["conv"],
                                                xbc_pre[:, 0, :],
                                                p["conv_w"])
        xbc_t = F.silu((xbc_t + p["conv_b"]).float()).to(h.dtype)
        x_t = xbc_t[:, :din].reshape(b, hh, pp)
        b_t = xbc_t[:, din:din + gn].reshape(b, gg, nn)
        c_t = xbc_t[:, din + gn:].reshape(b, gg, nn)
        dt = F.softplus(dt_raw[:, 0, :].float() + p["dt_bias"])
        y_t, state = ssm.ssd_decode_step(cache["state"], x_t, dt, a, b_t,
                                         c_t, p["d_skip"])
        cache["state"].copy_(state)
        cache["conv"].copy_(conv_tail)
        y = y_t.reshape(b, 1, din)
        zg = z[:, :1, :]
        new_cache = cache
    else:
        xbc = ssm.causal_conv(xbc_pre, p["conv_w"])
        xbc = F.silu((xbc + p["conv_b"]).float()).to(h.dtype)
        x = xbc[..., :din].reshape(b, sl, hh, pp)
        bmat = xbc[..., din:din + gn].reshape(b, sl, gg, nn)
        cmat = xbc[..., din + gn:].reshape(b, sl, gg, nn)
        dt = F.softplus(dt_raw.float() + p["dt_bias"])
        y, state = _ssd.ssd_scan(x, dt, a, bmat, cmat, p["d_skip"],
                                 chunk=min(s.chunk, sl))
        y = y.reshape(b, sl, din)
        zg = z
        if ctx.mode == "prefill":
            # The conv tail: the last K-1 *pre-activation* conv inputs.
            new_cache = {"state": state,
                         "conv": xbc_pre[:, -(s.d_conv - 1):, :]}

    y = rmsnorm(y * F.silu(zg.float()).to(zg.dtype), p["gnorm"],
                cfg.norm_eps)
    return h + y @ p["out_proj"], new_cache

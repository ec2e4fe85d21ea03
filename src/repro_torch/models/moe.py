"""Mixture-of-Experts FFN (counterpart of ``repro.models.moe``): top-k
routing and a sort-free capacity dispatch.

  1. router logits in float32 (the router is a float32 parameter in a
     bfloat16 model), an optional tanh softcap, the top k experts and a
     softmax over the selected logits;
  2. *sort-free* slotting: a (token, choice) pair's slot in its expert's
     buffer is the count of earlier pairs that picked the same expert, one
     cumsum over the ``[T*k, E]`` one-hot;
  3. dispatch into ``[E, C, D]`` buffers (capacity C, first come first
     kept, the overflow dropped);
  4. the gated SwiGLU as three batched GEMMs over the expert axis;
  5. combine: each kept pair's result, weighted and summed in float32;
     the shared (always-on) expert added on top.

Every step has a fixed shape: the dispatch uses ``cumsum``, ``gather``
and ``scatter`` only (no ``nonzero``, no boolean-mask indexing, no
``.item()``), so a MoE layer holds no host sync on the card.  The expert
GEMMs are ``torch.bmm`` (the reference's are ``einsum`` outside any Pallas
kernel).  ``moe_ffn`` calls its steps (``route``, ``dispatch``,
``gather_tokens``, ``expert_ffn``, ``combine``) through this module, so a
profiler can wrap each.  ``near_ties`` names the tokens whose routing a
rounding of the router input could change, for checks that compare two
runs' routing.

The reference's expert parallelism (``tp_axis``, ``zero_axes`` and
``_allgather_dim`` under ``shard_map``) is the identity on one device;
the port's LM runs on one device, so it has none of them.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.config import MoEConfig
from repro_torch.models.params import ParamDecl


def moe_decls(d_model: int, cfg: MoEConfig) -> Dict[str, ParamDecl]:
    e, f = cfg.num_experts, cfg.d_ff
    decls = {
        "router": ParamDecl((d_model, e), torch.float32),
        "w1": ParamDecl((e, d_model, f)),
        "w3": ParamDecl((e, d_model, f)),
        "w2": ParamDecl((e, f, d_model)),
    }
    if cfg.shared_expert_ff:
        s = cfg.shared_expert_ff
        decls["ws1"] = ParamDecl((d_model, s))
        decls["ws3"] = ParamDecl((d_model, s))
        decls["ws2"] = ParamDecl((s, d_model))
    return decls


def router_logits(x2d: torch.Tensor, router: torch.Tensor,
                  cfg: MoEConfig) -> torch.Tensor:
    """[T, D] -> the float32 router logits [T, E], softcapped."""
    logits = x2d.float() @ router
    if cfg.router_softcap > 0.0:
        logits = cfg.router_softcap * torch.tanh(logits / cfg.router_softcap)
    return logits


def route(x2d: torch.Tensor, router: torch.Tensor, cfg: MoEConfig
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x2d: [T, D] -> (experts [T, k] int32, weights [T, k] float32).
    Equal logits pick the lower expert id first, as ``jax.lax.top_k``
    does: a stable descending sort, then the first k (``torch.topk``
    promises no order among ties)."""
    logits = router_logits(x2d, router, cfg)
    top_vals, top_idx = torch.sort(logits, dim=-1, descending=True,
                                   stable=True)
    top_vals, top_idx = top_vals[:, :cfg.top_k], top_idx[:, :cfg.top_k]
    return top_idx.to(torch.int32), torch.softmax(top_vals, dim=-1)


def capacity(num_tokens: int, cfg: MoEConfig) -> int:
    c = math.ceil(num_tokens * cfg.top_k * cfg.capacity_factor
                  / cfg.num_experts)
    return max(8, -(-c // 8) * 8)                      # round up to 8


def dispatch(experts: torch.Tensor, num_experts: int, c: int
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """experts [T, k] -> (flat_e [T*k], flat_slot [T*k], keep [T*k]):
    each (token, choice) pair's expert, its slot in the expert's buffer
    (the earlier pairs, token-major, that chose the same expert) and
    whether that slot is within the capacity ``c``."""
    flat_e = experts.reshape(-1).long()
    experts_ids = torch.arange(num_experts, device=experts.device)
    onehot = (flat_e[:, None] == experts_ids).to(torch.int32)   # [T*k, E]
    slot = torch.cumsum(onehot, dim=0, dtype=torch.int32) - onehot
    flat_slot = slot.gather(1, flat_e[:, None])[:, 0].long()
    return flat_e, flat_slot, flat_slot < c


def near_ties(x2d: torch.Tensor, router: torch.Tensor, cfg: MoEConfig,
              bf16: bool) -> torch.Tensor:
    """bool [T]: tokens with a gap between consecutive ranks of the top
    k + 1 router logits (rank j against j + 1, j < k) within the
    threshold: 1e-4 in float32; in bfloat16 the larger of that and the
    bfloat16 resolution of the router input carried to the gap in
    quadrature, four half-spacings (2^-8 relative each) of every input
    element: 2^-6 sqrt(sum_i x_i^2 (r_ia - r_ib)^2) for the experts a, b
    on either side."""
    x = x2d.float()
    logits = router_logits(x2d, router, cfg)
    order = torch.sort(logits, dim=-1, descending=True, stable=True)[1]
    rows = torch.arange(x.shape[0], device=x.device)
    tied = torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
    for j in range(cfg.top_k):
        a, b = order[:, j], order[:, j + 1]
        gap = logits[rows, a] - logits[rows, b]
        thr = torch.full_like(gap, 1e-4)
        if bf16:
            diff = router.float()[:, a] - router.float()[:, b]
            thr = torch.maximum(thr, 2.0 ** -6 * torch.sqrt(
                (x.square() * diff.T.square()).sum(-1)))
        tied |= gap <= thr
    return tied


def gather_tokens(x2d: torch.Tensor, flat_e: torch.Tensor,
                  flat_slot: torch.Tensor, keep: torch.Tensor, e: int,
                  c: int, k: int) -> torch.Tensor:
    """[T, D] tokens into their experts' buffers [E, C, D], first come
    first kept; an empty slot holds zeros."""
    t, d = x2d.shape
    dev = x2d.device
    # buffer[e, s] = the token in slot s of expert e, or t (the zero pad
    # row).  A dropped pair writes the pad column c: several may, and on
    # CUDA the winner of duplicate scatter writes is unspecified; that is
    # harmless only because column c is sliced off.
    tok_of_pair = torch.arange(t * k, device=dev) // k
    write_pos = flat_e * (c + 1) + torch.where(keep, flat_slot, c)
    buf_tok = torch.full((e * (c + 1),), t, dtype=torch.long, device=dev)
    buf_tok.scatter_(0, write_pos, tok_of_pair)
    buf_tok = buf_tok.reshape(e, c + 1)[:, :c]                 # [E, C]
    x_pad = torch.cat([x2d, x2d.new_zeros((1, d))])
    return x_pad.index_select(0, buf_tok.reshape(-1)).reshape(e, c, d)


def expert_ffn(xe: torch.Tensor, params: Dict[str, torch.Tensor]
               ) -> torch.Tensor:
    """The experts' gated SwiGLU on their buffers: [E, C, D] -> [E, C,
    D], three GEMMs batched over E."""
    h1 = torch.bmm(xe, params["w1"])
    h3 = torch.bmm(xe, params["w3"])
    h = F.silu(h1.float()).to(h3.dtype) * h3
    return torch.bmm(h, params["w2"])


def combine(ye: torch.Tensor, flat_e: torch.Tensor, flat_slot: torch.Tensor,
            keep: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Each (token, choice) pair's row of ``ye`` (a dropped pair's is 0),
    weighted and summed over the choices in float32: [T, D]."""
    e, c, d = ye.shape
    t, k = weights.shape
    read_pos = flat_e * c + flat_slot.clamp(0, c - 1)
    y_pairs = ye.reshape(e * c, d).index_select(0, read_pos)
    y_pairs = torch.where(keep[:, None], y_pairs,
                          y_pairs.new_zeros(())).reshape(t, k, d)
    return torch.einsum("tkd,tk->td", y_pairs.float(), weights)


def _shared_expert(x2d: torch.Tensor, params: Dict[str, torch.Tensor]
                   ) -> torch.Tensor:
    hs = (F.silu((x2d @ params["ws1"]).float()).to(x2d.dtype)
          * (x2d @ params["ws3"]))
    return (hs @ params["ws2"]).float()


def moe_ffn(x2d: torch.Tensor, params: Dict[str, torch.Tensor],
            cfg: MoEConfig) -> torch.Tensor:
    """The MoE FFN of [T, D] tokens -> [T, D] in x2d's dtype."""
    t = x2d.shape[0]
    e, k = cfg.num_experts, cfg.top_k
    c = capacity(t, cfg)
    experts, weights = route(x2d, params["router"], cfg)       # [T, k]
    flat_e, flat_slot, keep = dispatch(experts, e, c)
    xe = gather_tokens(x2d, flat_e, flat_slot, keep, e, c, k)
    ye = expert_ffn(xe, params)                                # [E, C, D]
    out = combine(ye, flat_e, flat_slot, keep, weights)
    if cfg.shared_expert_ff:
        out = out + _shared_expert(x2d, params)
    return out.to(x2d.dtype)


def moe_ffn_dense_reference(x2d: torch.Tensor,
                            params: Dict[str, torch.Tensor],
                            cfg: MoEConfig) -> torch.Tensor:
    """Oracle: every expert on every token, mixed by the router's
    weights.  ``moe_ffn`` at a lossless capacity equals it."""
    experts, weights = route(x2d, params["router"], cfg)
    h1 = torch.einsum("td,edf->tef", x2d, params["w1"])
    h3 = torch.einsum("td,edf->tef", x2d, params["w3"])
    h = F.silu(h1.float()).to(h3.dtype) * h3
    y = torch.einsum("tef,efd->ted", h, params["w2"])          # [T, E, D]
    t = x2d.shape[0]
    rows = torch.arange(t, device=x2d.device)
    out = torch.zeros((t, x2d.shape[1]), dtype=torch.float32,
                      device=x2d.device)
    for j in range(cfg.top_k):
        sel = y[rows, experts[:, j].long()]                    # [T, D]
        out = out + weights[:, j:j + 1] * sel.float()
    if cfg.shared_expert_ff:
        out = out + _shared_expert(x2d, params)
    return out.to(x2d.dtype)

"""Shared primitive layers: RMSNorm, the gated and plain MLP, and the
attention / MLP / norm declarations (counterpart of
``repro.models.layers``).

Weights keep the reference's ``[in, out]`` layout, so a layer is
``x @ w``.  Norm statistics are f32; activations come back in the
input's dtype, as in the reference.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.models.config import ArchConfig
from repro_torch.models.params import ParamDecl


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float,
            gemma_style: bool = False) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    norm = xf * torch.rsqrt(var + eps)
    scale = (1.0 + w.float()) if gemma_style else w.float()
    return (norm * scale).to(x.dtype)


def mlp_decls(d_model: int, d_ff: int, gated: bool) -> Dict[str, ParamDecl]:
    if gated:
        return {"w1": ParamDecl((d_model, d_ff)),
                "w3": ParamDecl((d_model, d_ff)),
                "w2": ParamDecl((d_ff, d_model))}
    return {"w1": ParamDecl((d_model, d_ff)),
            "w2": ParamDecl((d_ff, d_model))}


def apply_mlp(p: Dict[str, torch.Tensor], x: torch.Tensor,
              gated: bool) -> torch.Tensor:
    """SwiGLU when ``gated``, else GELU (``jax.nn.gelu``'s default, the
    tanh approximation); the activation in f32."""
    if gated:
        h = F.silu((x @ p["w1"]).float()).to(x.dtype) * (x @ p["w3"])
    else:
        h = F.gelu((x @ p["w1"]).float(), approximate="tanh").to(x.dtype)
    return h @ p["w2"]


def attn_decls(cfg: ArchConfig) -> Dict[str, ParamDecl]:
    d, h, g, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim
    decls = {"wq": ParamDecl((d, h * hd)), "wk": ParamDecl((d, g * hd)),
             "wv": ParamDecl((d, g * hd)), "wo": ParamDecl((h * hd, d))}
    if cfg.qkv_bias:
        decls["bq"] = ParamDecl((h * hd,), init="zeros")
        decls["bk"] = ParamDecl((g * hd,), init="zeros")
        decls["bv"] = ParamDecl((g * hd,), init="zeros")
    return decls


def norm_decl(d: int) -> ParamDecl:
    return ParamDecl((d,), init="ones")

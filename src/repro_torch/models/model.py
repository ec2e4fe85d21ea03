"""Model assembly: parameters, forward, prefill and decode (counterpart of
``repro.models.model``) for every family: dense, moe, vlm, audio, ssm
and hybrid.

The reference scans over *layer groups* with stacked parameters; here the
groups are a Python loop over a list, one parameter dict per group:

  dense/moe/vlm/audio group = {"blk": layer}                 n_groups = L
  gemma2             group = {"sub0": local, "sub1": global} L / 2
  ssm                group = {"blk": mamba}                  L
  hybrid (zamba2)    group = {"mamba": [P mamba layers]}, and one shared
                     transformer block (``params["shared"]``) applied
                     before each group, each application with its own KV
                     cache.

Parameters are a tree of dicts and lists of tensors, weights in the
reference's ``[in, out]`` layout (``repro_torch.convert.lm_params``
carries the reference's parameters across).  The cache keeps the
reference's layout, each leaf stacked over the groups (``[n_groups, B,
...]``; the hybrid's mamba leaves ``[n_groups, hybrid_period, B, ...]``),
and a decode step writes it in place.  Sliding-window sites allocate
min(S, window) slots (the rolling layout); the int8 KV cache (``quant``)
holds int8 k / v and their float32 per-(token, head) scales ks / vs at
every KV site.

The audio family (musicgen) takes tokens [B, S, CB]: the codebooks'
embeddings summed, and one head per codebook (logits [B, S, CB, V]).
The vlm family (internvl2) takes ``vision`` [B, V, D] embeddings at
prefill and in training, in place of the first V positions; decode takes
none.

Train mode runs each group under the configuration's ``remat`` policy
(``_remat``): ``"full"`` keeps only the group's input and recomputes the
group in the backward, ``"dots"`` keeps the outputs of the 2-D matrix
products (``aten.mm``) and recomputes the rest, ``"none"`` keeps
everything.  ``loss_fn`` is the causal LM's cross entropy (``xent``) over
the reference's batch dict.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.core.api import tree_map
from repro_torch.models import blocks
from repro_torch.models.blocks import Ctx
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import norm_decl, rmsnorm
from repro_torch.models.params import ParamDecl, abstract_params, init_params

PyTree = Any

#: The families the port runs: all of the reference's.
FAMILIES = ("dense", "moe", "vlm", "audio", "ssm", "hybrid")


def check_family(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` for a family the port does not run."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not one the port "
            f"runs ({', '.join(FAMILIES)})")


# ---------------------------------------------------------------------------
# Parameter declarations.
# ---------------------------------------------------------------------------


def n_groups(cfg: ArchConfig) -> int:
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.hybrid_period
    if cfg.local_global_period == 2:
        return cfg.n_layers // 2
    return cfg.n_layers


def group_decls(cfg: ArchConfig) -> Dict[str, Any]:
    """One group's declarations."""
    if cfg.family == "ssm":
        return {"blk": blocks.mamba_decls(cfg)}
    if cfg.family == "hybrid":
        return {"mamba": [blocks.mamba_decls(cfg)
                          for _ in range(cfg.hybrid_period)]}
    use_moe = cfg.moe is not None
    if cfg.local_global_period == 2:
        return {"sub0": blocks.transformer_decls(cfg, use_moe),
                "sub1": blocks.transformer_decls(cfg, use_moe)}
    return {"blk": blocks.transformer_decls(cfg, use_moe)}


def param_decls(cfg: ArchConfig) -> Dict[str, Any]:
    check_family(cfg)
    d = cfg.d_model
    decls: Dict[str, Any] = {}
    if cfg.n_codebooks:
        decls["embed"] = ParamDecl((cfg.n_codebooks, cfg.vocab, d))
        decls["out_heads"] = ParamDecl((cfg.n_codebooks, d, cfg.vocab))
    else:
        decls["embed"] = ParamDecl((cfg.vocab, d))
        if not cfg.tie_embeddings:
            decls["lm_head"] = ParamDecl((d, cfg.vocab))
    decls["final_norm"] = (ParamDecl((d,), init="zeros") if cfg.post_norms
                           else norm_decl(d))
    decls["layers"] = [group_decls(cfg) for _ in range(n_groups(cfg))]
    if cfg.family == "hybrid":
        decls["shared"] = blocks.transformer_decls(cfg, use_moe=False)
    return decls


def init(cfg: ArchConfig, gen: torch.Generator, device) -> PyTree:
    """Random parameters on ``device`` from ``gen`` (the reference's init
    laws, PyTorch's random streams)."""
    return init_params(param_decls(cfg), gen, device)


def abstract(cfg: ArchConfig) -> PyTree:
    """The parameters' stand-ins on ``meta`` (the dry run's)."""
    return abstract_params(param_decls(cfg))


# ---------------------------------------------------------------------------
# Forward.
# ---------------------------------------------------------------------------


def _embed(cfg: ArchConfig, params: PyTree, tokens: torch.Tensor,
           vision: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token embeddings [B, S, D]: audio's [B, S, CB] tokens summed over
    the codebooks in order from a bfloat16 zero (the reference's, so a
    float32 model promotes as its does); ``vision`` [B, V, D] (vlm,
    prefill) in place of the first V positions, before the scale."""
    if cfg.n_codebooks:
        h = torch.zeros(tokens.shape[:2] + (cfg.d_model,),
                        dtype=torch.bfloat16, device=tokens.device)
        for cb in range(cfg.n_codebooks):
            h = h + F.embedding(tokens[..., cb], params["embed"][cb])
    else:
        h = F.embedding(tokens, params["embed"])
    if cfg.vision_tokens and vision is not None:
        v = vision.to(h.dtype)
        h = torch.cat([v, h[:, v.shape[1]:, :]], dim=1)
    if cfg.embed_scale:
        # The scale in the activations' dtype first, as the reference's.
        h = h * torch.full((), math.sqrt(cfg.d_model), dtype=h.dtype,
                           device=h.device)
    return h


def _group(cfg: ArchConfig, ctx: Ctx, shared: Optional[PyTree],
           gp: PyTree, h: torch.Tensor, gcache: Optional[PyTree]
           ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One group: h -> (h, the group's cache entries)."""
    def site(name):
        return None if gcache is None else gcache[name]

    if cfg.family == "ssm":
        h, nc = blocks.apply_mamba_layer(gp["blk"], h, ctx, site("blk"))
        return h, {"blk": nc}
    if cfg.family == "hybrid":
        h, nc = blocks.apply_transformer_layer(shared, h, ctx, None,
                                               site("shared"))
        mcaches = []
        for j, lp in enumerate(gp["mamba"]):
            lc = None if gcache is None else tree_map(
                lambda buf: buf[j], gcache["mamba"])
            h, mc = blocks.apply_mamba_layer(lp, h, ctx, lc)
            mcaches.append(mc)
        return h, {"shared": nc, "mamba": mcaches}
    if cfg.local_global_period == 2:
        h, nc0 = blocks.apply_transformer_layer(gp["sub0"], h, ctx,
                                                cfg.window, site("sub0"))
        h, nc1 = blocks.apply_transformer_layer(gp["sub1"], h, ctx, None,
                                                site("sub1"))
        return h, {"sub0": nc0, "sub1": nc1}
    h, nc = blocks.apply_transformer_layer(gp["blk"], h, ctx, cfg.window,
                                           site("blk"))
    return h, {"blk": nc}


def _stack(items: List[Any]) -> Any:
    """Trees of one structure stacked leaf by leaf; a list inside a tree
    (the hybrid's mamba layers) is stacked first."""
    first = items[0]
    if isinstance(first, dict):
        return {k: _stack([it[k] for it in items]) for k in first}
    if isinstance(first, list):
        return _stack([_stack(it) for it in items])
    return torch.stack(items)


def _save_mm(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """``"dots"``: keep the 2-D matrix products' outputs (the reference's
    ``checkpoint_dots_with_no_batch_dims``; a batched product is
    ``aten.bmm``), recompute everything else."""
    return (CheckpointPolicy.MUST_SAVE if op is torch.ops.aten.mm.default
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(cfg: ArchConfig, group, h: torch.Tensor) -> torch.Tensor:
    """``group(h)`` under ``cfg.remat`` (the reference's ``_remat_wrap``).
    The forward draws no random numbers, so no RNG state is kept."""
    if cfg.remat == "none":
        return group(h)
    if cfg.remat == "dots":
        return checkpoint(group, h, use_reentrant=False,
                          preserve_rng_state=False,
                          context_fn=functools.partial(
                              create_selective_checkpoint_contexts,
                              _save_mm))
    if cfg.remat == "full":
        return checkpoint(group, h, use_reentrant=False,
                          preserve_rng_state=False)
    raise ValueError(f"{cfg.name}: unknown remat policy {cfg.remat!r}")


def run_layers(cfg: ArchConfig, params: PyTree, h: torch.Tensor, ctx: Ctx,
               cache: Optional[PyTree] = None
               ) -> Tuple[torch.Tensor, Optional[PyTree]]:
    """The groups in turn.  Prefill returns the new cache (stacked over
    groups); decode writes ``cache`` in place and returns it; train
    returns no cache and runs each group under ``cfg.remat``."""
    shared = params.get("shared")
    if ctx.mode == "train":
        for gp in params["layers"]:
            h = _remat(cfg, lambda x, gp=gp: _group(cfg, ctx, shared, gp,
                                                    x, None)[0], h)
        return h, None
    caches = []
    for i, gp in enumerate(params["layers"]):
        gcache = None if cache is None else tree_map(lambda buf: buf[i],
                                                     cache)
        h, nc = _group(cfg, ctx, shared, gp, h, gcache)
        caches.append(nc)
    if ctx.decode:
        return h, cache
    return h, _stack(caches)


def logits_fn(cfg: ArchConfig, params: PyTree,
              h: torch.Tensor) -> torch.Tensor:
    hn = rmsnorm(h, params["final_norm"], cfg.norm_eps,
                 gemma_style=cfg.post_norms)
    if cfg.n_codebooks:
        logits = torch.einsum("bsd,cdv->bscv", hn, params["out_heads"])
    elif cfg.tie_embeddings:
        logits = hn @ params["embed"].T
    else:
        logits = hn @ params["lm_head"]
    if cfg.final_softcap > 0.0:
        logits = (cfg.final_softcap
                  * torch.tanh(logits.float() / cfg.final_softcap)
                  ).to(logits.dtype)
    return logits


def make_ctx(cfg: ArchConfig, mode: str, pos: int = 0,
             block_q: int = 256, block_k: int = 256,
             kv_quant: bool = False) -> Ctx:
    check_family(cfg)
    return Ctx(cfg=cfg, mode=mode, pos=pos, block_q=block_q,
               block_k=block_k, kv_quant=kv_quant)


def forward(cfg: ArchConfig, params: PyTree, tokens: torch.Tensor,
            ctx: Ctx, vision: Optional[torch.Tensor] = None
            ) -> torch.Tensor:
    """Logits [B, S, V] (audio: [B, S, CB, V]) of every position."""
    h = _embed(cfg, params, tokens, vision)
    h, _ = run_layers(cfg, params, h, ctx)
    return logits_fn(cfg, params, h)


# ---------------------------------------------------------------------------
# Loss (causal LM; the data pipeline gives the labels shifted).
# ---------------------------------------------------------------------------


def xent(logits: torch.Tensor, labels: torch.Tensor,
         vocab: int) -> torch.Tensor:
    """The mean cross entropy of ``logits`` [..., V] against ``labels``
    [...], in float32: the log-sum-exp around the max, the max held
    constant in the gradient (the reference's ``stop_gradient``).  The
    label's logit is gathered where the reference sums a one-hot product;
    the value is the same.  ``vocab`` is V, kept for the reference's
    signature."""
    lf = logits.float()
    m = lf.amax(dim=-1, keepdim=True).detach()
    lse = torch.log(torch.exp(lf - m).sum(dim=-1)) + m[..., 0]
    ll = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    return (lse - ll).mean()


def loss_fn(cfg: ArchConfig, params: PyTree,
            batch: Dict[str, torch.Tensor], ctx: Ctx) -> torch.Tensor:
    """The loss of one batch (the reference's dict: ``tokens``,
    ``labels`` and, for vlm, ``vision``)."""
    logits = forward(cfg, params, batch["tokens"], ctx, batch.get("vision"))
    return xent(logits, batch["labels"], cfg.vocab)


# ---------------------------------------------------------------------------
# Serving: cache construction, prefill, decode.
# ---------------------------------------------------------------------------


def _kv_site(cfg: ArchConfig, g: int, batch: int, seq: int,
             window: Optional[int], dtype, quant: bool) -> Dict[str, Tuple]:
    keep = min(seq, window) if window else seq
    lead = (g, batch, keep, cfg.n_kv)
    if quant:
        kv = (lead + (cfg.head_dim,), torch.int8)
        scale = (lead + (1,), torch.float32)
        return {"k": kv, "v": kv, "ks": scale, "vs": scale}
    kv = (lead + (cfg.head_dim,), dtype)
    return {"k": kv, "v": kv}


def cache_struct(cfg: ArchConfig, batch: int, seq: int,
                 dtype=torch.bfloat16, quant: bool = False) -> PyTree:
    """(shape, dtype) of each cache leaf (leading dim: the groups), as
    the reference's ``cache_struct``.  ``quant``: every KV site int8 with
    float32 per-(token, head) scales ``ks`` / ``vs``."""
    check_family(cfg)
    g = n_groups(cfg)
    if cfg.family in ("ssm", "hybrid"):
        s = cfg.ssm
        conv_dim = s.d_inner + 2 * s.n_groups * s.d_state
        lead = (g,) if cfg.family == "ssm" else (g, cfg.hybrid_period)
        mamba = {"state": (lead + (batch, s.n_heads, s.d_state,
                                   s.head_dim), torch.float32),
                 "conv": (lead + (batch, s.d_conv - 1, conv_dim), dtype)}
        if cfg.family == "ssm":
            return {"blk": mamba}
        return {"shared": _kv_site(cfg, g, batch, seq, None, dtype, quant),
                "mamba": mamba}
    if cfg.local_global_period == 2:
        return {"sub0": _kv_site(cfg, g, batch, seq, cfg.window, dtype,
                                 quant),
                "sub1": _kv_site(cfg, g, batch, seq, None, dtype, quant)}
    return {"blk": _kv_site(cfg, g, batch, seq, cfg.window, dtype, quant)}


def cache_init(cfg: ArchConfig, batch: int, seq: int,
               dtype=torch.bfloat16, device="cpu",
               quant: bool = False) -> PyTree:
    struct = cache_struct(cfg, batch, seq, dtype, quant)
    return {site: {name: torch.zeros(shape, dtype=dt, device=device)
                   for name, (shape, dt) in leaves.items()}
            for site, leaves in struct.items()}


def cache_abstract(cfg: ArchConfig, batch: int, seq: int,
                   dtype=torch.bfloat16, quant: bool = False) -> PyTree:
    """``cache_init``'s stand-ins on ``meta`` (the dry run's cache)."""
    return cache_init(cfg, batch, seq, dtype, "meta", quant)


def batch_axis(cfg: ArchConfig, site: str) -> int:
    """The batch axis of a cache site's leaves: after the group axis, and
    for the hybrid's mamba layers after the layer axis too."""
    return 2 if (cfg.family == "hybrid" and site == "mamba") else 1


def pad_cache(cfg: ArchConfig, cache: PyTree, max_seq: int) -> PyTree:
    """Grow a prefill cache to ``max_seq`` serving slots: KV sites pad
    the sequence axis (axis 2 of [g, B, S, G, hd], and of the int8
    cache's scales [g, B, S, G, 1]) with zeros up to
    min(max_seq, the site's window); the rolling position formula masks
    the new slots until the stream reaches them.  SSM state and conv
    tails do not depend on the length and pass through."""
    windows = {"blk": cfg.window, "sub0": cfg.window, "sub1": None,
               "shared": None}
    out = {}
    for site, leaves in cache.items():
        if site == "mamba" or cfg.family == "ssm":
            out[site] = leaves
            continue
        window = windows[site]
        target = min(max_seq, window) if window else max_seq
        out[site] = {name: F.pad(kv, (0, 0, 0, 0, 0, max(
            target - kv.shape[2], 0))) for name, kv in leaves.items()}
    return out


def prefill(cfg: ArchConfig, params: PyTree, tokens: torch.Tensor,
            ctx: Ctx, vision: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, PyTree]:
    """tokens [B, S] (audio: [B, S, CB]) and, for vlm, ``vision`` [B, V,
    D] -> (last position's logits [B, V] (audio: [B, CB, V]), cache)."""
    h = _embed(cfg, params, tokens, vision)
    h, cache = run_layers(cfg, params, h, ctx)
    logits = logits_fn(cfg, params, h[:, -1:, :])
    return logits[:, 0], cache


def decode_step(cfg: ArchConfig, params: PyTree, cache: PyTree,
                tokens: torch.Tensor, ctx: Ctx
                ) -> Tuple[torch.Tensor, PyTree]:
    """One decode step at position ``ctx.pos``: tokens [B, 1] (audio:
    [B, 1, CB]) -> (logits [B, V] (audio: [B, CB, V]), cache), the cache
    written in place."""
    h = _embed(cfg, params, tokens)
    h, cache = run_layers(cfg, params, h, ctx, cache=cache)
    return logits_fn(cfg, params, h)[:, 0], cache

"""Serving steps (counterpart of ``repro.serve.engine``): prefill and
decode factories and greedy sampling, as plain callables on one device.

The reference's steps are jit-able with explicit shardings; the port's
run eagerly on the device of the parameters.  A prefill launches the
``flash_attention`` kernel at every attention site and the ``ssd_scan``
kernel at every mamba layer (their plain versions on the CPU); a decode
step launches neither and holds no host sync, so the serving driver's one
read of the sampled tokens per tick is the only wait.  ``kv_quant`` runs
the int8 KV cache (``models.attention.quantize_kv`` /
``decode_attention_quant``); ``auto_kv_quant`` decides it from the cache's
size against a device's memory.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch.models import model as M
from repro_torch.models.config import ArchConfig

PyTree = Any


def make_prefill_step(cfg: ArchConfig, block_q: int = 256,
                      block_k: int = 256, kv_quant: bool = False
                      ) -> Callable[..., Tuple[torch.Tensor, PyTree]]:
    """``step(params, tokens [B, S], vision=None) -> (last logits [B, V],
    cache)`` (audio: tokens [B, S, CB], logits [B, CB, V]; vlm: ``vision``
    [B, V, D] in place of the first V positions).  ``block_q`` /
    ``block_k`` are the blocks of attention's plain version (the CPU);
    the CUDA kernel tiles by itself."""
    M.check_family(cfg)

    def step(params: PyTree, tokens: torch.Tensor,
             vision: Optional[torch.Tensor] = None):
        ctx = M.make_ctx(cfg, "prefill", block_q=block_q, block_k=block_k,
                         kv_quant=kv_quant)
        return M.prefill(cfg, params, tokens, ctx, vision)

    return step


def make_decode_step(cfg: ArchConfig, kv_quant: bool = False
                     ) -> Callable[..., Tuple[torch.Tensor, PyTree]]:
    """``step(params, cache, tokens [B, 1], pos) -> (logits [B, V],
    cache)`` at position ``pos`` (an int), the cache written in place
    (audio: tokens [B, 1, CB], logits [B, CB, V])."""
    M.check_family(cfg)

    def step(params: PyTree, cache: PyTree, tokens: torch.Tensor,
             pos: int):
        ctx = M.make_ctx(cfg, "decode", pos=pos, kv_quant=kv_quant)
        return M.decode_step(cfg, params, cache, tokens, ctx)

    return step


def auto_kv_quant(cfg: ArchConfig, global_batch: int, seq_len: int,
                  n_devices: int, memory_bytes: int) -> bool:
    """The int8 KV cache when the bf16 cache, split over ``n_devices``,
    would take more than 40% of one device's ``memory_bytes`` (the
    reference's rule, whose memory is a constant of its chip; here the
    caller passes the device's: on the card its ``total_memory``)."""
    if cfg.family == "ssm":
        return False
    keep = min(seq_len, cfg.window) if cfg.window else seq_len
    site_count = cfg.n_layers if cfg.family != "hybrid" \
        else cfg.n_layers // cfg.hybrid_period
    total = 2 * site_count * keep * cfg.n_kv * cfg.head_dim * 2 \
        * global_batch
    return total / n_devices > 0.4 * memory_bytes


def greedy_sample(logits: torch.Tensor) -> torch.Tensor:
    """The first index of the largest logit along the last axis, as int32
    (``jnp.argmax``'s tie-break); audio's [B, CB, V] gives [B, CB]."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def decode_tokens_abstract(cfg: ArchConfig, batch: int) -> torch.Tensor:
    """A decode step's tokens' stand-in on ``meta`` (the dry run's)."""
    shape = (batch, 1, cfg.n_codebooks) if cfg.n_codebooks else (batch, 1)
    return torch.empty(shape, dtype=torch.int32, device="meta")

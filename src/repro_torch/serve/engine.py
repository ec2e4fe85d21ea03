"""Serving steps (counterpart of ``repro.serve.engine``): prefill and
decode factories and greedy sampling, as plain callables on one device.

The reference's steps are jit-able with explicit shardings; the port's
run eagerly on the device of the parameters.  A prefill launches the
``flash_attention`` kernel at every attention site and the ``ssd_scan``
kernel at every mamba layer (their plain versions on the CPU); a decode
step launches neither and holds no host sync, so the serving driver's one
read of the sampled tokens per tick is the only wait.  The int8 KV cache
(``kv_quant``) is not ported yet.
"""

from __future__ import annotations

from typing import Any, Callable, Tuple

import torch

from repro_torch.models import model as M
from repro_torch.models.config import ArchConfig

PyTree = Any


def refuse_kv_quant(kv_quant: bool) -> None:
    if kv_quant:
        raise NotImplementedError(
            "the int8 KV cache (kv_quant) is not ported yet (ROADMAP Queue "
            "1 item 11)")


def make_prefill_step(cfg: ArchConfig, block_q: int = 256,
                      block_k: int = 256, kv_quant: bool = False
                      ) -> Callable[[PyTree, torch.Tensor],
                                    Tuple[torch.Tensor, PyTree]]:
    """``step(params, tokens [B, S]) -> (last logits [B, V], cache)``.
    ``block_q`` / ``block_k`` are the blocks of attention's plain version
    (the CPU); the CUDA kernel tiles by itself."""
    refuse_kv_quant(kv_quant)
    M.check_family(cfg)

    def step(params: PyTree, tokens: torch.Tensor):
        ctx = M.make_ctx(cfg, "prefill", block_q=block_q, block_k=block_k)
        return M.prefill(cfg, params, tokens, ctx)

    return step


def make_decode_step(cfg: ArchConfig, kv_quant: bool = False
                     ) -> Callable[..., Tuple[torch.Tensor, PyTree]]:
    """``step(params, cache, tokens [B, 1], pos) -> (logits [B, V],
    cache)`` at position ``pos`` (an int), the cache written in place."""
    refuse_kv_quant(kv_quant)
    M.check_family(cfg)

    def step(params: PyTree, cache: PyTree, tokens: torch.Tensor,
             pos: int):
        ctx = M.make_ctx(cfg, "decode", pos=pos)
        return M.decode_step(cfg, params, cache, tokens, ctx)

    return step


def greedy_sample(logits: torch.Tensor) -> torch.Tensor:
    """The first index of the largest logit, as int32 (``jnp.argmax``'s
    tie-break)."""
    return torch.argmax(logits, dim=-1).to(torch.int32)

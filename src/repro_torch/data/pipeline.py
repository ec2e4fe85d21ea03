"""Deterministic synthetic token pipeline (counterpart of
``repro.data.pipeline``).

A batch is a pure function of ``(seed, step)``: a restarted job resumes
mid-run with the same batches, so no iterator state is checkpointed.  The
draw and the rules are split: ``draws`` takes the random numbers from a
``torch.Generator`` of the device seeded by ``(seed, step)``, and
``batch_from_draws`` turns them into the batch by the reference's
arithmetic:

* tokens ``(u**4 * (vocab - 3))`` truncated, plus 2: a Zipf-ish law on
  ``[2, vocab - 1)`` (``u**4`` as two squarings, the reference's integer
  power);
* on even positions a copy of the token 4 back (``roll`` by 4 along the
  sequence), so a model can beat the unigram entropy;
* ``tokens`` and ``labels`` the sequence of ``seq + 1`` shifted by one;
  audio's are ``[B, S, CB]``;
* vlm's ``vision`` embeddings, the normals in bfloat16 times 0.02.

The bits cannot be the reference's (it draws with threefry); the rules
are.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.models.config import ArchConfig


def batch_seed(seed: int, step: int) -> int:
    """The generator seed of ``(seed, step)``: one 64-bit integer."""
    if not (0 <= seed < 2 ** 31 and 0 <= step < 2 ** 32):
        raise ValueError(f"seed {seed} or step {step} out of range "
                         f"(0 <= seed < 2**31, 0 <= step < 2**32)")
    return seed << 32 | step


def draws(cfg: ArchConfig, batch: int, seq: int, seed: int, step: int,
          device) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The uniforms of the tokens ([B, S + 1], audio [B, S + 1, CB]) and,
    for vlm, the normals of the vision embeddings ([B, V, D]), float32 on
    ``device`` from a generator seeded by ``(seed, step)``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(batch_seed(seed, step))
    shape = ((batch, seq + 1, cfg.n_codebooks) if cfg.n_codebooks
             else (batch, seq + 1))
    u = torch.rand(shape, generator=gen, device=device)
    z = (torch.randn((batch, cfg.vision_tokens, cfg.d_model), generator=gen,
                     device=device) if cfg.vision_tokens else None)
    return u, z


def batch_from_draws(cfg: ArchConfig, u: torch.Tensor,
                     z: Optional[torch.Tensor] = None
                     ) -> Dict[str, torch.Tensor]:
    """The batch of ``draws``' numbers, by the reference's rules."""
    u2 = u * u
    raw = (u2 * u2 * (cfg.vocab - 3)).to(torch.int32) + 2
    lag = torch.roll(raw, 4, dims=1)
    even = torch.arange(u.shape[1], device=u.device) % 2 == 0
    even = even[None, :, None] if cfg.n_codebooks else even[None, :]
    toks = torch.where(even, lag, raw)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.vision_tokens:
        # The scale in bfloat16 first, as the reference's weak-typed 0.02.
        out["vision"] = z.to(torch.bfloat16) * torch.full(
            (), 0.02, dtype=torch.bfloat16, device=z.device)
    return out


def synthetic_batch(cfg: ArchConfig, batch: int, seq: int, seed: int,
                    step: int, device="cpu") -> Dict[str, torch.Tensor]:
    """One training batch (``tokens``, ``labels`` [B, S] int32, audio
    [B, S, CB]; vlm also ``vision`` [B, V, D] bfloat16) on ``device``."""
    return batch_from_draws(cfg, *draws(cfg, batch, seq, seed, step, device))


def input_abstract(cfg: ArchConfig, batch: int, seq: int
                   ) -> Dict[str, torch.Tensor]:
    """``synthetic_batch``'s stand-ins on ``meta`` (the dry run's)."""
    shape = ((batch, seq, cfg.n_codebooks) if cfg.n_codebooks
             else (batch, seq))
    out = {k: torch.empty(shape, dtype=torch.int32, device="meta")
           for k in ("tokens", "labels")}
    if cfg.vision_tokens:
        out["vision"] = torch.empty((batch, cfg.vision_tokens, cfg.d_model),
                                    dtype=torch.bfloat16, device="meta")
    return out

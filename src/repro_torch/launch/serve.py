"""Serving launcher of the port (counterpart of ``repro.launch.serve``):
a batched prefill, then greedy decode.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b \\
      --batch 4 --prompt-len 1024 --gen 32 [--device cpu] [--smoke]

Runs the prefill and decode steps of ``repro_torch.serve.engine`` with
parameters from the port's init (a generator seeded 0) and prompts from a
seeded numpy generator, and prints the reference's lines: the prefill's
seconds, the decoded tokens per second and a sample.  ``--device cuda``
(the default; fails without a card) runs the prefill's attention and SSD
on the CUDA kernels, built before the clock starts; ``--device cpu`` runs
their plain versions.  Every family serves: an audio model's prompts are
[B, P, CB] codes, a vlm model's prefill takes ``vision_tokens`` random
embeddings (a generator of the device seeded 7, times 0.02, bfloat16, as
the reference's stub); ``--kv-quant`` runs the int8 KV cache.
"""

from __future__ import annotations

import argparse
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core.api import resolve_device
from repro_torch.kernels import _build
from repro_torch.models import model as M
from repro_torch.models.config import ArchConfig
from repro_torch.serve.engine import (greedy_sample, make_decode_step,
                                      make_prefill_step)


def _clock(device: torch.device) -> float:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def inputs(cfg: ArchConfig, batch: int, prompt_len: int, device
           ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The launcher's prompts ([B, P] ids, audio [B, P, CB]; a numpy
    generator seeded 7) and, for vlm, its ``vision_tokens`` embeddings."""
    shape = ((batch, prompt_len, cfg.n_codebooks) if cfg.n_codebooks
             else (batch, prompt_len))
    prompts = torch.from_numpy(np.random.RandomState(7).randint(
        0, cfg.vocab, shape).astype(np.int32)).to(device)
    vision = None
    if cfg.vision_tokens:
        vgen = torch.Generator(device=device)
        vgen.manual_seed(7)
        vision = (torch.randn((batch, cfg.vision_tokens, cfg.d_model),
                              generator=vgen, device=device)
                  .to(torch.bfloat16) * 0.02)
    return prompts, vision


def serve(cfg: ArchConfig, params, prompts: torch.Tensor, gen: int,
          vision: Optional[torch.Tensor] = None, kv_quant: bool = False
          ) -> Dict[str, Any]:
    """The launcher's path: one batched prefill of ``prompts``, then
    ``gen`` greedy decode steps.  The prefill's and the decode steps'
    seconds (between synchronizes on the card) and the tokens [B, gen]
    (audio [B, gen, CB]) on the host."""
    device = prompts.device
    batch, prompt_len = prompts.shape[:2]
    prefill = make_prefill_step(cfg, block_q=32, block_k=32,
                                kv_quant=kv_quant)
    decode = make_decode_step(cfg, kv_quant=kv_quant)
    t0 = _clock(device)
    logits, cache = prefill(params, prompts, vision)
    cache = M.pad_cache(cfg, cache, prompt_len + gen)
    prefill_s = _clock(device) - t0
    tok = greedy_sample(logits)[:, None]       # [B, 1] (audio [B, 1, CB])
    outs = []
    t0 = _clock(device)
    for i in range(gen):
        logits, cache = decode(params, cache, tok, prompt_len + i)
        tok = greedy_sample(logits)[:, None]
        outs.append(tok)
    decode_s = _clock(device) - t0
    return {"prefill_s": prefill_s, "decode_s": decode_s,
            "tokens": torch.cat(outs, dim=1).cpu()}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True,
                    help="one of " + ", ".join(sorted(configs.ALIASES)))
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's reduced smoke configuration")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--kv-quant", action="store_true",
                    help="the int8 KV cache")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the CUDA kernels) or cpu (plain PyTorch)")
    args = ap.parse_args(argv)

    try:
        cfg = (configs.smoke(args.arch) if args.smoke
               else configs.get(args.arch))
    except ModuleNotFoundError:
        ap.error(f"unknown --arch {args.arch!r}: one of "
                 f"{', '.join(sorted(configs.ALIASES))}")
    try:
        M.check_family(cfg)
        device = resolve_device(args.device)
    except (NotImplementedError, RuntimeError) as e:
        ap.error(str(e))

    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    params = M.init(cfg, gen, device)
    prompts, vision = inputs(cfg, args.batch, args.prompt_len, device)
    if device.type == "cuda":
        for name in ("flash_attention", "ssd_scan"):
            _build.load(name)
    r = serve(cfg, params, prompts, args.gen, vision, args.kv_quant)
    print(f"prefill {args.batch}x{args.prompt_len}: {r['prefill_s']:.2f}s")
    print(f"decoded {args.gen} tokens x {args.batch} seqs in "
          f"{r['decode_s']:.2f}s "
          f"({args.gen * args.batch / r['decode_s']:.1f} tok/s)")
    print("sample:", r["tokens"][0].ravel()[:16].tolist())


if __name__ == "__main__":
    main()

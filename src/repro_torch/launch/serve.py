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
their plain versions.  The families not ported yet (moe, vlm, audio) and
``--kv-quant`` (the int8 KV cache) are refused.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core.api import resolve_device
from repro_torch.kernels import _build
from repro_torch.models import model as M
from repro_torch.serve.engine import (greedy_sample, make_decode_step,
                                      make_prefill_step)


def _clock(device: torch.device) -> float:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


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
                    help="the int8 KV cache: not ported yet (refused)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the CUDA kernels) or cpu (plain PyTorch)")
    args = ap.parse_args(argv)

    if args.kv_quant:
        ap.error("--kv-quant: the int8 KV cache is not ported yet (ROADMAP "
                 "Queue 1 item 11)")
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
    max_seq = args.prompt_len + args.gen
    prefill = make_prefill_step(cfg, block_q=32, block_k=32)
    decode = make_decode_step(cfg)
    prompts = torch.from_numpy(np.random.RandomState(7).randint(
        0, cfg.vocab, (args.batch, args.prompt_len)).astype(np.int32)).to(
            device)
    if device.type == "cuda":
        for name in ("flash_attention", "ssd_scan"):
            _build.load(name)

    t0 = _clock(device)
    logits, cache = prefill(params, prompts)
    cache = M.pad_cache(cfg, cache, max_seq)
    print(f"prefill {args.batch}x{args.prompt_len}: "
          f"{_clock(device) - t0:.2f}s")

    tok = greedy_sample(logits)[:, None]
    outs = []
    t0 = _clock(device)
    for i in range(args.gen):
        logits, cache = decode(params, cache, tok, args.prompt_len + i)
        tok = greedy_sample(logits)[:, None]
        outs.append(tok)
    dt = _clock(device) - t0
    out = torch.cat(outs, dim=1).cpu()
    print(f"decoded {args.gen} tokens x {args.batch} seqs in {dt:.2f}s "
          f"({args.gen * args.batch / dt:.1f} tok/s)")
    print("sample:", out[0].ravel()[:16].tolist())


if __name__ == "__main__":
    main()

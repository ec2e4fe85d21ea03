"""Batched serving on the port: continuous slot-based decode over a
narrow model (counterpart of ``examples/serve_batch.py``).

Submits a wave of requests, runs the lockstep decode loop of
``repro_torch.serve.BatchedServer``, and checks every request's greedy
continuation against an unbatched prefill + decode of its prompt.

  PYTHONPATH=src python examples/torch_serve_batch.py [--device cpu]

The model is zamba2-2.7b's smoke configuration (the hybrid: both kernels
run in its prefill) with head_dim 64 (the card's attention kernel takes
64, 80 or 128), in float32 so that the batched and the unbatched runs
round alike.  ``--device cuda`` (the default) runs the
prefills on the CUDA kernels and fails without a card; ``--device cpu``
runs their plain versions.
"""

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core.api import resolve_device
from repro_torch.models import model as M
from repro_torch.core.api import tree_map
from repro_torch.serve import (BatchedServer, Request, greedy_sample,
                               make_decode_step, make_prefill_step)


def reference_decode(cfg, params, prompt, n_new, max_seq):
    """One request alone: prefill, then greedy decode."""
    prefill = make_prefill_step(cfg, block_q=16, block_k=16)
    decode = make_decode_step(cfg)
    dev = params["embed"].device
    logits, cache = prefill(params, torch.from_numpy(prompt)[None].to(dev))
    cache = M.pad_cache(cfg, cache, max_seq)
    tok = greedy_sample(logits).reshape(1, 1)
    out = []
    for pos in range(prompt.shape[0], prompt.shape[0] + n_new):
        logits, cache = decode(params, cache, tok, pos)
        tok = greedy_sample(logits).reshape(1, 1)
        out.append(int(tok[0, 0]))
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the CUDA kernels) or cpu (plain PyTorch)")
    args = ap.parse_args()
    device = resolve_device(args.device)

    cfg = dataclasses.replace(configs.smoke("zamba2-2.7b"), head_dim=64)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    params = tree_map(lambda x: x.float(), M.init(cfg, gen, device))
    plen, n_new, slots = 16, 8, 4
    max_seq = plen + n_new + 2
    rng = np.random.RandomState(1)
    reqs = [Request(rid=i, prompt=rng.randint(0, cfg.vocab, plen).astype(
        np.int32), max_new=n_new) for i in range(6)]

    server = BatchedServer(cfg, params, batch_slots=slots, max_seq=max_seq,
                           block=16)
    t0 = time.time()
    server.run(reqs)
    dt = time.time() - t0
    total = sum(len(r.out) for r in reqs)
    print(f"served {len(reqs)} requests / {total} tokens in {dt:.1f}s "
          f"({slots} slots, {cfg.name} with head_dim 64, {device})")

    mismatch = sum(reference_decode(cfg, params, r.prompt, len(r.out),
                                    max_seq) != r.out for r in reqs)
    print("reference check:", "OK" if mismatch == 0 else
          f"{mismatch} mismatches")
    assert mismatch == 0


if __name__ == "__main__":
    main()

"""End-to-end LM training on the port (counterpart of
``examples/train_lm.py``): the deterministic pipeline, AdamW, and a
checkpoint to resume from.

Default: a ~15M-parameter mamba2-family model for 300 steps; the loss
falls well below the unigram entropy of the synthetic task (the pipeline
plants a copy structure).  ``--arch mamba2-130m`` trains that
configuration at full width and depth.

  PYTHONPATH=src python examples/torch_train_lm.py [--steps N] [--arch ID]
      [--device cpu] [--ckpt PATH [--resume]]

``--device cuda`` (the default; fails without a card) runs the SSD on the
CUDA kernel, its backward through the plain version
(``kernels/plain_grad.py``); ``--device cpu`` runs the plain versions.
"""

import argparse
import os
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core.api import resolve_device
from repro_torch.data.pipeline import synthetic_batch
from repro_torch.models import model as M
from repro_torch.models.config import ArchConfig, SSMConfig
from repro_torch.train import checkpoint
from repro_torch.train.optim import adamw_init
from repro_torch.train.step import make_train_step, master_params

TINY = ArchConfig(
    name="mamba2-15m", family="ssm", n_layers=6, d_model=384,
    vocab=2048, d_ff=0,
    ssm=SSMConfig(d_state=64, d_inner=768, head_dim=64, n_groups=1,
                  d_conv=4, chunk=64),
    tie_embeddings=True, remat="none", microbatches=1)


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--arch", default=None,
                    help="an arch id (default: the 15M tiny mamba2)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the CUDA kernels) or cpu (plain PyTorch)")
    ap.add_argument("--ckpt", default=None,
                    help="write the final state here (the reference's "
                         "training checkpoint format)")
    ap.add_argument("--resume", action="store_true",
                    help="start from --ckpt")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = configs.get(args.arch) if args.arch else TINY
    print(f"arch={cfg.name} params={cfg.param_count()/1e6:.1f}M "
          f"batch={args.batch}x{args.seq} on {device}")
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    params = master_params(cfg, M.init(cfg, gen, device))
    opt = adamw_init(params)
    start = 0
    if args.resume and args.ckpt and os.path.exists(args.ckpt):
        params, opt, start = checkpoint.restore(args.ckpt, params, opt)
        print(f"resumed at step {start}")
    step_fn = make_train_step(cfg, lr=3e-3, warmup=20,
                              total_steps=args.steps, microbatches=1,
                              block_q=64, block_k=64, device=device)

    losses = []
    t0 = time.time()
    for s in range(start, args.steps):
        batch = synthetic_batch(cfg, args.batch, args.seq, seed=1234,
                                step=s, device=device)
        params, opt, metrics = step_fn(params, opt, batch, s + 1)
        losses.append(float(metrics["loss"]))
        if s % 20 == 0 or s == args.steps - 1:
            rate = args.batch * args.seq * (s - start + 1) \
                / max(time.time() - t0, 1e-9)
            print(f"step {s:4d} loss {losses[-1]:.4f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"gnorm {float(metrics['grad_norm']):.2f} "
                  f"tok/s {rate:,.0f}", flush=True)

    first = np.mean(losses[:10])
    last = np.mean(losses[-10:])
    print(f"loss: first10={first:.3f} last10={last:.3f} "
          f"(improved {first - last:.3f})")
    if not last < first:
        raise SystemExit("training did not reduce the loss")
    if args.ckpt:
        checkpoint.save(args.ckpt, params, opt, args.steps)
        print(f"checkpoint -> {args.ckpt}")
    return losses


if __name__ == "__main__":
    main()

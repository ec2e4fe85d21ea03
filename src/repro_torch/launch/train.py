"""Training launcher of the port (counterpart of ``repro.launch.train``):
a restartable loop around ``repro_torch.train.step``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m \\
      --steps 100 --batch 8 --seq 256 [--ckpt run.ckpt] [--resume] \\
      [--device cpu] [--smoke]

Parameters come from the port's init (a generator of the device seeded
0) as float32 masters; batches from ``data.pipeline.synthetic_batch``
(a pure function of ``--seed`` and the step, so a resumed run sees the
same batches).  Checkpoints (the reference's file format) are written
every ``--ckpt-every`` steps and at the end; ``--resume`` continues from
the step a checkpoint records.  It prints the reference's lines:
``arch=...``, then ``step ... loss ... gnorm ...`` every 10 steps and at
the last, the only steps whose metrics it reads back from the device.
``--device cuda`` (the default; exits 2 without a card) runs attention
and the SSD on the CUDA kernels, built before the first step;
``--device cpu`` runs their plain versions.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Any, Dict, List

import torch

from repro_torch import configs
from repro_torch.core.api import resolve_device
from repro_torch.data.pipeline import synthetic_batch
from repro_torch.kernels import _build
from repro_torch.models import model as M
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.optim import adamw_init
from repro_torch.train.step import make_train_step, master_params


def _mark(device: torch.device):
    """A point in time on the device's clock: a recorded CUDA event on
    the card (no wait), the host's clock on the CPU."""
    if device.type == "cuda":
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event
    return time.perf_counter()


def _seconds(marks: List[Any]) -> List[float]:
    """Seconds between consecutive ``_mark``s (waits for the last)."""
    if marks and isinstance(marks[-1], torch.cuda.Event):
        marks[-1].synchronize()
        return [a.elapsed_time(b) / 1e3 for a, b in zip(marks, marks[1:])]
    return [b - a for a, b in zip(marks, marks[1:])]


def train(args: argparse.Namespace) -> Dict[str, Any]:
    """The launcher's run of ``args`` (``main``'s flags): prints its lines
    and returns the configuration, the final ``params`` and ``opt``, the
    first step run (``start``), each step's metrics (device tensors) and
    seconds."""
    cfg = configs.smoke(args.arch) if args.smoke else configs.get(args.arch)
    device = resolve_device(args.device)
    print(f"arch={cfg.name} params={cfg.param_count()/1e6:.1f}M",
          flush=True)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    params = master_params(cfg, M.init(cfg, gen, device))
    opt = adamw_init(params)
    start, saved = 0, None
    if args.resume and args.ckpt and os.path.exists(args.ckpt):
        params, opt, start = ckpt.restore(args.ckpt, params, opt, device)
        saved = start
        print(f"resumed from {args.ckpt} at step {start}", flush=True)
    if device.type == "cuda":
        for name in ("flash_attention", "ssd_scan"):
            _build.load(name)
    step_fn = make_train_step(cfg, lr=args.lr, total_steps=args.steps,
                              microbatches=1, block_q=64, block_k=64,
                              device=device)
    metrics, marks = [], [_mark(device)]
    t0 = time.time()
    for s in range(start, args.steps):
        batch = synthetic_batch(cfg, args.batch, args.seq, seed=args.seed,
                                step=s, device=device)
        params, opt, m = step_fn(params, opt, batch, s + 1)
        metrics.append(m)
        marks.append(_mark(device))
        if s % 10 == 0 or s == args.steps - 1:
            print(f"step {s:5d} loss {float(m['loss']):.4f} "
                  f"gnorm {float(m['grad_norm']):.2f} "
                  f"({time.time()-t0:.0f}s)", flush=True)
        if args.ckpt and (s + 1) % args.ckpt_every == 0:
            ckpt.save(args.ckpt, params, opt, s + 1)
            saved = s + 1
    if args.ckpt:
        if saved != args.steps:     # else that file holds this state
            ckpt.save(args.ckpt, params, opt, args.steps)
        print(f"checkpoint -> {args.ckpt}", flush=True)
    return {"cfg": cfg, "params": params, "opt": opt, "start": start,
            "metrics": metrics, "step_s": _seconds(marks)}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True,
                    help="one of " + ", ".join(sorted(configs.ALIASES)))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the CUDA kernels) or cpu (plain PyTorch)")
    return ap


def main(argv=None) -> None:
    ap = parser()
    args = ap.parse_args(argv)
    try:
        cfg = (configs.smoke(args.arch) if args.smoke
               else configs.get(args.arch))
    except ModuleNotFoundError:
        ap.error(f"unknown --arch {args.arch!r}: one of "
                 f"{', '.join(sorted(configs.ALIASES))}")
    try:
        M.check_family(cfg)
        resolve_device(args.device)
    except (NotImplementedError, RuntimeError) as e:
        ap.error(str(e))
    train(args)


if __name__ == "__main__":
    main()

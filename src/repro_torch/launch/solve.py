"""Solver launcher of the port (counterpart of ``repro.launch.solve``).

  PYTHONPATH=src python -m repro_torch.launch.solve --problem vc \
      --instance reg:48:4:1 --lanes 32 [--device cpu] [--ckpt run.ckpt] \
      [--ckpt-every 10] [--resume]

``--device`` defaults to ``cuda`` and fails when no card is present;
``--device cpu`` runs the plain PyTorch path.  The result line has the
reference's format: ``optimum=… rounds=… nodes=… T_S=… T_R=… wall=…``.
``--ckpt`` writes a checkpoint every ``--ckpt-every`` rounds and
``--resume`` restarts from it at any lane count; the file format is the
reference's, so either package resumes the other's checkpoint.
"""

from __future__ import annotations

import argparse
import time

from repro_torch import registry
from repro_torch.core.api import resolve_device
from repro_torch.solver import Solver, SolverConfig


def main() -> None:
    families = registry.names()
    ap = argparse.ArgumentParser()
    ap.add_argument("--problem", choices=sorted(families), default="vc",
                    help="registered problem family: " + "; ".join(
                        f"{n}: {registry.get(n).doc}" for n in families))
    ap.add_argument("--instance", default="reg:48:4:1")
    ap.add_argument("--lanes", type=int, default=32)
    ap.add_argument("--steps-per-round", type=int, default=64)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the CUDA kernels) or cpu (plain PyTorch)")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--resume", action="store_true")
    args = ap.parse_args()

    spec = registry.get(args.problem)
    try:
        instance = spec.parse(args.instance)
        resolve_device(args.device)
    except (ValueError, RuntimeError) as e:
        ap.error(str(e))

    config = SolverConfig(
        lanes=args.lanes, steps_per_round=args.steps_per_round,
        bootstrap_rounds=4, bootstrap_steps=8, device=args.device,
        checkpoint_every=args.ckpt_every if args.ckpt else 0,
        checkpoint_path=args.ckpt,
        resume_from=args.ckpt if args.resume else None)
    handle = registry.problem(args.problem, instance)
    print(f"{args.problem}[{spec.label(instance)}]: lanes={args.lanes} "
          f"device={args.device}")
    t0 = time.time()
    stats = Solver(config).solve(handle).stats
    print(f"optimum={stats.best} rounds={stats.rounds} nodes={stats.nodes} "
          f"T_S={stats.t_s} T_R={stats.t_r} wall={time.time()-t0:.1f}s")


if __name__ == "__main__":
    main()

"""Solver launcher of the port (counterpart of ``repro.launch.solve``).

  PYTHONPATH=src python -m repro_torch.launch.solve --problem vc \
      --instance reg:48:4:1 --lanes 32 [--device cpu] [--ckpt run.ckpt] \
      [--ckpt-every 10] [--resume] [--trace run.jsonl] [--metrics]

``--problem`` takes any registered family and ``--instance`` that
family's own grammar (graphs: ``gnp:<n>:<p*100>:<seed>``,
``reg:<n>:<k>:<seed>``, ``cell60``; subset sum: ``ss:<n>:<seed>``).
``--device`` defaults to ``cuda`` and fails when no card is present;
``--device cpu`` runs the plain PyTorch path.  The result line has the
reference's format: ``optimum=… rounds=… nodes=… T_S=… T_R=… wall=…``.
``--ckpt`` writes a checkpoint every ``--ckpt-every`` rounds and
``--resume`` restarts from it at any lane count; the file format is the
reference's, so either package resumes the other's checkpoint.
``--trace`` writes the reference's JSONL trace (``tools/trace_report.py``
reads it) and ``--metrics`` prints the reference's ``metrics:`` line.
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
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write a JSONL search trace (repro_torch.obs "
                         "schema; summarize with tools/trace_report.py)")
    ap.add_argument("--metrics", action="store_true",
                    help="collect in-process metrics and print a summary")
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
        resume_from=args.ckpt if args.resume else None,
        trace_path=args.trace, metrics=args.metrics)
    handle = registry.problem(args.problem, instance)
    print(f"{args.problem}[{spec.label(instance)}]: lanes={args.lanes} "
          f"device={args.device}")
    t0 = time.time()
    solver = Solver(config)
    stats = solver.solve(handle).stats
    print(f"optimum={stats.best} rounds={stats.rounds} nodes={stats.nodes} "
          f"T_S={stats.t_s} T_R={stats.t_r} wall={time.time()-t0:.1f}s")
    if args.metrics:
        snap = solver.metrics()
        util = snap.value("lane_utilization")
        steals = snap.value("steal_received", scope="intra")
        cross = snap.value("steal_received", scope="cross")
        print(f"metrics: nodes={snap.value('engine_nodes')} "
              f"dispatches={snap.value('engine_dispatches')} "
              f"util={util:.3f} steals intra={steals} cross={cross}")
    if args.trace:
        print(f"trace -> {args.trace}")


if __name__ == "__main__":
    main()

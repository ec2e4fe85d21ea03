"""The paper's hard case on the PyTorch/CUDA port: a 4-regular graph
whose regularity defeats degree pruning.  Solves it at 4, 16 and 64
lanes, then checkpoints a 16-lane run, stops it, and restarts it
elastically at 32 lanes from the persisted ``current_idx``; every run
must reach the serial oracle's optimum.

  PYTHONPATH=src python examples/torch_solve_60cell.py          # the card
  PYTHONPATH=src python examples/torch_solve_60cell.py --device cpu
"""

import argparse
import os
import tempfile
import time

from repro_torch import registry
from repro_torch.solver import Solver, SolverConfig


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the CUDA kernels) or cpu (plain PyTorch)")
    args = ap.parse_args()

    problem = registry.problem("vc", "reg:48:4:1")   # 60-cell analogue
    graph = problem.instance
    print(f"instance: 4-regular-ish n={graph.n} m={graph.m}")
    ref = Solver().oracle(problem)
    print(f"SERIAL-RB: optimum={ref.best}, nodes={ref.nodes}")

    for lanes in (4, 16, 64):
        t0 = time.time()
        cfg = SolverConfig(lanes=lanes, steps_per_round=64,
                           bootstrap_rounds=4, bootstrap_steps=8,
                           device=args.device)
        stats = Solver(cfg).solve(problem).stats
        print(f"lanes={lanes:3d} optimum={stats.best} rounds={stats.rounds}"
              f" nodes={stats.nodes} T_S={stats.t_s} T_R={stats.t_r}"
              f" wall={time.time()-t0:.1f}s")
        assert stats.best == ref.best

    # Checkpoint / elastic restart: 5 rounds at 16 lanes, checkpointed
    # every round, then the search finishes at 32 lanes from the file —
    # the lane count is config, the checkpoint is elastic.
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "solver.ckpt")
        first = Solver(SolverConfig(
            lanes=16, steps_per_round=64, max_rounds=5, bootstrap_rounds=2,
            checkpoint_every=1, checkpoint_path=path,
            device=args.device)).solve(problem).stats
        print(f"checkpointed 16-lane run after {first.rounds} rounds")
        stats = Solver(SolverConfig(lanes=32, steps_per_round=64,
                                    resume_from=path, device=args.device)
                       ).solve(problem).stats
    print(f"elastic restart at 32 lanes: optimum={stats.best} "
          f"(+{stats.rounds} rounds)")
    assert stats.best == ref.best
    print("every run matches the serial oracle — done.")


if __name__ == "__main__":
    main()

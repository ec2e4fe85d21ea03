"""Quickstart for the PyTorch/CUDA port: one registry entry, one Solver
session, the serial oracle and the lane engine on the card.

  PYTHONPATH=src python examples/torch_quickstart.py            # the card
  PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""

import argparse

from repro_torch import registry
from repro_torch.solver import Solver, SolverConfig


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the CUDA kernels) or cpu (plain PyTorch)")
    args = ap.parse_args()

    # One handle carries the engine form AND the serial-oracle form.
    problem = registry.problem("vc", "gnp:24:25:42")
    graph = problem.instance
    print(f"instance: G(n={graph.n}, m={graph.m})")

    solver = Solver(SolverConfig(lanes=16, steps_per_round=64,
                                 bootstrap_rounds=3, bootstrap_steps=8,
                                 device=args.device))

    # 1. The serial oracle (paper Fig. 1) — ground truth.
    ref = solver.oracle(problem)
    print(f"SERIAL-RB: optimum={ref.best}, nodes={ref.nodes}")

    # 2. The parallel engine: 16 lanes on the device, steal rounds,
    #    implicit load balancing.
    res = solver.solve(problem)
    print(f"PARALLEL-RB (16 lanes, {args.device}): optimum={res.stats.best}, "
          f"rounds={res.stats.rounds}, nodes={res.stats.nodes}, "
          f"T_S={res.stats.t_s}, T_R={res.stats.t_r}")
    assert res.stats.best == ref.best
    print("optimum matches the serial oracle — done.")


if __name__ == "__main__":
    main()

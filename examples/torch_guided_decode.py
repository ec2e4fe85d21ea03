"""The paper's technique applied outside graph problems, on the PyTorch
port: exact best-path decoding over an LM's pruned token lattice as
indexed-search-tree backtracking (counterpart of
``examples/guided_decode.py``).

Problem: find the exact highest-likelihood continuation of length D when
each step may choose one of the top-2 tokens (a binary search tree,
depth D).  Greedy decoding is the leftmost leaf; the optimum may differ
(the classic beam-search-vs-greedy gap).  The solver enumerates the
lattice with branch-and-bound: bound = achieved cost (future steps cost
>= 0), tasks are current_idx prefixes, cores steal heaviest subtrees:
the PARALLEL-RB machinery, oblivious to the problem being an LM lattice.

The LM is the reference's toy (2 layers, d 64, vocab 64, hd 16) from
the port's init; on the card its attention runs the ``flash_attention``
kernel (hd 16 zero-padded to the built 64).

  PYTHONPATH=src python examples/torch_guided_decode.py            # the card
  PYTHONPATH=src python examples/torch_guided_decode.py --device cpu
"""

import argparse
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from repro_torch.core.serial import (ParallelRBSimulator, PyNodeEval,
                                     PyProblem, serial_rb)
from repro_torch.models import model as M
from repro_torch.models.config import ArchConfig

CFG = ArchConfig(name="toy-lm", family="dense", n_layers=2, d_model=64,
                 vocab=64, n_heads=4, n_kv=2, head_dim=16, d_ff=128,
                 remat="none")
DEPTH = 8
PROMPT_LEN = 8
SCALE = 1000        # logprob -> integer objective (the engine minimizes)

Expand = Callable[[Tuple[int, ...]], Tuple[np.ndarray, np.ndarray]]


def init(seed: int = 0, device="cuda") -> Tuple[Dict, torch.Tensor]:
    """The toy LM's parameters and a prompt [1, PROMPT_LEN] on
    ``device``, from generators seeded ``seed`` and ``seed + 1``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    params = M.init(CFG, gen, device)
    gen.manual_seed(seed + 1)
    prompt = torch.randint(0, CFG.vocab, (1, PROMPT_LEN), generator=gen,
                           device=device, dtype=torch.int32)
    return params, prompt


def build_lattice(params: Dict, prompt: torch.Tensor) -> Expand:
    """``expand(prefix) -> (top-2 ids, their log-probabilities)`` after
    ``prompt`` + ``prefix``, memoized per prefix: one forward a lattice
    node (the demonstration is the search layer, not serving speed).
    The top 2 in the reference's order: the larger first, the lower id
    first on a tie."""
    ctx = M.make_ctx(CFG, "train", block_q=16, block_k=16)
    memo: Dict[Tuple[int, ...], Tuple[np.ndarray, np.ndarray]] = {}

    def expand(prefix):
        if prefix in memo:
            return memo[prefix]
        toks = prompt
        if prefix:
            toks = torch.cat([prompt, torch.tensor(
                [prefix], dtype=torch.int32, device=prompt.device)], dim=1)
        with torch.no_grad():
            logits = M.forward(CFG, params, toks, ctx)[0, -1]
        lg = torch.log_softmax(logits.float(), dim=-1)
        v, i = torch.sort(lg, descending=True, stable=True)
        memo[prefix] = (i[:2].cpu().numpy(), v[:2].cpu().numpy())
        return memo[prefix]

    return expand


def make_problem(expand: Expand) -> PyProblem:
    """State: (depth, prefix tokens, accumulated -logprob * SCALE).  One
    ``expand`` call gives the solution test, the bound and both
    children."""

    def root():
        return (0, (), 0)

    def evaluate(state, best):
        d, prefix, cost = state
        if d >= DEPTH:              # leaf: children are never taken
            return PyNodeEval(True, cost, cost, state, state)
        ids, lps = expand(prefix)   # the one shared LM forward
        left = (d + 1, prefix + (int(ids[0]),), cost + int(-lps[0] * SCALE))
        right = (d + 1, prefix + (int(ids[1]),), cost + int(-lps[1] * SCALE))
        return PyNodeEval(False, cost, cost, left, right)

    return PyProblem(name="guided-decode", max_depth=DEPTH, root=root,
                     evaluate=evaluate)


def greedy(problem: PyProblem) -> Tuple:
    """The leftmost leaf: always the top-1 token."""
    state = problem.root()
    for _ in range(DEPTH):
        state = problem.apply(state, 0)
    return state


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the CUDA kernels) or cpu (plain PyTorch)")
    args = ap.parse_args()
    expand = build_lattice(*init(0, args.device))
    prob = make_problem(expand)

    state = greedy(prob)
    greedy_cost = state[2]
    print(f"greedy continuation: tokens={state[1]} "
          f"-logprob={greedy_cost/SCALE:.3f}")

    best, nodes, _ = serial_rb(prob)
    print(f"exact optimum: -logprob={best/SCALE:.3f} "
          f"(searched {nodes} lattice nodes, greedy gap "
          f"{(greedy_cost-best)/SCALE:.3f})")
    assert best <= greedy_cost

    sim = ParallelRBSimulator(make_problem(expand), c=8).run()
    assert sim.best == best
    print(f"PARALLEL-RB x8: same optimum in {sim.makespan} ticks "
          f"(T_S={sim.avg_t_s:.1f}, T_R={sim.avg_t_r:.1f}) — "
          "the framework is oblivious to the problem being an LM lattice.")


if __name__ == "__main__":
    main()

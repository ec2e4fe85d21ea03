"""Problem protocol of the PyTorch port (counterpart of ``repro.core.api``).

A problem is explored as a *binary* search tree: every node either
branches into exactly two children (``left = bit 0``, ``right = bit 1``)
or is a terminal.  The problem provides ONE batched callback::

    evaluate_batch(states, best) -> NodeEval(is_solution, value,
                                             lower_bound, left, right,
                                             payload)

over a leading lane axis: ``states`` is a NamedTuple of tensors with
leaves ``[W, ...]`` and ``best`` is ``int32[W]``.  The engine calls it
once per step for all W lanes, which is the reference's ``evaluate_batch``
fast path; the reference's per-lane ``evaluate`` has no counterpart here
because eager PyTorch has no ``vmap`` to lift it.

Determinism contract (unchanged from the reference): ``left``, ``right``
and ``payload`` must not depend on ``best``, so a replayed task grows
exactly the subtree its donor would have.

Bitsets are ``int32`` tensors holding the reference's ``uint32`` bits.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch

PyTree = Any

#: Sentinel values used in ``idx`` arrays (paper, Fig. 2-4).
UNVISITED = -2   # slot beyond the live path / child not yet taken
DELEGATED = -1   # right sibling at this depth was shipped elsewhere
LEFT = 0
RIGHT = 1

#: "Infinite" objective for minimization problems (int32-safe).
INF_VALUE = 2 ** 30


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises when CUDA is asked for and
    absent (the port never falls back to the CPU on its own)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but CUDA is not available; "
            f"pass device='cpu' (CLI: --device cpu) to run on the CPU")
    return dev


class NodeEval(NamedTuple):
    """Everything the engine needs from one batch of search-nodes.

    Attributes (leading lane axis W on every field):
      is_solution: bool[W] — the node is a solution leaf.
      value: int32[W] — objective value if ``is_solution``.
      lower_bound: int32[W] — admissible bound on the subtree's best
        objective; the engine prunes when ``lower_bound >= best``.
      left / right: state pytrees — the bit-0 / bit-1 children, computed
        even at terminal nodes (where they are discarded).
      payload: pytree — the solution recorded when a node improves the
        incumbent.
    """

    is_solution: torch.Tensor
    value: torch.Tensor
    lower_bound: torch.Tensor
    left: PyTree
    right: PyTree
    payload: PyTree


def tree_map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    """Map ``fn`` over the tensor leaves of (Named)tuples of tensors."""
    if isinstance(tree, tuple):
        mapped = [tree_map(fn, *leaves) for leaves in zip(tree, *rest)]
        return type(tree)(*mapped) if hasattr(tree, "_fields") \
            else type(tree)(mapped)
    return fn(tree, *rest)


def tree_leaves(tree: PyTree) -> list:
    if isinstance(tree, tuple):
        return [leaf for sub in tree for leaf in tree_leaves(sub)]
    return [tree]


def bcast(pred: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``pred`` [W] reshaped to broadcast against ``like`` [W, ...]."""
    return pred.reshape(pred.shape + (1,) * (like.dim() - pred.dim()))


def tree_select(pred: torch.Tensor, a: PyTree, b: PyTree) -> PyTree:
    """Branchless per-lane blend: ``a`` where ``pred`` [W] else ``b``."""
    return tree_map(lambda x, y: torch.where(bcast(pred, x), x, y), a, b)


@dataclasses.dataclass(frozen=True)
class BinaryProblem:
    """A minimization problem explored by binary recursive backtracking.

    Attributes:
      name: identifier used in logs.
      max_depth: static bound D_MAX on the tree depth.
      root: () -> state — the root search-node (unbatched leaves).
      evaluate_batch: (states, best) -> NodeEval over a leading lane axis.
      payload_zero: () -> pytree — zero payload of ``NodeEval.payload``'s
        per-lane shape.
      num_instances: K — instances multiplexed over the lane pool (1 for
        an ordinary problem; the solver service sets K > 1).
      instance_root: optional (inst: int32[W]) -> states — the root of each
        lane's own instance, batched, for K > 1 problems: CONVERTINDEX
        replay of a stolen task must start from the root of the task's
        instance.  ``None`` means ``root()`` serves every instance.
    """

    name: str
    max_depth: int
    root: Callable[[], PyTree]
    evaluate_batch: Callable[[PyTree, torch.Tensor], NodeEval]
    payload_zero: Callable[[], PyTree]
    num_instances: int = 1
    instance_root: Optional[Callable[[torch.Tensor], PyTree]] = None

    def apply(self, states: PyTree, bit: torch.Tensor) -> PyTree:
        """Descend every lane to its left (0) or right (1) child."""
        best = torch.full(bit.shape, INF_VALUE, dtype=torch.int32,
                          device=bit.device)
        ev = self.evaluate_batch(states, best)
        return tree_select(bit == 0, ev.left, ev.right)

    def arity(self, states: PyTree, best: torch.Tensor) -> torch.Tensor:
        """Children per lane: 0 when leaf or pruned by bound, else 2."""
        ev = self.evaluate_batch(states, best)
        pruned = ev.lower_bound >= best
        return torch.where(ev.is_solution | pruned, 0, 2).to(torch.int32)


def root_of(problem: BinaryProblem, inst: torch.Tensor) -> PyTree:
    """Root state of each lane's instance ``inst`` (int32[W]), batched:
    ``instance_root(inst)`` when the problem has one, else ``root()`` for
    every lane."""
    if problem.instance_root is not None:
        return problem.instance_root(inst)
    return tree_map(lambda r: r.unsqueeze(0).expand(
        (inst.shape[0],) + r.shape), problem.root())

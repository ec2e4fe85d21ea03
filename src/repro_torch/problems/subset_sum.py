"""Minimum-cardinality SUBSET SUM, the non-graph family, on PyTorch.

Counterpart of ``repro.problems.subset_sum``.  Given positive ints and a
target, find the smallest subset summing exactly to the target.  The left
child takes item ``pos``, the right child skips it, so the tree is binary
with depth exactly n.  There is no table to stream and no kernel: the
batched ``evaluate_batch`` is a handful of PyTorch operations on whichever
device the lanes are on.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.core.api import (INF_VALUE, BinaryProblem, NodeEval,
                                  resolve_device)
from repro_torch.core.serial import INF, PyNodeEval, PyProblem
from repro_torch.registry import register_problem


class SSInstance(NamedTuple):
    """A subset-sum instance: positive item values and an exact target;
    ``n`` and ``name`` follow the ``Graph`` conventions the launchers
    read."""

    values: Tuple[int, ...]
    target: int
    name: str = "ss"

    @property
    def n(self) -> int:
        return len(self.values)


def parse_ss_instance(spec: str) -> SSInstance:
    """Parse ``ss:<n>:<seed>``: ``n`` seeded random values in [1, 50) and a
    target that is the sum of a random non-empty subset, so the instance
    is feasible (the reference's generator, draw for draw)."""
    kind, *rest = spec.split(":")
    if kind != "ss" or len(rest) != 2:
        raise ValueError(
            f"unknown instance spec {spec!r} (want ss:<n>:<seed>)")
    n, seed = (int(x) for x in rest)
    if n < 1:
        raise ValueError(f"bad subset-sum size in {spec!r}")
    rng = np.random.RandomState(seed)
    values = rng.randint(1, 50, size=n)
    chosen = rng.rand(n) < 0.4
    if not chosen.any():
        chosen[int(rng.randint(n))] = True
    target = int(values[chosen].sum())
    return SSInstance(values=tuple(int(v) for v in values), target=target,
                      name=f"ss_{n}_{seed}")


class SSState(NamedTuple):
    pos: torch.Tensor      # int32[...]    — next item to decide
    total: torch.Tensor    # int32[...]    — sum of the taken items
    count: torch.Tensor    # int32[...]    — number of taken items
    mask: torch.Tensor     # int32[..., n] — 1 where taken (the payload)


@register_problem(
    "ss",
    parse=parse_ss_instance,
    oracle=lambda inst: make_subset_sum_py(inst.values, inst.target),
    # No ``pack``: the service's stacked tables are graph-shaped, so
    # subset sum is not servable (submit() raises AdmissionError).
    build=lambda inst, device: make_subset_sum(inst.values, inst.target,
                                               device=device),
    doc="minimum-cardinality exact subset sum (non-graph family)",
)
def make_subset_sum(values, target: int,
                    device: str = "cuda") -> BinaryProblem:
    """Batched BinaryProblem with the item values on ``device``."""
    dev = resolve_device(device)
    vals_np = np.asarray(values, dtype=np.int64)
    n = int(vals_np.shape[0])
    vals = torch.from_numpy(vals_np.astype(np.int32)).to(dev)
    # Suffix sums prune branches that can no longer reach the target.
    suffix = torch.from_numpy(np.concatenate(
        [np.cumsum(vals_np[::-1])[::-1], [0]]).astype(np.int32)).to(dev)
    tgt = int(target)

    def zero() -> torch.Tensor:
        # Made on the device: the replay takes a root every round, and a
        # tensor built from a host value would copy (and sync) each time.
        return torch.zeros((), dtype=torch.int32, device=dev)

    def root() -> SSState:
        return SSState(pos=zero(), total=zero(), count=zero(),
                       mask=torch.zeros(n, dtype=torch.int32, device=dev))

    def evaluate_batch(states: SSState, best: torch.Tensor) -> NodeEval:
        pos, total, count = states.pos, states.total, states.count
        p = pos.clamp(0, n - 1)
        is_sol = (pos >= n) & (total == tgt)

        pc = pos.clamp(0, n)
        overshoot = total > tgt
        unreachable = total + suffix[pc] < tgt
        done_wrong = (pos >= n) & (total != tgt)
        bad = overshoot | unreachable | done_wrong
        lb = torch.where(bad, INF_VALUE,
                         count + (total != tgt).to(torch.int32))

        left = SSState(pos=pos + 1, total=total + vals[p], count=count + 1,
                       mask=states.mask.scatter(1, p.long()[:, None], 1))
        right = SSState(pos=pos + 1, total=total, count=count,
                        mask=states.mask)
        return NodeEval(is_solution=is_sol, value=count, lower_bound=lb,
                        left=left, right=right, payload=states.mask)

    return BinaryProblem(
        name=f"subset_sum[n={n}]", max_depth=n, root=root,
        evaluate_batch=evaluate_batch,
        payload_zero=lambda: torch.zeros(n, dtype=torch.int32, device=dev),
        payload_dtype="int32")


def make_subset_sum_py(values, target: int) -> PyProblem:
    """Scalar mirror in plain Python — branches identically to the
    batched form."""
    vals = [int(v) for v in values]
    n = len(vals)
    suffix = [0] * (n + 1)
    for i in range(n - 1, -1, -1):
        suffix[i] = suffix[i + 1] + vals[i]

    def root():
        return (0, 0, 0)

    def evaluate(s, best):
        pos, total, count = s
        p = min(pos, n - 1)
        is_sol = pos >= n and total == target

        pc = min(pos, n)
        if total > target or total + suffix[pc] < target or \
                (pos >= n and total != target):
            lb = INF
        else:
            lb = count + (1 if total != target else 0)

        left = (pos + 1, total + vals[p], count + 1)
        right = (pos + 1, total, count)
        return PyNodeEval(is_sol, count, lb, left, right)

    return PyProblem(name=f"subset_sum[n={n}]", max_depth=n, root=root,
                     evaluate=evaluate)

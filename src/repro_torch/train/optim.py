"""AdamW with float32 state (counterpart of ``repro.train.optim``).

The update is the reference's decoupled-weight-decay Adam: float32 moments,
a global-norm clip of the gradients (1.0), weight decay on the leaves of
two or more dimensions only.  The bias corrections and the schedule are
computed on the device from a float32 step tensor, as the reference
computes them in float32: no Python float64 enters the update and the
step reads nothing back from the device.

The reference's update is functional; this one writes the parameters
and the moments in place (as ``torch.optim`` does) and returns them, so
a step holds one copy of each.  The reference's ``adamw_specs`` has no
counterpart: the port's LM trains on one device.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional, Tuple, Union

import torch

from repro_torch.core.api import tree_leaves, tree_map

PyTree = Any
Step = Union[int, torch.Tensor]


class AdamState(NamedTuple):
    m: PyTree
    v: PyTree


def adamw_init(params: PyTree) -> AdamState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return AdamState(m=tree_map(zeros, params), v=tree_map(zeros, params))


def _f32(step: Step, device) -> torch.Tensor:
    """The step as a float32 scalar on ``device`` (a fill, not a copy
    from the host, when it is a Python int)."""
    if isinstance(step, torch.Tensor):
        return step.to(device=device, dtype=torch.float32)
    return torch.full((), step, dtype=torch.float32, device=device)


def global_norm(grads: PyTree) -> torch.Tensor:
    """sqrt of the sum of the squares of every leaf, in float32, the
    leaves summed in tree order (the reference's)."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in tree_leaves(grads)))


def adamw_update(params: PyTree, grads: PyTree, state: AdamState,
                 step: Step, lr: Union[float, torch.Tensor],
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1,
                 grad_clip: Optional[float] = 1.0
                 ) -> Tuple[PyTree, AdamState]:
    """One AdamW step at ``step`` (1 for the first) with learning rate
    ``lr``: ``params``, ``state.m`` and ``state.v`` written in place and
    returned."""
    leaves = tree_leaves(params)
    device = leaves[0].device
    t = _f32(step, device)
    c1 = 1.0 - torch.pow(b1, t)
    c2 = 1.0 - torch.pow(b2, t)
    with torch.no_grad():
        if grad_clip is not None:
            gnorm = global_norm(grads)
            scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-12),
                                max=1.0)
        else:
            scale = 1.0
        for p, g, m, v in zip(leaves, tree_leaves(grads),
                              tree_leaves(state.m), tree_leaves(state.v)):
            g = g.float() * scale
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g * g)
            upd = (m / c1) / (torch.sqrt(v / c2) + eps)
            if p.ndim >= 2:
                upd = upd + weight_decay * p.float()
            p.copy_(p.float() - lr * upd)
    return params, state


def cosine_lr(step: Step, peak: float, warmup: int, total: int,
              floor: float = 0.1, device=None) -> torch.Tensor:
    """Linear warmup to ``peak`` over ``warmup`` steps, then a cosine to
    ``floor * peak`` at ``total``: a float32 scalar on the step's device
    (``device`` for a Python int)."""
    t = _f32(step, device if device is not None else "cpu")
    warm = peak * t / max(warmup, 1)
    frac = torch.clamp((t - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = peak * (floor + (1 - floor) * 0.5
                  * (1 + torch.cos(math.pi * frac)))
    return torch.where(t < warmup, warm, cos)

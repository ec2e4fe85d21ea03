"""Pipeline parallelism: the GPipe microbatch schedule over a mesh
(counterpart of ``repro.distributed.pipeline_parallel``).

The layers are split into S stages, stage s on ``mesh.devices[s]``.  M
microbatches run in S + M - 1 ticks: at tick t stage 0 takes microbatch
t (while t < M), every other stage the activation its predecessor handed
it at the end of the last tick, and the last stage emits microbatch
t - (S - 1) from tick S - 1 on.  Activations move from device to device
between ticks.  The reference runs the schedule in ``shard_map`` with a
ring ``ppermute``, every stage computing at every tick (bubbles
included); the port's mesh is one host process, which skips the bubbles:
the outputs are the same.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence

import torch

from repro_torch.core.api import tree_map
from repro_torch.core.distributed import Mesh

PyTree = Any


def pipeline_forward(stage_fn: Callable[[PyTree, torch.Tensor],
                                        torch.Tensor],
                     stage_params: Sequence[PyTree], x_mb: torch.Tensor,
                     mesh: Mesh) -> torch.Tensor:
    """Run M microbatches through S = ``mesh.size`` stages.

    ``stage_fn(params, x) -> x`` applies one stage; ``stage_params[s]``
    are stage s's parameters (moved to ``mesh.devices[s]``); ``x_mb``
    [M, mb, ...] the microbatches.  Returns the last stage's outputs
    [M, mb, ...] on ``x_mb``'s device."""
    s_count, m_count = mesh.size, x_mb.shape[0]
    if len(stage_params) != s_count:
        raise ValueError(f"{len(stage_params)} stages' parameters for a "
                         f"mesh of {s_count} devices")
    devices = mesh.devices
    params = [tree_map(lambda p, dev=dev: p.to(dev), sp)
              for sp, dev in zip(stage_params, devices)]
    held: List[Optional[torch.Tensor]] = [None] * s_count
    outs: List[Optional[torch.Tensor]] = [None] * m_count
    for t in range(s_count + m_count - 1):
        handed: List[Optional[torch.Tensor]] = [None] * s_count
        for s in range(s_count):
            mb = t - s
            if not 0 <= mb < m_count:
                continue                       # a bubble
            cur = x_mb[mb].to(devices[0]) if s == 0 else held[s]
            y = stage_fn(params[s], cur)
            if s == s_count - 1:
                outs[mb] = y
            else:
                handed[s + 1] = y.to(devices[s + 1])
        held = handed
    return torch.stack([y.to(x_mb.device) for y in outs])

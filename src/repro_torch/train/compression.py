"""Gradient compression: an int8 all-reduce with error feedback
(counterpart of ``repro.train.compression``).

Each shard quantizes its gradient to int8 on a grid shared by all shards
(one scale: the largest absolute value over the shards, over 127), the
int8 payloads cross to the mesh's first device and are summed there in
int32, and every shard gets the dequantized mean back.  Each shard keeps
its quantization residual and adds it to its next gradient (error
feedback).  The reference runs this inside ``shard_map`` with ``pmax`` and
``psum``; the port's mesh is one host process (``core.distributed.Mesh``)
and takes one gradient tree per shard.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.api import tree_leaves, tree_map
from repro_torch.core.distributed import Mesh

PyTree = Any


def quantize(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)


def _scalar(x: float, device) -> torch.Tensor:
    return torch.full((), x, dtype=torch.float32, device=device)


def _leaf(gs: List[torch.Tensor], es: List[Optional[torch.Tensor]],
          mesh: Mesh) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """One leaf over the shards: (each shard's mean, each shard's error)."""
    home, n = mesh.devices[0], mesh.size
    gs = [g.float() + e if e is not None else g.float()
          for g, e in zip(gs, es)]
    amax = torch.stack([torch.max(torch.abs(g)).to(home) for g in gs]).max()
    # Divisors as device tensors: CUDA divides by a host scalar through
    # its reciprocal, which can round differently from the reference's
    # (and the CPU's) true division.
    scale = torch.clamp(amax, min=1e-12) / _scalar(127.0, home)
    scales = [scale.to(dev) for dev in mesh.devices]
    qs = [quantize(g, s) for g, s in zip(gs, scales)]
    summed = sum(q.to(home).to(torch.int32) for q in qs)
    means = [summed.to(dev).float() * s / _scalar(n, dev)
             for dev, s in zip(mesh.devices, scales)]
    errors = [g - q.float() * s for g, q, s in zip(gs, qs, scales)]
    return means, errors


def compressed_psum(grads: Sequence[PyTree], mesh: Mesh,
                    error: Optional[Sequence[PyTree]] = None
                    ) -> Tuple[List[PyTree], List[PyTree]]:
    """``grads[d]``: shard d's gradient tree, on ``mesh.devices[d]``;
    ``error``: each shard's residual from the last call (None: none).
    Returns (each shard's float32 mean gradient, each shard's new
    residual), trees of ``grads[0]``'s structure on the shards'
    devices."""
    if len(grads) != mesh.size:
        raise ValueError(f"{len(grads)} gradient trees for a mesh of "
                         f"{mesh.size} shards")
    flat = [tree_leaves(g) for g in grads]
    flat_e = ([tree_leaves(e) for e in error] if error is not None
              else [[None] * len(f) for f in flat])
    outs = [_leaf(list(gs), list(es), mesh)
            for gs, es in zip(zip(*flat), zip(*flat_e))]

    def tree(which: int, shard: int) -> PyTree:
        it = iter(out[which][shard] for out in outs)
        return tree_map(lambda _: next(it), grads[0])
    return ([tree(0, d) for d in range(mesh.size)],
            [tree(1, d) for d in range(mesh.size)])


def error_init(grads_like: PyTree) -> PyTree:
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads_like)

"""Declarative parameters (counterpart of ``repro.models.params``).

A module's parameters are declared as a tree (dicts and lists) of
:class:`ParamDecl` (shape, dtype, initializer); ``init_params`` turns it
into a tree of tensors on one device, drawn from an explicit
``torch.Generator``.  The init laws are the reference's: normal times
1/sqrt(fan_in), ``ssm_a`` (log of U(1, 16)), ``ssm_dt`` (softplus^-1 of
U(1e-3, 1e-1)), zeros and ones.  The random streams are PyTorch's, not
JAX's: the same seed gives other values than the reference's init (tests
carry the reference's values across with ``repro_torch.convert``).  There
are no logical axes and no sharding specs: the port serves on one device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch

from repro_torch.core.api import tree_map

PyTree = Any


@dataclasses.dataclass(frozen=True)
class ParamDecl:
    shape: Tuple[int, ...]
    dtype: torch.dtype = torch.bfloat16
    init: str = "normal"        # normal | zeros | ones | ssm_a | ssm_dt
    fan_in: Optional[int] = None


def _init_leaf(decl: ParamDecl, gen: torch.Generator,
               device: torch.device) -> torch.Tensor:
    if decl.init == "zeros":
        return torch.zeros(decl.shape, dtype=decl.dtype, device=device)
    if decl.init == "ones":
        return torch.ones(decl.shape, dtype=decl.dtype, device=device)

    def uniform(lo, hi):
        u = torch.rand(decl.shape, generator=gen, device=device,
                       dtype=torch.float32)
        return lo + (hi - lo) * u
    if decl.init == "ssm_a":      # mamba2: A = -exp(uniform log) in [1,16]
        return torch.log(uniform(1.0, 16.0)).to(decl.dtype)
    if decl.init == "ssm_dt":     # dt bias: softplus^-1 of U(1e-3, 1e-1)
        u = uniform(1e-3, 1e-1)
        return (u + torch.log(-torch.expm1(-u))).to(decl.dtype)
    fan_in = decl.fan_in or (decl.shape[-2] if len(decl.shape) >= 2
                             else decl.shape[-1])
    std = 1.0 / math.sqrt(max(fan_in, 1))
    return (torch.randn(decl.shape, generator=gen, device=device,
                        dtype=torch.float32) * std).to(decl.dtype)


def init_params(decls: PyTree, gen: torch.Generator, device) -> PyTree:
    """Tensors for a declaration tree, on ``device``, drawn from ``gen``
    (a generator of that device) leaf after leaf in the tree's order."""
    device = torch.device(device)
    return tree_map(lambda d: _init_leaf(d, gen, device), decls)


def abstract_params(decls: PyTree) -> PyTree:
    """Stand-ins for a declaration tree on the ``meta`` device: each
    leaf's shape and dtype, no storage (the dry run's parameters)."""
    return tree_map(lambda d: torch.empty(d.shape, dtype=d.dtype,
                                          device="meta"), decls)

"""State carried between the JAX reference and the PyTorch port.

The reference keeps bitsets as ``uint32``; the port keeps the same bits
as ``int32`` (PyTorch has no bitwise operators for ``uint32`` on the
CPU).  These functions move problem tables and whole lane states across
as numpy arrays, bit for bit, so a parity test or the chip smoke can
start both packages from identical state and compare them afterwards.
Nothing here imports the reference: its values arrive as numpy arrays
(or anything ``np.asarray`` takes) in NamedTuples with the same fields.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch


def words(table: np.ndarray, device="cpu") -> torch.Tensor:
    """A ``uint32`` numpy table as an ``int32`` tensor with the same bits."""
    arr = np.ascontiguousarray(table, dtype=np.uint32).view(np.int32)
    return torch.from_numpy(arr.copy()).to(device)


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def to_torch(tree: Any, like: Any, device="cpu") -> Any:
    """numpy leaves of ``tree`` as tensors on ``device``, in the
    NamedTuple types of the port tree ``like`` (matched by field name);
    ``uint32`` leaves become ``int32`` with the same bits."""
    if _is_namedtuple(like):
        return type(like)(*(to_torch(getattr(tree, f), getattr(like, f),
                                     device) for f in like._fields))
    arr = np.asarray(tree)
    if arr.dtype == np.uint32:
        arr = arr.view(np.int32)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def to_numpy(tree: Any, like: Optional[Any] = None) -> Any:
    """Tensor leaves of ``tree`` as numpy arrays; a leaf whose counterpart
    in the reference tree ``like`` is ``uint32`` is viewed as ``uint32``."""
    if _is_namedtuple(tree):
        return type(tree)(*(to_numpy(getattr(tree, f),
                                     None if like is None
                                     else getattr(like, f))
                            for f in tree._fields))
    arr = tree.detach().cpu().numpy()
    if like is not None and np.asarray(like).dtype == np.uint32:
        arr = arr.view(np.uint32)
    return arr


def lanes_from_numpy(lanes: Any, problem, device="cpu"):
    """A reference ``Lanes`` (numpy leaves) as the port's ``Lanes`` of
    ``problem``, on ``device``."""
    from repro_torch.core.engine import init_lanes
    return to_torch(lanes, init_lanes(problem, 1), device)

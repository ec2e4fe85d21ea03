"""State carried between the JAX reference and the PyTorch port.

The reference keeps bitsets as ``uint32``; the port keeps the same bits
as ``int32`` (PyTorch has no bitwise operators for ``uint32`` on the
CPU).  These functions move problem tables, whole lane states and kernel
operands across as numpy arrays, bit for bit, so a parity test or the
chip smoke can start both packages from identical state and compare them
afterwards; the service's stacked tables and lanes cross the same way,
and so do the LM's parameters (``lm_params``).  A bfloat16 array of the reference (numpy's ``ml_dtypes.bfloat16``)
crosses through a 16-bit view, never through a float round trip.
Nothing here imports the reference: its values arrive as numpy arrays
(or anything ``np.asarray`` takes) in NamedTuples with the same fields.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch


def words(table: np.ndarray, device="cpu") -> torch.Tensor:
    """A ``uint32`` numpy table as an ``int32`` tensor with the same bits."""
    return tensor(np.asarray(table, dtype=np.uint32), device)


def tensor(arr: Any, device="cpu",
           dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A reference array as a tensor with the same bits: ``uint32`` as
    ``int32``, ``bfloat16`` as ``torch.bfloat16`` (through a 16-bit view),
    anything else as its own type.  ``dtype`` then casts a float array
    (``torch.bfloat16`` rounds to nearest even, as ``jnp``'s ``astype``)."""
    arr = np.asarray(arr)
    if arr.dtype == np.uint32:
        out = torch.from_numpy(np.array(arr.view(np.int32), copy=True))
    elif arr.dtype.name == "bfloat16":
        out = torch.from_numpy(np.array(arr.view(np.int16), copy=True)).view(
            torch.bfloat16)
    else:
        out = torch.from_numpy(np.array(arr, copy=True))
    if dtype is not None:
        out = out.to(dtype)
    return out.to(device)


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def to_torch(tree: Any, like: Any, device="cpu") -> Any:
    """numpy leaves of ``tree`` as tensors on ``device``, in the
    NamedTuple types of the port tree ``like`` (matched by field name);
    ``uint32`` leaves become ``int32`` with the same bits."""
    if _is_namedtuple(like):
        return type(like)(*(to_torch(getattr(tree, f), getattr(like, f),
                                     device) for f in like._fields))
    return tensor(tree, device)


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


def stacked_tables(tables: Any, device="cpu"):
    """Service tables with numpy leaves (``uint32`` adj / fullm, ``int32``
    family: the reference's ``StackedTables`` or the port's host copy) as
    the port's device tables."""
    from repro_torch.service.batch_problem import StackedTables
    return StackedTables(
        adj=words(tables.adj, device), fullm=words(tables.fullm, device),
        family=torch.from_numpy(np.asarray(tables.family, np.int32).copy()
                                ).to(device))


def load_service_state(svc, lanes: Any, tables: Any) -> None:
    """Give the port's service ``svc`` a reference service's tables and
    ``Lanes`` (numpy leaves).  The device tables are written in place, so
    the service's round sees them."""
    from repro_torch.service.batch_problem import StackedTables
    svc.tables = StackedTables(
        adj=np.array(tables.adj, np.uint32),
        fullm=np.array(tables.fullm, np.uint32),
        family=np.array(tables.family, np.int32))
    svc._write_tables()
    svc._set_lanes(lanes_from_numpy(lanes, svc.problem, svc._home))


def _unstack(tree: Dict[str, Any], i: int) -> Dict[str, Any]:
    return {k: _unstack(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _first_leaf(tree: Dict[str, Any]) -> Any:
    v = next(iter(tree.values()))
    return _first_leaf(v) if isinstance(v, dict) else v


def lm_params(tree: Dict[str, Any], device="cpu") -> Dict[str, Any]:
    """The reference's LM parameter tree (nested dicts of numpy arrays,
    or anything ``np.asarray`` takes) as the port's, on ``device``: the
    same leaves, bit for bit (``tensor``), in the reference's ``[in,
    out]`` layout.  The stacked group axis of ``layers`` becomes a list
    of per-group dicts, and a hybrid group's ``[hybrid_period, ...]``
    mamba leaves a list of per-layer dicts."""
    from repro_torch.core.api import tree_map
    out = {k: v for k, v in tree.items() if k != "layers"}
    layers = tree["layers"]
    groups = []
    for i in range(len(_first_leaf(layers))):
        gp = _unstack(layers, i)
        if "mamba" in gp:
            period = len(_first_leaf(gp["mamba"]))
            gp["mamba"] = [_unstack(gp["mamba"], j) for j in range(period)]
        groups.append(gp)
    out["layers"] = groups
    return tree_map(lambda leaf: tensor(leaf, device), out)


def _restack(tree: Any, stack) -> Any:
    """``tree`` with every list of like trees made one tree whose leaves
    are ``stack`` of the list's leaves (inner lists first)."""
    if isinstance(tree, dict):
        return {k: _restack(v, stack) for k, v in tree.items()}
    if isinstance(tree, list):
        items = [_restack(x, stack) for x in tree]
        return _zip(items, stack)
    return tree


def _zip(items, stack):
    first = items[0]
    if isinstance(first, dict):
        return {k: _zip([it[k] for it in items], stack) for k in first}
    return stack(items)


def lm_tree(params: Dict[str, Any]) -> Dict[str, Any]:
    """The inverse of ``lm_params``: the port's LM tree (or any tree of
    its structure, such as AdamW's moments) as the reference's, nested
    dicts of numpy arrays with the group axis of ``layers`` stacked (and
    a hybrid group's mamba layers under it), each leaf bit for bit.
    numpy has no bfloat16: a bfloat16 leaf is refused."""
    from repro_torch.core.api import tree_map

    def host(leaf: torch.Tensor) -> np.ndarray:
        if leaf.dtype == torch.bfloat16:
            raise TypeError("lm_tree: numpy has no bfloat16; cast the "
                            "tree to float32 first")
        return leaf.detach().cpu().numpy()
    return _restack(tree_map(host, params), np.stack)


def lm_paths(params: Dict[str, Any]) -> list:
    """The key paths of ``lm_tree(params)``'s leaves in the reference's
    flatten order (jax sorts a dict's keys), computed from the structure
    alone."""
    ref = _restack(params, lambda items: items[0])

    def walk(tree, path):
        if isinstance(tree, dict):
            return [p for k in sorted(tree) for p in walk(tree[k],
                                                          path + (k,))]
        return [path]
    return walk(ref, ())

"""Training checkpoints (counterpart of ``repro.train.checkpoint``).

The file is the reference's: an ``.npz`` of ``leaf_i``, the leaves of
``(params, AdamState(m, v))`` in jax's flatten order of the reference's
trees (a dict's keys sorted, the group axis of ``layers`` stacked; see
``convert.lm_tree``), and ``step``.  So ``repro.train.checkpoint.restore``
resumes a file of the port and the port resumes one of the reference.
Saves are atomic (a temporary file, fsync, rename): a preempted save
leaves the previous checkpoint whole.  The data pipeline is a pure
function of ``(seed, step)``, so ``(params, opt, step)`` is the whole
state of a run.
"""

from __future__ import annotations

import io
import os
import tempfile
from typing import Any, Dict, Tuple

import numpy as np

from repro_torch.convert import lm_params, lm_paths, lm_tree
from repro_torch.core.api import tree_leaves, tree_map
from repro_torch.train.optim import AdamState

PyTree = Any


def _leaf(tree: Dict[str, Any], path: Tuple[str, ...]) -> Any:
    for key in path:
        tree = tree[key]
    return tree


def _nest(paths, leaves) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for path, leaf in zip(paths, leaves):
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return out


def save(path: str, params: PyTree, opt: AdamState, step: int) -> None:
    paths = lm_paths(params)
    leaves = [_leaf(ref, p) for ref in map(lm_tree, (params, opt.m, opt.v))
              for p in paths]
    arrays = {f"leaf_{i}": leaf for i, leaf in enumerate(leaves)}
    arrays["step"] = np.asarray(step)
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".ckpt.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(buf.getvalue())
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def restore(path: str, params_like: PyTree, opt_like: AdamState,
            device=None) -> Tuple[PyTree, AdamState, int]:
    """``(params, opt, step)`` of the file at ``path``, in the structure
    of ``params_like`` / ``opt_like`` (their shapes and dtypes checked),
    on ``device`` (default: ``params_like``'s)."""
    if device is None:
        device = tree_leaves(params_like)[0].device
    paths = lm_paths(params_like)
    with np.load(path) as z:
        step = int(z["step"])
        count = len([k for k in z.files if k.startswith("leaf_")])
        if count != 3 * len(paths):
            raise ValueError(f"{path}: {count} leaves, the model's params "
                             f"and AdamW state have {3 * len(paths)}")
        leaves = [z[f"leaf_{i}"] for i in range(count)]
    n = len(paths)
    params, m, v = (
        tree_map(lambda want, got: _same_kind(got, want, path), like,
                 lm_params(_nest(paths, leaves[i * n:(i + 1) * n]), device))
        for i, like in enumerate((params_like, opt_like.m, opt_like.v)))
    return params, AdamState(m=m, v=v), step


def _same_kind(got, want, path):
    """``got``, if it has ``want``'s shape and dtype."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise ValueError(f"{path}: a leaf of {tuple(got.shape)} "
                         f"{got.dtype} where the model has "
                         f"{tuple(want.shape)} {want.dtype}")
    return got

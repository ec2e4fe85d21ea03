"""Checkpoint / restart of the solver (counterpart of
``repro.core.checkpoint``; paper §VII).

* ``save`` — persist every lane's ``(idx, depth, base, inst, active)``,
  the counters and the per-instance incumbent table to one ``.npz``,
  written atomically.  Stacks are not saved: CONVERTINDEX replay rebuilds
  them on restore.  ``extra`` arrays (the service's tables and metadata)
  ride in the same file; host metadata that is not an array rides as JSON
  bytes (``pack_json``).
* ``restore`` — rebuild ``Lanes`` for any lane count W' (elastic).  The
  first W' live tasks are installed; the surplus comes back as an
  instance-tagged pending pool that the drivers feed to idle lanes at
  round boundaries.

The file has the reference's keys and dtypes, so a checkpoint crosses
between the two packages in either direction: each payload leaf
(``payload_i``) is written in the dtype the problem declares
(``BinaryProblem.payload_dtype``: ``uint32`` with the same bits for the
port's int32 bitsets, ``int32`` for subset sum's mask) and read back
bit for bit from either.
"""

from __future__ import annotations

import io
import json
import os
import tempfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.api import (UNVISITED, BinaryProblem, tree_leaves,
                                  tree_map)
from repro_torch.core.engine import NO_INSTANCE, Lanes, init_lanes, replay_path

_EXTRA_PREFIX = "extra_"
_STATS = ("nodes", "t_s", "t_r", "donated", "t_c")


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def save(path: str, lanes: Lanes,
         extra: Optional[Dict[str, np.ndarray]] = None,
         payload_dtype: str = "uint32") -> None:
    """Atomically persist lane control state and incumbents (not the
    stacks).  ``extra`` arrays are stored under an ``extra_`` prefix and
    returned by :func:`read_extra`.  ``payload_dtype`` is the problem's
    ``BinaryProblem.payload_dtype``: the payload leaves' int32 words are
    written as that dtype, bit for bit."""
    arrays = {
        "idx": _host(lanes.idx).astype(np.int8),
        "depth": _host(lanes.depth).astype(np.int32),
        "base": _host(lanes.base).astype(np.int32),
        "inst": _host(lanes.inst).astype(np.int32),
        "active": _host(lanes.active),
        "best": _host(lanes.best).astype(np.int32),
        "nodes": _host(lanes.nodes).astype(np.int32),
        "t_s": _host(lanes.t_s).astype(np.int32),
        "t_r": _host(lanes.t_r).astype(np.int32),
        "donated": _host(lanes.donated).astype(np.int32),
        "t_c": _host(lanes.t_c).astype(np.int32),
        "steps": _host(lanes.steps).astype(np.int32),
    }
    for i, leaf in enumerate(tree_leaves(lanes.best_payload)):
        arrays[f"payload_{i}"] = _host(leaf).view(np.dtype(payload_dtype))
    for key, val in (extra or {}).items():
        arrays[_EXTRA_PREFIX + key] = np.asarray(val)
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
        os.replace(tmp, path)          # atomic on POSIX: no torn checkpoints
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def read_extra(path: str) -> Dict[str, np.ndarray]:
    """The ``extra`` arrays stored by :func:`save`."""
    out = {}
    with np.load(path) as z:
        for key in z.files:
            if key.startswith(_EXTRA_PREFIX):
                out[key[len(_EXTRA_PREFIX):]] = z[key]
    return out


def pack_json(obj: Any) -> np.ndarray:
    """A JSON-serialisable object as a uint8 array (checkpoints are
    ``.npz`` files written without pickling).  Inverse: :func:`unpack_json`."""
    return np.frombuffer(json.dumps(obj).encode("utf-8"), np.uint8).copy()


def unpack_json(arr: np.ndarray) -> Any:
    """Decode an array written by :func:`pack_json`."""
    return json.loads(np.asarray(arr, np.uint8).tobytes().decode("utf-8"))


class PendingTask:
    """A not-yet-installed lane image (elastic surplus), instance-tagged."""

    __slots__ = ("idx", "depth", "base", "inst")

    def __init__(self, idx: np.ndarray, depth: int, base: int, inst: int = 0):
        self.idx, self.depth, self.base, self.inst = idx, depth, base, inst


def _unflatten(like: Any, leaves: List[torch.Tensor]) -> Any:
    """Leaves in ``tree_leaves`` order back into the structure of ``like``."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def place_tasks(fields: Dict[str, np.ndarray], lanes,
                tasks: List[PendingTask]) -> np.ndarray:
    """Write each task's image onto its lane (``lanes[i]`` takes
    ``tasks[i]``) in the host arrays ``fields``: the index row, UNVISITED
    past the task's prefix, ``depth``, ``base``, ``inst`` and
    ``active``.  Returns the lanes written, bool[W], for
    :func:`rebuild_stacks`.  A root is a task with an empty index at depth
    0."""
    idx = fields["idx"]
    touched = np.zeros(idx.shape[0], bool)
    for lane, task in zip(lanes, tasks):
        width = min(idx.shape[1], task.idx.shape[0])
        idx[lane] = int(UNVISITED)
        idx[lane, :width] = task.idx[:width]
        fields["depth"][lane], fields["base"][lane] = task.depth, task.base
        fields["inst"][lane], fields["active"][lane] = task.inst, True
        touched[lane] = True
    return touched


def _install(problem: BinaryProblem, new: Lanes, idx: np.ndarray,
             depth: np.ndarray, base: np.ndarray, inst: np.ndarray,
             active: np.ndarray, idle_inst: int,
             stats: Dict[str, int]) -> Tuple[Lanes, List[PendingTask]]:
    """Install the first W' live lane images onto the fresh lanes ``new``,
    replay their stacks, carry the aggregate counters on lane 0 and
    return the surplus as the pending pool."""
    num_lanes, il = new.idx.shape
    tasks = [PendingTask(idx[k].copy(), int(depth[k]), int(base[k]),
                         int(inst[k]))
             for k in range(idx.shape[0]) if active[k]]
    fields = {"idx": np.full((num_lanes, il), int(UNVISITED), np.int8),
              "depth": np.zeros((num_lanes,), np.int32),
              "base": np.zeros((num_lanes,), np.int32),
              "inst": np.full((num_lanes,), idle_inst, np.int32),
              "active": np.zeros((num_lanes,), bool)}
    touched = place_tasks(fields, range(num_lanes), tasks)
    new = new._replace(**{f: torch.from_numpy(a).to(new.idx.device)
                          for f, a in fields.items()})
    new = rebuild_stacks(problem, new, touched, fields["depth"])
    carried = {}
    for key in _STATS:
        field = getattr(new, key).clone()
        field[0] += stats.get(key, 0)
        carried[key] = field
    return new._replace(**carried), tasks[num_lanes:]


def restore(path: str, problem: BinaryProblem, num_lanes: int
            ) -> Tuple[Lanes, List[PendingTask]]:
    """Rebuild Lanes for ``num_lanes`` (elastic) plus the surplus pending
    pool, on the problem's device."""
    with np.load(path) as z:
        idx = z["idx"]
        depth, base, active = z["depth"], z["base"], z["active"]
        inst = (z["inst"] if "inst" in z
                else np.zeros(idx.shape[0], np.int32))
        best = np.atleast_1d(np.asarray(z["best"], np.int32))
        payload_leaves = []
        while f"payload_{len(payload_leaves)}" in z:
            payload_leaves.append(z[f"payload_{len(payload_leaves)}"])
        # t_c is absent from older checkpoints: carry what exists.
        stats = {k: int(z[k].sum()) for k in _STATS if k in z}
        steps = int(z["steps"])

    lanes = init_lanes(problem, num_lanes, seed_root=False)
    if best.shape[0] != problem.num_instances:
        raise ValueError(
            f"checkpoint has {best.shape[0]} instance slots, problem has "
            f"{problem.num_instances}; elastic restore varies LANES, not K")
    dev = lanes.idx.device
    # uint32 (bitsets) or int32 (subset sum): the same 32 bits either way.
    payload = (_unflatten(lanes.best_payload, [
        torch.from_numpy(np.ascontiguousarray(p).view(np.int32).copy()
                         ).to(dev) for p in payload_leaves])
        if payload_leaves else lanes.best_payload)
    lanes = lanes._replace(
        best=torch.from_numpy(best.copy()).to(dev), best_payload=payload,
        steps=torch.tensor(steps, dtype=torch.int32, device=dev))
    return _install(problem, lanes, idx, depth, base, inst, active, 0, stats)


def repartition(problem: BinaryProblem, lanes: Lanes, num_lanes: int
                ) -> Tuple[Lanes, List[PendingTask]]:
    """In-memory elastic W -> W' re-layout (restore without the file): the
    first W' live tasks go onto fresh lanes, the surplus becomes the
    pending pool, aggregate counters ride on lane 0.  Idle lanes of the
    new pool start unbound (NO_INSTANCE)."""
    stats = {k: int(getattr(lanes, k).sum()) for k in _STATS}
    new = init_lanes(problem, num_lanes, seed_root=False)
    dev = new.idx.device
    new = new._replace(
        best=lanes.best.to(dev).clone(),
        best_payload=tree_map(lambda p: p.to(dev).clone(),
                              lanes.best_payload),
        steps=lanes.steps.to(dev).clone())
    return _install(problem, new, _host(lanes.idx), _host(lanes.depth),
                    _host(lanes.base), _host(lanes.inst), _host(lanes.active),
                    NO_INSTANCE, stats)


#: ``rebuild_stacks`` calls since the last ``reset_rebuilds()``: the
#: calls, the lanes they replayed (the touched lanes) and the batched
#: ``apply`` passes they ran.
REBUILDS: Dict[str, int] = dict.fromkeys(("calls", "lanes", "passes"), 0)


def reset_rebuilds() -> None:
    for name in REBUILDS:
        REBUILDS[name] = 0


def rebuild_stacks(problem: BinaryProblem, lanes: Lanes, touched: np.ndarray,
                   depth: np.ndarray) -> Lanes:
    """CONVERTINDEX for the lanes the caller just wrote: replay the path
    bits ``idx[0..depth-1]`` (delegation marks flattened to the branch
    taken, LEFT) from the root of each lane's own instance.  One batched
    replay, one kernel launch a pass on the card.

    ``touched`` (bool[W] on the host) names the written lanes and
    ``depth`` is the caller's host copy of ``depth``: the replay runs as
    many passes as the deepest touched lane needs (0 for roots alone) and
    keeps its rows for the touched lanes only.  Every other lane keeps its
    stack, which for an active lane is what its own replay gives
    (DESIGN.md §4).  With no lane touched nothing runs."""
    count = int(touched.sum())
    if count == 0:
        return lanes
    passes = int(depth[touched].max())
    REBUILDS["calls"] += 1
    REBUILDS["lanes"] += count
    REBUILDS["passes"] += passes
    keep = torch.from_numpy(touched).to(lanes.idx.device)
    bits = torch.where(lanes.idx < 0, 0, lanes.idx).to(torch.int8)
    k = lanes.best.shape[0]
    safe_inst = lanes.inst.clamp(0, k - 1)
    stacks = replay_path(problem, bits, lanes.depth, lanes.stack, safe_inst,
                         passes)
    stack = tree_map(
        lambda new, old: torch.where(
            keep.reshape((-1,) + (1,) * (old.dim() - 1)), new, old),
        stacks, lanes.stack)
    return lanes._replace(stack=stack)


def install_pending(problem: BinaryProblem, lanes: Lanes,
                    pool: List[PendingTask]
                    ) -> Tuple[Lanes, List[PendingTask]]:
    """Feed pending-pool entries to idle lanes (drivers, round
    boundaries); each counts one receipt in ``t_s``."""
    if not pool:
        return lanes, pool
    fields = {f: _host(getattr(lanes, f)).copy()
              for f in ("idx", "depth", "base", "inst", "active", "t_s")}
    idle = np.flatnonzero(~fields["active"])[:len(pool)]
    if idle.size == 0:
        return lanes, pool
    touched = place_tasks(fields, idle, pool)
    fields["t_s"][touched] += 1
    lanes = lanes._replace(**{f: torch.from_numpy(a).to(lanes.idx.device)
                              for f, a in fields.items()})
    return (rebuild_stacks(problem, lanes, touched, fields["depth"]),
            pool[idle.size:])

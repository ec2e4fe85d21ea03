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
between the two packages in either direction: the port's int32 bitsets
(``payload_i``) are written as ``uint32`` with the same bits and read
back the same way.
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
         extra: Optional[Dict[str, np.ndarray]] = None) -> None:
    """Atomically persist lane control state and incumbents (not the
    stacks).  ``extra`` arrays are stored under an ``extra_`` prefix and
    returned by :func:`read_extra`."""
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
    # Every payload of the port is a bitset: int32 words holding the
    # reference's uint32 bits.
    for i, leaf in enumerate(tree_leaves(lanes.best_payload)):
        arrays[f"payload_{i}"] = _host(leaf).view(np.uint32)
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


def _install(problem: BinaryProblem, new: Lanes, idx: np.ndarray,
             depth: np.ndarray, base: np.ndarray, inst: np.ndarray,
             active: np.ndarray, idle_inst: int,
             stats: Dict[str, int]) -> Tuple[Lanes, List[PendingTask]]:
    """Install the first W' live lane images onto the fresh lanes ``new``,
    replay their stacks, carry the aggregate counters on lane 0 and
    return the surplus as the pending pool."""
    num_lanes, il = new.idx.shape
    dev = new.idx.device
    live = [k for k in range(idx.shape[0]) if active[k]]
    installed, pending = live[:num_lanes], live[num_lanes:]

    new_idx = np.full((num_lanes, il), int(UNVISITED), np.int8)
    new_depth = np.zeros((num_lanes,), np.int32)
    new_base = np.zeros((num_lanes,), np.int32)
    new_inst = np.full((num_lanes,), idle_inst, np.int32)
    new_active = np.zeros((num_lanes,), bool)
    for j, k in enumerate(installed):
        w = min(il, idx.shape[1])
        new_idx[j, :w] = idx[k, :w]
        new_depth[j], new_base[j] = depth[k], base[k]
        new_inst[j], new_active[j] = inst[k], True

    def dev_t(a):
        return torch.from_numpy(a).to(dev)

    new = new._replace(idx=dev_t(new_idx), depth=dev_t(new_depth),
                       base=dev_t(new_base), inst=dev_t(new_inst),
                       active=dev_t(new_active))
    new = rebuild_stacks(problem, new)
    carried = {}
    for key in _STATS:
        field = getattr(new, key).clone()
        field[0] += stats.get(key, 0)
        carried[key] = field
    new = new._replace(**carried)
    pool = [PendingTask(idx[k].copy(), int(depth[k]), int(base[k]),
                        int(inst[k]))
            for k in pending]
    return new, pool


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


def rebuild_stacks(problem: BinaryProblem, lanes: Lanes) -> Lanes:
    """CONVERTINDEX for every active lane: replay the path bits
    ``idx[0..depth-1]`` (delegation marks flattened to the branch taken,
    LEFT) from the root of the lane's own instance.  One batched replay
    over all lanes: IDX_LEN ``apply`` calls, one kernel launch each on the
    card."""
    bits = torch.where(lanes.idx < 0, 0, lanes.idx).to(torch.int8)
    k = lanes.best.shape[0]
    safe_inst = lanes.inst.clamp(0, k - 1)
    stacks = replay_path(problem, bits, lanes.depth, lanes.stack, safe_inst)
    keep = lanes.active
    stack = tree_map(
        lambda new, old: torch.where(
            keep.reshape((-1,) + (1,) * (old.dim() - 1)), new, old),
        stacks, lanes.stack)
    return lanes._replace(stack=stack)


def install_pending(problem: BinaryProblem, lanes: Lanes,
                    pool: List[PendingTask]
                    ) -> Tuple[Lanes, List[PendingTask]]:
    """Feed pending-pool entries to idle lanes (drivers, round
    boundaries)."""
    if not pool:
        return lanes, pool
    active = _host(lanes.active)
    idle = [i for i in range(active.shape[0]) if not active[i]]
    n = min(len(idle), len(pool))
    if n == 0:
        return lanes, pool
    il = lanes.idx.shape[1]
    idxs = _host(lanes.idx).copy()
    depth = _host(lanes.depth).copy()
    base = _host(lanes.base).copy()
    inst = _host(lanes.inst).copy()
    act = active.copy()
    t_s = _host(lanes.t_s).copy()
    for lane, task in zip(idle[:n], pool[:n]):
        w = min(il, task.idx.shape[0])
        idxs[lane, :w] = task.idx[:w]
        depth[lane], base[lane], act[lane] = task.depth, task.base, True
        inst[lane] = task.inst
        t_s[lane] += 1
    dev = lanes.idx.device

    def dev_t(a):
        return torch.from_numpy(a).to(dev)

    lanes = lanes._replace(
        idx=dev_t(idxs), depth=dev_t(depth), base=dev_t(base),
        inst=dev_t(inst), active=dev_t(act), t_s=dev_t(t_s))
    return rebuild_stacks(problem, lanes), pool[n:]

"""The program's lane state read into the reference's layout: a dict of
numpy arrays with bitset words as ``uint32`` (the program keeps their
bits in ``int32``)."""

from __future__ import annotations

import numpy as np

from portbench.reference.engine import LANE_FIELDS


def _np(t) -> np.ndarray:
    a = t.detach().cpu().numpy()
    return a.view(np.uint32) if a.dtype == np.int32 else a


def to_numpy(lanes, leaves) -> dict:
    """``lanes`` (the program's ``Lanes``) as the reference's dict;
    ``leaves`` names the stack's state fields in order."""
    out = {f: getattr(lanes, f).detach().cpu().numpy() for f in LANE_FIELDS}
    stack = lanes.stack
    out["stack"] = {}
    for f in leaves:
        a = getattr(stack, f).detach().cpu().numpy()
        out["stack"][f] = a if f == "size" else a.view(np.uint32)
    out["best"] = lanes.best.detach().cpu().numpy()
    out["best_payload"] = _np(lanes.best_payload)
    out["steps"] = np.int32(int(lanes.steps))
    return out

"""Plain NumPy reference of the lane-parallel search (PARALLEL-RB).

W lanes advance together; a round is ``steps`` engine steps, then one
intra-device steal (heaviest task first) and the per-instance open-work
count.  The semantics are the paper's (Abu-Khzam et al. 2013, §IV):

* a lane holds a bit path ``idx`` (UNVISITED, DELEGATED, LEFT, RIGHT per
  depth), its depth, the root depth ``base`` of the subtree it owns, and a
  stack of search-node states along the path;
* a step visits the node at the top of every active lane: the first
  arrival tests it (solution, bound against the incumbent) and descends
  to the left child, a return from a finished left subtree descends to
  the right child, anything else backtracks;
* the incumbent of each instance is the least solution value found, its
  payload from the lowest lane id that found it;
* the steal matches the r-th idle lane of an instance (by lane id) with
  the r-th donor (shallowest open LEFT slot, then lane id); the donor
  marks the slot DELEGATED and the thief replays the path from the root.

State is a dict of numpy arrays with the field names and dtypes the
benchmark reads off the program's lanes (bitset words as ``uint32``), so
the two can be compared field by field.  Node evaluation is the
problem's (``reference/vc.py``, ``reference/ds.py``), computed from the
dense adjacency.  Nothing here imports the program.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

UNVISITED = -2
DELEGATED = -1
LEFT = 0
RIGHT = 1
#: The "no solution yet" incumbent (int32-safe).
INF = 2 ** 30

#: The fields held once per lane (``best``, ``best_payload`` are per
#: instance, ``steps`` one count).
LANE_FIELDS = ("idx", "depth", "base", "inst", "active", "nodes", "t_s",
               "t_r", "donated", "t_c")


def init_lanes(problem, num_lanes: int) -> Dict:
    """W idle lanes with the root of the instance in lane 0 (one
    instance, every lane bound to it)."""
    il = problem.n + 1
    sl = problem.n + 2
    root = problem.root()
    stack = {}
    for f, leaf in root.items():
        buf = np.zeros((num_lanes, sl) + leaf.shape, leaf.dtype)
        buf[0, 0] = leaf
        stack[f] = buf
    z = lambda: np.zeros(num_lanes, np.int32)      # noqa: E731
    active = np.zeros(num_lanes, bool)
    active[0] = True
    t_s = z()
    t_s[0] = 1
    return dict(idx=np.full((num_lanes, il), UNVISITED, np.int8),
                depth=z(), base=z(), inst=z(), active=active, stack=stack,
                best=np.full(1, INF, np.int32),
                best_payload=np.zeros((1,) + problem.payload_shape,
                                      np.uint32),
                nodes=z(), t_s=t_s, t_r=z(), donated=z(), t_c=z(),
                steps=np.int32(0))


def copy_lanes(lanes: Dict) -> Dict:
    out = {k: (np.array(v) if k != "stack" else
               {f: s.copy() for f, s in v.items()}) for k, v in lanes.items()}
    out["steps"] = np.int32(lanes["steps"])
    return out


def step(problem, L: Dict, slack: int = 0) -> None:
    """One engine step over every lane, in place.  ``slack`` > 0 prunes a
    node whose bound is within ``slack`` of the incumbent: the control,
    which no longer proves the incumbent optimal."""
    idx = L["idx"]
    w, il = idx.shape
    k = L["best"].shape[0]
    ar = np.arange(w)
    active = L["active"]
    if not active.any():
        return
    safe_inst = np.clip(L["inst"], 0, k - 1)
    best_lane = L["best"][safe_inst]
    d = np.clip(L["depth"], 0, il - 1)
    c = idx[ar, d]
    first = c == UNVISITED

    act = np.nonzero(active)[0]
    states = {f: s[act, d[act]] for f, s in L["stack"].items()}
    ev = problem.evaluate(states, L["inst"][act])
    is_sol = np.zeros(w, bool)
    value = np.zeros(w, np.int64)
    lb = np.zeros(w, np.int64)
    is_sol[act] = ev["is_solution"]
    value[act] = ev["value"]
    lb[act] = ev["lower_bound"]

    improved = active & first & is_sol & (value < best_lane)
    best_eff = np.where(improved, value, best_lane)
    terminal = is_sol | (lb + slack >= best_eff)
    take_right = ~first & (c == LEFT)
    descend = active & ((first & ~terminal) | take_right)

    # Push the child of every descending lane at row depth + 1.
    go = descend[act]
    lanes_go = act[go]
    rows = d[lanes_go] + 1
    left_pick = first[lanes_go]
    for f, s in L["stack"].items():
        child = np.where(_bcast(left_pick, ev["left"][f][go]),
                         ev["left"][f][go], ev["right"][f][go])
        s[lanes_go, rows] = child

    slot_now = np.where(descend & first, LEFT,
                        np.where(descend & take_right, RIGHT, c))
    idx[ar, d] = np.where(active, slot_now, c)
    cpos = np.minimum(d + 1, il - 1)
    idx[ar, cpos] = np.where(descend, UNVISITED, idx[ar, cpos])

    depth = np.where(active, np.where(descend, L["depth"] + 1,
                                      L["depth"] - 1), L["depth"])
    L["active"] = active & (depth >= L["base"])
    L["depth"] = np.maximum(depth, 0).astype(np.int32)
    L["nodes"] = (L["nodes"] + (active & first)).astype(np.int32)

    # Incumbent election per instance: least value, lowest lane id.
    winners = np.nonzero(improved)[0]
    if winners.size:
        payload = np.zeros((w,) + L["best_payload"].shape[1:], np.uint32)
        payload[act] = ev["payload"]
        for inst in np.unique(safe_inst[winners]):
            mine = winners[safe_inst[winners] == inst]
            least = value[mine].min()
            if least < L["best"][inst]:
                lane = mine[value[mine] == least].min()
                L["best"][inst] = least
                L["best_payload"][inst] = payload[lane]
    L["steps"] = np.int32(L["steps"] + 1)


def _bcast(pred: np.ndarray, like: np.ndarray) -> np.ndarray:
    return pred.reshape(pred.shape + (1,) * (like.ndim - pred.ndim))


def open_slots(L: Dict) -> np.ndarray:
    """Per lane the shallowest open (stealable) slot: ``idx[j] == LEFT``
    with ``base <= j < depth``; ``IDX_LEN`` when there is none."""
    idx = L["idx"]
    il = idx.shape[1]
    j = np.arange(il)
    open_ = ((idx == LEFT) & (j[None, :] >= L["base"][:, None])
             & (j[None, :] < L["depth"][:, None]))
    return np.where(open_.any(axis=1), open_.argmax(axis=1), il
                    ).astype(np.int64)


def balance(problem, L: Dict) -> None:
    """One intra-device steal, in place."""
    idx = L["idx"]
    w, il = idx.shape
    slots = open_slots(L)
    bound = L["inst"] >= 0
    thieves = ~L["active"] & bound
    donors = L["active"] & bound & (slots < il)
    L["t_r"] = (L["t_r"] + thieves).astype(np.int32)

    src = np.zeros(w, np.int64)
    matched = np.zeros(w, bool)
    is_donor = np.zeros(w, bool)
    for inst in np.unique(L["inst"][thieves]):
        t = np.nonzero(thieves & (L["inst"] == inst))[0]      # by lane id
        dl = np.nonzero(donors & (L["inst"] == inst))[0]
        dl = dl[np.lexsort((dl, slots[dl]))]                 # heaviest first
        m = min(t.size, dl.size)
        src[t[:m]] = dl[:m]
        matched[t[:m]] = True
        is_donor[dl[:m]] = True
    if not matched.any():
        return

    j = np.arange(il)
    # The thief's path: the donor's prefix with delegations flattened to
    # LEFT, RIGHT at the donor's slot, UNVISITED beyond.
    s_src = slots[src]
    prefix = np.where(idx[src] < 0, LEFT, idx[src])
    bits = np.where(j[None, :] < s_src[:, None], prefix, UNVISITED)
    bits = np.where(j[None, :] == s_src[:, None], RIGHT, bits).astype(np.int8)
    # The donor marks its slot DELEGATED.
    dd = np.nonzero(is_donor)[0]
    idx[dd, slots[dd]] = DELEGATED
    L["donated"] = (L["donated"] + is_donor).astype(np.int32)

    got = matched & ~L["active"]
    tdepth = (s_src + 1).astype(np.int32)
    idx[got] = bits[got]
    L["depth"] = np.where(got, tdepth, L["depth"]).astype(np.int32)
    L["base"] = np.where(got, tdepth, L["base"]).astype(np.int32)
    L["inst"] = np.where(got, L["inst"][src], L["inst"]).astype(np.int32)
    L["active"] = L["active"] | got
    L["t_s"] = (L["t_s"] + got).astype(np.int32)
    replay(problem, L, np.nonzero(got)[0])


def replay(problem, L: Dict, lanes: np.ndarray) -> None:
    """Rebuild the stack of each lane in ``lanes`` from its instance's root
    along its path: row 0 the root, row j + 1 the state after j + 1
    branches; rows below the path keep what they held."""
    if lanes.size == 0:
        return
    depth = L["depth"][lanes]
    state = problem.root_batch(L["inst"][lanes])
    for f, s in L["stack"].items():
        s[lanes, 0] = state[f]
    for j in range(int(depth.max())):
        live = depth > j
        sel = lanes[live]
        sub = {f: v[live] for f, v in state.items()}
        ev = problem.evaluate(sub, L["inst"][sel])
        right = L["idx"][sel, j] == RIGHT
        for f, s in L["stack"].items():
            child = np.where(_bcast(right, ev["right"][f]), ev["right"][f],
                             ev["left"][f])
            state[f][live] = child
            s[sel, j + 1] = child


def open_work(L: Dict) -> np.ndarray:
    """Per instance: active lanes plus those with a donatable slot."""
    k = L["best"].shape[0]
    il = L["idx"].shape[1]
    slots = open_slots(L)
    contrib = L["active"].astype(np.int64) + (L["active"] & (slots < il))
    out = np.zeros(k, np.int64)
    np.add.at(out, np.clip(L["inst"], 0, k - 1), contrib)
    return out


def round_(problem, L: Dict, steps: int, slack: int = 0
           ) -> Tuple[Dict, np.ndarray]:
    """One round on a copy of ``L``: ``steps`` engine steps, the steal,
    the open-work count.  The input is left as it was."""
    L = copy_lanes(L)
    for _ in range(steps):
        if not L["active"].any():
            break                   # a step with no active lane is a no-op
        step(problem, L, slack)
    balance(problem, L)
    return L, open_work(L)


def solve(problem, num_lanes: int, steps: int, slack: int = 0,
          max_rounds: int = 100000) -> Tuple[Dict, Dict]:
    """Rounds from the root until no work is open: the solve's counters
    (``best``, ``rounds``, ``nodes``, ``t_s``, ``t_r``, ``donated``) and the
    final lanes."""
    L = init_lanes(problem, num_lanes)
    rounds = 0
    while rounds < max_rounds:
        L, work = round_(problem, L, steps, slack)
        rounds += 1
        if int(work.sum()) == 0:
            break
    stats = dict(best=int(L["best"].min()), rounds=rounds,
                 nodes=int(L["nodes"].sum()), t_s=int(L["t_s"].sum()),
                 t_r=int(L["t_r"].sum()), donated=int(L["donated"].sum()))
    return stats, L


def mismatches(ref: Dict, got: Dict) -> Dict[str, int]:
    """Rows that differ, field by field (a lane's row of a lane field, an
    instance's entry of ``best`` / ``best_payload``, the step count)."""
    out = {}
    for f in LANE_FIELDS + ("best",):
        out[f] = int(np.count_nonzero(_rows_differ(ref[f], got[f])))
    out["best_payload"] = int(np.count_nonzero(
        _rows_differ(ref["best_payload"], got["best_payload"])))
    out["steps"] = int(int(ref["steps"]) != int(got["steps"]))
    for f, s in ref["stack"].items():
        out["stack." + f] = int(np.count_nonzero(
            _rows_differ(s, got["stack"][f])))
    return out


def _rows_differ(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape:
        return np.ones(max(a.shape[:1] or (1,)), bool)
    diff = a != b
    return diff.reshape(diff.shape[0], -1).any(axis=1) if diff.ndim > 1 \
        else diff


"""Vectorised recursive-backtracking engine on PyTorch (counterpart of
``repro.core.engine``).

A *lane* is an independent depth-first searcher whose control state is
the paper's ``current_idx`` array plus a stack of search-node states
along its live root-to-node path.  W lanes advance together; one engine
step visits one search-node per active lane through ONE batched
``evaluate_batch`` call (one kernel launch on the card).

Control encoding per lane (paper Fig. 2/3): ``idx[j]`` ∈ {UNVISITED,
DELEGATED, LEFT, RIGHT} is the branch taken from depth ``j`` to ``j+1``;
``depth`` is the current node's depth (its state is ``stack[depth]``);
``base`` is the root depth of the subtree the lane owns.

Every function here is functional — it returns new tensors and leaves
its inputs untouched — and none reads a value back to the host, so a
whole round runs without a host sync.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch.core.api import (INF_VALUE, LEFT, RIGHT, UNVISITED,
                                  BinaryProblem, bcast, root_of, tree_leaves,
                                  tree_map, tree_select)
from repro_torch.kernels import _build
from repro_torch.obs import spans

PyTree = Any

#: ``Lanes.inst`` of a lane bound to no instance.  Such a lane never
#: steals and never donates; the service driver retargets it.
NO_INSTANCE = -1


class Lanes(NamedTuple):
    """State of W lanes on one device; the reference's fields and dtypes.

    K = ``problem.num_instances`` instances share the lane pool; each lane
    serves one instance (``inst``) and the incumbent is a per-instance
    table.  K = 1 for an ordinary solve.
    """

    idx: torch.Tensor         # int8  [W, IDX_LEN]
    depth: torch.Tensor       # int32 [W]
    base: torch.Tensor        # int32 [W]
    inst: torch.Tensor        # int32 [W]  (< 0: bound to no instance)
    active: torch.Tensor      # bool  [W]
    stack: PyTree             # leaves [W, STACK_LEN, ...]
    best: torch.Tensor        # int32 [K]  — per-instance incumbent value
    best_payload: PyTree      # leaves [K, ...] — per-instance incumbent
    nodes: torch.Tensor       # int32 [W]  — search-nodes visited
    t_s: torch.Tensor         # int32 [W]  — tasks received (paper's T_S)
    t_r: torch.Tensor         # int32 [W]  — task requests made (T_R)
    donated: torch.Tensor     # int32 [W]  — tasks donated
    t_c: torch.Tensor         # int32 [W]  — tasks received cross-device
    steps: torch.Tensor       # int32 []   — engine steps executed


def idx_len(problem: BinaryProblem) -> int:
    return problem.max_depth + 1


def stack_len(problem: BinaryProblem) -> int:
    return problem.max_depth + 2


def init_lanes(problem: BinaryProblem, num_lanes: int,
               seed_root: bool = True, bind_instance: bool = True) -> Lanes:
    """Allocate W idle lanes on the problem's device; with ``seed_root``
    lane 0 holds the root task N_{0,0} of instance 0.

    ``bind_instance=False`` starts every lane unbound (``inst ==
    NO_INSTANCE``): the service's pool, where a lane acquires an instance
    at admission or steal time.
    """
    w, il, sl = num_lanes, idx_len(problem), stack_len(problem)
    k = problem.num_instances
    root = problem.root()
    dev = tree_leaves(root)[0].device

    def alloc(leaf):
        buf = torch.zeros((w, sl) + tuple(leaf.shape), dtype=leaf.dtype,
                          device=dev)
        if seed_root:
            buf[0, 0] = leaf
        return buf

    def zeros():
        return torch.zeros(w, dtype=torch.int32, device=dev)

    active = torch.zeros(w, dtype=torch.bool, device=dev)
    t_s = zeros()
    if seed_root:
        active[0] = True
        t_s[0] = 1
    return Lanes(
        idx=torch.full((w, il), UNVISITED, dtype=torch.int8, device=dev),
        depth=zeros(),
        base=zeros(),
        inst=(zeros() if bind_instance else torch.full(
            (w,), NO_INSTANCE, dtype=torch.int32, device=dev)),
        active=active,
        stack=tree_map(alloc, root),
        best=torch.full((k,), INF_VALUE, dtype=torch.int32, device=dev),
        best_payload=tree_map(
            lambda p: p.unsqueeze(0).expand((k,) + tuple(p.shape)).clone(),
            problem.payload_zero()),
        nodes=zeros(),
        t_s=t_s,
        t_r=zeros(),
        donated=zeros(),
        t_c=zeros(),
        steps=torch.zeros((), dtype=torch.int32, device=dev),
    )


def _count_push(stack: PyTree) -> None:
    """Count a step's stack clones in ``_build.LAUNCHES["stack_push_bytes"]``:
    ``push`` allocates and writes every stack leaf whole, to write one row
    a lane.  Counted on the host, so a graph replay adds what its capture
    counted; a dry run's ``meta`` stack counts nothing."""
    leaves = tree_leaves(stack)
    if leaves[0].device.type != "meta":
        _build.LAUNCHES["stack_push_bytes"] += sum(
            s.numel() * s.element_size() for s in leaves)


def make_step(problem: BinaryProblem):
    """Build the one-step transition Lanes -> Lanes: select every lane's
    node off its stack, evaluate all lanes in one batched call, advance
    each lane (descend or backtrack), then elect the incumbent per
    instance."""

    def step(lanes: Lanes) -> Lanes:
        w, il = lanes.idx.shape
        k = lanes.best.shape[0]
        dev = lanes.idx.device
        ar = torch.arange(w, device=dev)
        safe_inst = lanes.inst.clamp(0, k - 1)
        # Each lane prunes against ITS instance's incumbent.
        best_lane = lanes.best[safe_inst]

        # select → evaluate
        d = lanes.depth.clamp(0, il - 1)
        ev = problem.evaluate_batch(tree_map(lambda s: s[ar, d], lanes.stack),
                                    best_lane)

        # advance (paper Fig. 3), branchless over lanes
        active = lanes.active
        c = lanes.idx[ar, d]
        first = c == UNVISITED
        improved = active & first & ev.is_solution & (ev.value < best_lane)
        best_eff = torch.where(improved, ev.value, best_lane)
        terminal = ev.is_solution | (ev.lower_bound >= best_eff)
        # Left child on first arrival, right after a completed left subtree.
        take_right = ~first & (c == LEFT)
        descend = active & ((first & ~terminal) | take_right)
        child = tree_select(first, ev.left, ev.right)

        wpos = d + 1                                   # stack has IDX_LEN+1 rows

        def push(s, ch):
            out = s.clone()
            out[ar, wpos] = torch.where(bcast(descend, ch), ch, s[ar, wpos])
            return out

        stack = tree_map(push, lanes.stack, child)
        _count_push(lanes.stack)

        # current_idx maintenance (paper Fig. 3, line 4); a fresh child
        # slot starts UNVISITED.
        slot_now = torch.where(descend & first, LEFT,
                               torch.where(descend & take_right, RIGHT, c))
        idx = lanes.idx.clone()
        idx[ar, d] = torch.where(active, slot_now, c)
        cpos = (d + 1).clamp(max=il - 1)
        idx[ar, cpos] = torch.where(descend, UNVISITED, idx[ar, cpos])

        depth = torch.where(active, torch.where(descend, lanes.depth + 1,
                                                lanes.depth - 1), lanes.depth)
        new_active = active & (depth >= lanes.base)
        depth = depth.clamp(min=0)
        visited = active & first

        # Incumbent election per instance: segment-min of the improved
        # values over ``inst``; the lowest-id winning lane supplies the
        # payload.
        vals = torch.where(improved, ev.value, INF_VALUE)
        seg_index = safe_inst.long()
        seg = torch.full((k,), INF_VALUE, dtype=torch.int32,
                         device=dev).scatter_reduce(0, seg_index, vals, "amin",
                                                    include_self=True)
        any_improved = seg < lanes.best
        lane_ids = torch.arange(w, dtype=torch.int32, device=dev)
        winner = torch.full((k,), w, dtype=torch.int32, device=dev
                            ).scatter_reduce(
            0, seg_index,
            torch.where(improved & (vals == seg[safe_inst]), lane_ids, w),
            "amin", include_self=True)
        safe_winner = winner.clamp(0, w - 1)
        payload = tree_map(
            lambda p, old: torch.where(bcast(any_improved, old),
                                       p[safe_winner], old),
            ev.payload, lanes.best_payload)
        return lanes._replace(
            idx=idx, depth=depth, active=new_active, stack=stack,
            best=torch.minimum(lanes.best, seg), best_payload=payload,
            nodes=lanes.nodes + visited.to(torch.int32),
            steps=lanes.steps + 1)

    return step


def make_expand(problem: BinaryProblem, num_steps: int):
    """Run ``num_steps`` engine steps: the compute phase between steal
    rounds.

    The reference leaves its device loop as soon as no lane is active.
    Here every step runs, predicated: with no lane active a step changes
    no field but ``steps``, so adding ``any(active)`` to ``steps`` on the
    device keeps every field bitwise equal to the reference with no host
    sync inside the round.
    """
    step = make_step(problem)

    def expand(lanes: Lanes) -> Lanes:
        with spans.span("expand", device=True):
            for _ in range(num_steps):
                ran = lanes.active.any().to(torch.int32)
                lanes = step(lanes)._replace(steps=lanes.steps + ran)
        return lanes

    return expand


def replay_path(problem: BinaryProblem, bits: torch.Tensor,
                path_depth: torch.Tensor, stack: PyTree,
                inst: torch.Tensor, passes: Optional[int] = None) -> PyTree:
    """CONVERTINDEX for every lane: rebuild each lane's state stack for its
    task index (paper §IV-A).

    ``bits`` int8[W, IDX_LEN] (delegation marks already flattened by
    FIXINDEX), ``path_depth`` int32[W], ``stack`` leaves [W, STACK_LEN,
    ...], ``inst`` int32[W].  Row 0 becomes the lane's instance root and
    rows 1..path_depth the states along the path; deeper rows keep their
    old contents.  Costs ``passes`` (default IDX_LEN) batched ``apply``
    calls — one kernel launch each on the card.  A caller that knows every
    ``path_depth`` it keeps is at most ``passes`` gets the same rows for
    those lanes: rows past ``passes`` are copied from ``stack``.
    """
    passes = bits.shape[1] if passes is None else passes
    state = root_of(problem, inst)
    rows = [state]
    for j in range(passes):
        bit = bits[:, j].to(torch.int32).clamp(0, 1)
        take = j < path_depth
        state = tree_select(take, problem.apply(state, bit), state)
        rows.append(tree_select(
            take, state, tree_map(lambda s: s[:, j + 1], stack)))
    out = tree_map(lambda *r: torch.stack(r, dim=1), *rows)
    if passes < bits.shape[1]:
        out = tree_map(lambda o, s: torch.cat([o, s[:, passes + 1:]], dim=1),
                       out, stack)
    return out

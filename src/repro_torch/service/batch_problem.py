"""Stacked multi-instance problems for the solver service (counterpart of
``repro.service.batch_problem``).

The service puts MANY instances on one lane pool.  ``StackedSpec``
describes K instance *slots*, each a graph padded to a common vertex
count ``n`` (padding vertices are isolated and start dead, so every
padded vertex has count -1 in the shared pass and the tree of the
unpadded instance is unchanged).  Two families share the slots:

  FAMILY_VC — minimum vertex cover (``adj`` row block = adjacency);
  FAMILY_DS — minimum dominating set (``adj`` row block = CLOSED adjacency).

Both funnel their per-node work through ONE masked-popcount pass: for VC
the mask is the alive set and the counts are residual degrees; for DS the
mask is the undominated set and the counts are coverage.  The bound
problem's ``evaluate_batch`` makes one ``stacked_count_stats`` launch for
all lanes per call (the CUDA kernel for tables on the card, the plain
version for tables on the CPU) and blends the family-specific solution
test, bound, children and payload branchlessly.

``StackedTables`` holds device tensors that the service preallocates and
writes in place at admission: the problem returned by ``bind`` closes
over those very tensors, so it sees every admission without a rebind.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.convert import words
from repro_torch.core.api import (INF_VALUE, BinaryProblem, NodeEval,
                                  resolve_device, tree_map, tree_select)
from repro_torch.kernels.bitset_ops import stacked_count_stats
from repro_torch.kernels.ref import popcount
from repro_torch.problems.graphs import Graph, full_mask, num_words
from repro_torch.problems.vertex_cover import BIT_WORDS, vbit

FAMILY_VC = 0
FAMILY_DS = 1


class StackedTables(NamedTuple):
    """Per-slot instance data (numpy on the host, tensors on the device;
    bitsets are uint32 in numpy and int32 with the same bits as tensors)."""

    adj: object      # [K, n, w] — adjacency (vc) / closed adjacency (ds)
    fullm: object    # [K, w]    — the slot's real-vertex mask
    family: object   # int32[K]  — FAMILY_VC | FAMILY_DS


class SvcState(NamedTuple):
    """Union state: (a, b, c) mean (alive, cover, -) for VC and
    (dominated, cand, chosen) for DS.  ``inst`` rides in the state so
    that the evaluation can index the stacked tables; ``Lanes.inst`` is
    the engine-side authority and the two stay equal by construction
    (roots embed it, children inherit it)."""

    inst: torch.Tensor    # int32[...]
    a: torch.Tensor       # int32[..., w]
    b: torch.Tensor       # int32[..., w]
    c: torch.Tensor       # int32[..., w]
    size: torch.Tensor    # int32[...]


def pack_instance(graph: Graph, family: int, n: int
                  ) -> Tuple[np.ndarray, np.ndarray, int]:
    """Pad one instance to ``n`` vertices: (adj uint32[n, w], fullm
    uint32[w], family).  For FAMILY_DS the row block is the CLOSED
    adjacency N[v]."""
    if graph.n > n:
        raise ValueError(f"instance n={graph.n} exceeds slot size n={n}")
    w = num_words(n)
    adj = np.zeros((n, w), np.uint32)
    adj[:graph.n, :graph.words] = graph.adj
    if family == FAMILY_DS:
        for v in range(graph.n):
            adj[v, v // 32] |= np.uint32(1) << np.uint32(v % 32)
    elif family != FAMILY_VC:
        raise ValueError(f"unknown family {family!r}")
    fm = np.zeros(w, np.uint32)
    fm[:graph.words] = full_mask(graph.n)
    return adj, fm, family


@dataclasses.dataclass(frozen=True)
class StackedSpec:
    """Static shape of a service deployment: K slots of up-to-n vertices."""

    n: int          # padded vertex count (max instance size)
    k: int          # instance slots multiplexed over the lane pool

    @property
    def words(self) -> int:
        return num_words(self.n)

    def empty_tables(self) -> StackedTables:
        """Host numpy tables with every slot free (edgeless VC; free slots
        are never seeded)."""
        return StackedTables(
            adj=np.zeros((self.k, self.n, self.words), np.uint32),
            fullm=np.zeros((self.k, self.words), np.uint32),
            family=np.zeros((self.k,), np.int32))

    def stats_inputs(self, tables: StackedTables, states: SvcState):
        """The shared pass's operands for every lane: ``(inst, mask,
        valid)`` with the instance id clipped to [0, K-1] (a lane of no
        instance evaluates against slot 0 and is discarded, as in the
        reference).

        VC: mask = valid = alive set  -> counts = residual degrees.
        DS: mask = undominated set, valid = candidates -> coverage.
        """
        i = states.inst.clamp(0, self.k - 1)
        is_vc = (tables.family[i] == FAMILY_VC)[:, None]
        undom = tables.fullm[i] & ~states.a
        mask = torch.where(is_vc, states.a, undom)
        valid = torch.where(is_vc, states.a, states.b)
        return i, mask, valid

    def bind(self, tables: StackedTables, device="cuda") -> BinaryProblem:
        """The K-instance BinaryProblem over the device ``tables`` (int32
        tensors on ``device``, as ``convert.stacked_tables`` makes them).  Its
        ``evaluate_batch`` makes ONE ``stacked_count_stats`` launch for
        every lane per call."""
        want = resolve_device(device)
        n, w, k = self.n, self.words, self.k
        # Compare device types: "cuda" names the tensors' "cuda:0".
        if (tables.adj.shape != (k, n, w)
                or tables.adj.device.type != want.type):
            raise ValueError(f"bind wants tables [{k}, {n}, {w}] on {want}, "
                             f"got {tuple(tables.adj.shape)} on "
                             f"{tables.adj.device}")
        dev = tables.adj.device
        bit_words = words(BIT_WORDS, dev)
        zero_words = torch.zeros(w, dtype=torch.int32, device=dev)

        def instance_root(inst: torch.Tensor) -> SvcState:
            i = inst.clamp(0, k - 1)
            is_vc = (tables.family[i] == FAMILY_VC)[:, None]
            fm = tables.fullm[i]
            zero = zero_words.expand(inst.shape[0], w)
            return SvcState(
                inst=inst.to(torch.int32),
                a=torch.where(is_vc, fm, zero),   # alive / dominated
                b=torch.where(is_vc, zero, fm),   # cover / cand
                c=zero.clone(),
                size=torch.zeros_like(inst, dtype=torch.int32))

        def evaluate_batch(states: SvcState, best: torch.Tensor) -> NodeEval:
            i, mask, valid = self.stats_inputs(tables, states)
            out = stacked_count_stats(tables.adj, i, mask.contiguous(),
                                      valid.contiguous())
            cmax, csum, u = out[:, 0], out[:, 2], out[:, 3]
            # The kernel's u is popcount(mask): |undominated| for DS lanes,
            # whose mask IS the undominated set; VC lanes never consume it.
            v = out[:, 1].clamp(min=0)
            is_vc = tables.family[i] == FAMILY_VC

            vc_sol = cmax <= 0
            d_eff = cmax.clamp(min=1)
            vc_lb = states.size + (csum + 2 * d_eff - 1) // (2 * d_eff)
            ds_sol = u == 0
            infeasible = (u > 0) & (cmax <= 0)
            bc = cmax.clamp(min=1)
            ds_lb = torch.where(infeasible, INF_VALUE,
                                states.size + (u + bc - 1) // bc)

            # Children from the shared branch vertex.
            bv = vbit(v, w, bit_words)
            row_v = tables.adj[i, v]
            nb = row_v & states.a                          # vc: alive N(v)
            nb_count = popcount(nb).sum(dim=1, dtype=torch.int32)
            new_cand = states.b & ~bv
            vc_left = SvcState(inst=states.inst, a=states.a & ~bv,
                               b=states.b | bv, c=states.c,
                               size=states.size + 1)
            vc_right = SvcState(inst=states.inst, a=states.a & ~(nb | bv),
                                b=states.b | nb, c=states.c,
                                size=states.size + nb_count)
            ds_left = SvcState(inst=states.inst, a=states.a | row_v,
                               b=new_cand, c=states.c | bv,
                               size=states.size + 1)
            ds_right = SvcState(inst=states.inst, a=states.a, b=new_cand,
                                c=states.c, size=states.size)
            return NodeEval(
                is_solution=torch.where(is_vc, vc_sol, ds_sol),
                value=states.size,
                lower_bound=torch.where(is_vc, vc_lb, ds_lb).to(torch.int32),
                left=tree_select(is_vc, vc_left, ds_left),
                right=tree_select(is_vc, vc_right, ds_right),
                payload=torch.where(is_vc[:, None], states.b, states.c))

        def root() -> SvcState:
            first = torch.zeros(1, dtype=torch.int32, device=dev)
            return tree_map(lambda x: x[0], instance_root(first))

        return BinaryProblem(
            name=f"stacked[k={k},n={n}]",
            max_depth=n,
            root=root,
            evaluate_batch=evaluate_batch,
            payload_zero=lambda: torch.zeros(w, dtype=torch.int32,
                                             device=dev),
            num_instances=k,
            instance_root=instance_root,
        )

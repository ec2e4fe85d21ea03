"""Rounds on one device and on a mesh of shards (counterpart of
``repro.core.distributed``).

    round := expand(R engine steps)        # lane-local, on each shard
             → intra-device steal          # lanes balance within a shard
             → cross-device steal          # between shards (mesh only)
             → incumbent min               # the paper's notification
             → per-instance open-work sum  # termination

A :class:`Mesh` is the counterpart of ``jax.sharding.Mesh``: an ordered
tuple of ``torch.device`` s, one per shard, driven by ONE host process.  A
reference mesh of any shape maps onto it in row-major order, the order in
which the reference linearises its axes and stacks its ``all_gather``.
Devices may repeat: four shards on ``cuda:0`` (or on the CPU) run every
line of the cross-device steal on one card, as the reference's forced
host devices do on one CPU.

Lane arrays split on their leading dimension, shard d owning lanes
``[d*W, (d+1)*W)``; ``best``, ``best_payload`` and ``steps`` are
replicated, one copy per shard (:func:`lane_partition_specs`).  As in the
reference, the replicas drift apart within a round (each shard counts its
own steps and keeps its own payload) and only ``best`` is reduced; a
gathered view reads shard 0's copy, as reading back a replicated JAX
array does.  The collectives are copies between devices plus ``torch.cat``
/ ``amin`` / ``sum``; the host reads back one value per round, the
open-work vector summed onto shard 0's device.

A mesh of ``meta`` devices is a dry run's placeholder mesh
(``launch.mesh.make_production_mesh``): each shard stands for a card of
its own, so its replay runs alone (:meth:`Mesh.groups`), and each
collective records the bytes one shard sends (``roofline.
record_collective``) for ``roofline.analyze``.

A mesh of one shard runs the single-device round: it has no other device
to steal from.  (The reference's one-device mesh runs its cross-device
steal against itself, a second intra-device pass counted in ``t_c``; its
launcher and autoscaler build no mesh for one device.)
"""

from __future__ import annotations

from typing import (Callable, Dict, List, NamedTuple, Optional, Sequence,
                    Tuple, Union)

import torch

from repro_torch import roofline
from repro_torch.core import round_graph, steal
from repro_torch.core.api import (UNVISITED, BinaryProblem, resolve_device,
                                  tree_leaves, tree_map)
from repro_torch.core.engine import Lanes, idx_len, init_lanes, make_expand
from repro_torch.obs import spans


class SolveStats(NamedTuple):
    best: int
    rounds: int
    nodes: int
    t_s: int           # total tasks received (paper's T_S numerator)
    t_r: int           # total task requests (paper's T_R numerator)
    donated: int
    lanes: int
    t_c: int = 0       # tasks received cross-device (subset of t_s)


#: Lanes fields held once per shard rather than split over the shards.
REPLICATED = ("best", "best_payload", "steps")


def _device(dev) -> torch.device:
    """``dev`` as a ``torch.device`` with a card index (``cuda`` names the
    current card), so that shards on one card compare equal."""
    dev = resolve_device(dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """An ordered tuple of devices, one per shard, on the flat axis
    ``workers`` (counterpart of ``jax.sharding.Mesh``).  Devices may
    repeat; all must be of one type."""

    axis_names = ("workers",)

    def __init__(self, devices: Sequence):
        self.devices = tuple(_device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        types = {d.type for d in self.devices}
        if len(types) != 1:
            raise ValueError(f"a mesh holds devices of one type, got "
                             f"{sorted(types)}")

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def device_type(self) -> str:
        return self.devices[0].type

    def distinct(self) -> Tuple[torch.device, ...]:
        """The mesh's devices, each once, in shard order."""
        return tuple(dict.fromkeys(self.devices))

    def groups(self) -> Tuple[Tuple[int, ...], ...]:
        """The shards of each card, in shard order: the shards of one
        device together; a ``meta`` placeholder alone (each stands for a
        card of its own)."""
        if self.device_type == "meta":
            return tuple((d,) for d in range(self.size))
        return tuple(tuple(d for d, x in enumerate(self.devices) if x == dev)
                     for dev in self.distinct())

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]})"


def available_devices(device_type: str, limit: int) -> List[torch.device]:
    """The devices a mesh of ``device_type`` may take: on ``cuda`` every
    card present (``limit`` does not apply: there are no more); on ``cpu``
    ``limit`` shards of the CPU, the counterpart of the reference's forced
    host devices; on ``meta`` ``limit`` placeholder shards."""
    if device_type == "cuda":
        resolve_device("cuda")
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    if device_type in ("cpu", "meta"):
        return [torch.device(device_type)] * max(1, int(limit))
    raise ValueError(f"no mesh of {device_type!r} devices")


def make_mesh(n: int, device_type: str = "cuda") -> Mesh:
    """A mesh of ``n`` shards: the first ``n`` cards for ``cuda`` (raises
    when fewer exist, as ``jax.make_mesh`` does), ``n`` shards of the CPU
    for ``cpu`` (the reference's ``make_host_mesh``), ``n`` placeholders
    for ``meta``."""
    if n < 1:
        raise ValueError(f"a mesh needs n >= 1 shards, got {n}")
    devices = available_devices(device_type, n)
    if n > len(devices):
        raise ValueError(f"a mesh of {n} {device_type} devices, but only "
                         f"{len(devices)} exist")
    return Mesh(devices[:n])


class ShardedLanes:
    """The lanes of a solve or service on a mesh: ``shards[d]`` is a
    ``Lanes`` on ``mesh.devices[d]`` holding lanes ``[d*W, (d+1)*W)``.

    Reading a field (``lanes.nodes``, ``lanes.stack``) gathers it onto
    shard 0's device, the replicated fields from shard 0, as the reference's
    global arrays read back; :meth:`gather` gathers all of them."""

    def __init__(self, shards: Sequence[Lanes]):
        self.shards = tuple(shards)

    def __getattr__(self, name):
        if name in Lanes._fields:
            return _gather_field(self.shards, name)
        raise AttributeError(name)

    def gather(self) -> Lanes:
        return Lanes(**{f: _gather_field(self.shards, f)
                        for f in Lanes._fields})


AnyLanes = Union[Lanes, ShardedLanes]


def _gather_field(shards: Sequence[Lanes], name: str):
    home = shards[0].idx.device
    if name in REPLICATED:
        return getattr(shards[0], name)
    return tree_map(lambda *leaves: torch.cat([l.to(home) for l in leaves]),
                    *[getattr(s, name) for s in shards])


def lane_partition_specs(problem: BinaryProblem) -> Lanes:
    """The layout of ``Lanes`` on a mesh, leaf by leaf, as
    :func:`_shard_lanes` lays them: ``"split"`` (the leading lane
    dimension over the shards) or ``"replicated"`` (one copy per shard)."""
    proto = init_lanes(problem, 1, seed_root=False)
    return Lanes(**{f: tree_map(lambda _, f=f: ("replicated" if f in REPLICATED
                                                else "split"),
                                getattr(proto, f))
                    for f in Lanes._fields})


def _split(fields: Dict, mesh: Mesh, total: int) -> List[Dict]:
    """Gathered-layout ``fields`` cut into each shard's part, on its
    device: a replicated field copied whole, a lane field sliced."""
    d = mesh.size
    if total % d:
        raise ValueError(f"{total} lanes do not split over {d} shards")
    w = total // d
    parts = []
    for r, dev in enumerate(mesh.devices):
        def cut(x, f, dev=dev, r=r):
            x = x if f in REPLICATED else x[r * w:(r + 1) * w]
            return x.to(dev).clone()

        parts.append({f: tree_map(lambda x, f=f: cut(x, f), v)
                      for f, v in fields.items()})
    return parts


def _shard_lanes(lanes: Lanes, mesh: Mesh) -> ShardedLanes:
    """Place ``lanes`` (all W*D of them) on the mesh's shards."""
    return ShardedLanes([Lanes(**part) for part in _split(
        lanes._asdict(), mesh, lanes.idx.shape[0])])


def replace_sharded(lanes: ShardedLanes, mesh: Mesh,
                    **fields) -> ShardedLanes:
    """``Lanes._replace`` with gathered-layout values: each shard takes its
    part of each given field and keeps its own copy of every other (the
    replicated ``steps`` and ``best_payload`` stay as each shard left
    them, as the reference's host writes leave them on each device)."""
    total = sum(s.idx.shape[0] for s in lanes.shards)
    return ShardedLanes([s._replace(**part) for s, part in zip(
        lanes.shards, _split(fields, mesh, total))])


def _gather_lanes(lanes: AnyLanes) -> Lanes:
    """All lanes of a mesh as one ``Lanes`` on shard 0's device (a
    ``Lanes`` passes through), for pool and checkpoint surgery."""
    return lanes.gather() if isinstance(lanes, ShardedLanes) else lanes


def _open_work(lanes: Lanes) -> torch.Tensor:
    """Per instance: active lanes plus donatable slots (0 = drained)."""
    k = lanes.best.shape[0]
    safe_inst = lanes.inst.clamp(0, k - 1)
    slots = steal.donor_slots(lanes)
    contrib = (lanes.active.to(torch.int32)
               + (lanes.active & (slots < lanes.idx.shape[1])
                  ).to(torch.int32))
    return torch.zeros(k, dtype=torch.int32,
                       device=lanes.idx.device).index_add(0, safe_inst,
                                                          contrib)


def _exclusive_cumsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    return (torch.cumsum(x, dim=dim) - x).to(torch.int32)


def cross_device_steal(problems: Sequence[BinaryProblem],
                       shards: Sequence[Lanes], max_ship: int
                       ) -> List[Lanes]:
    """One cross-device steal phase over the shards (the reference's
    ``cross_device_steal``): :func:`cross_device_assign`, then each
    receiving lane replays its task.  ``problems[d]`` is the problem bound
    on shard d's device."""
    shards, received = cross_device_assign(shards, max_ship)
    return [steal.replay_received(p, s, r)
            for p, s, r in zip(problems, shards, received)]


def cross_device_assign(shards: Sequence[Lanes], max_ship: int
                        ) -> Tuple[List[Lanes], List[torch.Tensor]]:
    """One cross-device steal phase over the shards, instance-scoped
    (steps 1-4 of the reference's ``cross_device_steal``), up to the
    replay: returns the shards with every field but the state stack
    installed, and each shard's mask of lanes that received a task.

    1. every shard advertises its per-instance (idle, donatable) counts;
    2. a greedy prefix quota in shard order per instance, capped at
       ``max_ship`` tasks a shard by an instance-major prefix of the
       demand-limited quotas, so that no extracted task goes unclaimed;
    3. each shard extracts its quota (heaviest first) and the task rows,
       tagged with their global within-instance rank, are gathered;
    4. the thief of global rank g of instance i claims that instance's
       g-th task.

    The quota arithmetic runs once, on shard 0's device, and is copied to
    the others: the reference computes the same matrix on every device.
    """
    home = shards[0].idx.device
    w, il = shards[0].idx.shape
    k = shards[0].best.shape[0]

    thieves, summaries = [], []
    for lanes in shards:
        safe_inst = lanes.inst.clamp(0, k - 1).long()
        t = steal.thief_mask(lanes)
        donors = steal.donor_mask(lanes, steal.donor_slots(lanes))
        zeros = torch.zeros(k, dtype=torch.int32, device=lanes.idx.device)
        summary = torch.stack([
            zeros.index_add(0, safe_inst, t.to(torch.int32)),
            zeros.index_add(0, safe_inst, donors.to(torch.int32))],
            dim=1)                                             # [K, 2]
        roofline.record_collective("all-gather", summary)
        summaries.append(summary.to(home))
        thieves.append(t)

    # (1) advertise: all_gather in shard order.
    all_sum = torch.stack(summaries)                           # [D, K, 2]
    demands, supplies = all_sum[:, :, 0], all_sum[:, :, 1]
    total_demand = demands.sum(dim=0)                          # [K]
    # (2) greedy prefix quota per instance, then the max_ship cap over an
    # instance-major prefix of the quotas.
    presum = _exclusive_cumsum(supplies, 0)
    quota = torch.minimum(
        (total_demand[None, :] - torch.minimum(presum, total_demand[None, :])
         ).clamp(min=0), supplies)
    qpre = _exclusive_cumsum(quota, 1)
    quota = torch.minimum(
        (max_ship - torch.minimum(qpre, torch.full_like(qpre, max_ship))
         ).clamp(min=0), quota).to(torch.int32)
    task_offset = _exclusive_cumsum(quota, 0)                  # [D, K]
    thief_offset = _exclusive_cumsum(demands, 0)               # [D, K]

    # (3) extract and ship the index rows with their global ranks.
    extracted, payloads = [], []
    for me, lanes in enumerate(shards):
        dev = lanes.idx.device
        lanes, bits, tdepth, tinst, trank, valid = steal.extract_tasks(
            lanes, quota[me].to(dev), max_ship)
        grank = task_offset[me].to(dev)[tinst] + trank
        payload = torch.cat(
            [bits.to(torch.int32), tdepth[:, None], tinst[:, None],
             grank[:, None], valid[:, None].to(torch.int32)],
            dim=1)                                             # [S, IL+4]
        roofline.record_collective("all-gather", payload)
        payloads.append(payload.to(home))
        extracted.append(lanes)
    world = torch.cat(payloads)                                # [D*S, IL+4]

    # (4) claim by per-instance global rank.
    out, received = [], []
    for me, (lanes, t) in enumerate(zip(extracted, thieves)):
        dev = lanes.idx.device
        wd = world.to(dev)
        w_bits, w_depth = wd[:, :il], wd[:, il]
        w_inst, w_grank = wd[:, il + 1], wd[:, il + 2]
        w_valid = wd[:, il + 3] > 0
        lane_ids = torch.arange(w, dtype=torch.int32, device=dev)
        safe_inst = lanes.inst.clamp(0, k - 1)
        my_trank = steal._rank_within_instance(t, lane_ids, lanes.inst)
        my_grank = thief_offset[me].to(dev)[safe_inst] + my_trank
        src, claim = steal.claim_tasks(t, safe_inst, my_grank, w_inst,
                                       w_grank, w_valid)
        rbits = torch.where(claim[:, None], w_bits[src].to(torch.int8),
                            UNVISITED).to(torch.int8)
        rdepth = torch.where(claim, w_depth[src], 0).to(torch.int32)
        rinst = torch.where(claim, w_inst[src], 0).to(torch.int32)
        lanes = lanes._replace(t_r=lanes.t_r + t.to(torch.int32))
        lanes, got = steal.assign_tasks(lanes, rbits, rdepth, rinst, claim,
                                        cross=True)
        out.append(lanes)
        received.append(got)
    return out, received


def replay_per_device(problems: Sequence[BinaryProblem], mesh: Mesh,
                      shards: Sequence[Lanes],
                      received: Sequence[torch.Tensor]) -> List[Lanes]:
    """:func:`steal.replay_received` for every shard, the shards that
    share a device joined into one batch (:meth:`Mesh.groups`): a replay
    is lane-local, so the stacks are those of one replay per shard, in
    one pass over the index per device instead of one per shard."""
    out = list(shards)
    for group in mesh.groups():
        joined = shards[group[0]]._replace(**{
            f: tree_map(lambda *leaves: torch.cat(leaves),
                        *[getattr(shards[d], f) for d in group])
            for f in ("idx", "depth", "inst", "stack")})
        stack = steal.replay_received(
            problems[group[0]], joined,
            torch.cat([received[d] for d in group])).stack
        start = 0
        for d in group:
            w = shards[d].idx.shape[0]
            out[d] = shards[d]._replace(stack=tree_map(
                lambda x, a=start, b=start + w: x[a:b], stack))
            start += w
    return out


def problems_per_shard(problem, mesh: Mesh) -> List[BinaryProblem]:
    """The problem bound on each shard's device: ``problem`` is one
    ``BinaryProblem`` (every shard on its device) or a mapping from each
    distinct device of the mesh to the problem bound there."""
    if isinstance(problem, BinaryProblem):
        home = tree_leaves(problem.root())[0].device
        for dev in mesh.distinct():
            if dev != home:
                raise ValueError(f"the problem's tables are on {home}, the "
                                 f"mesh has a shard on {dev}: bind one "
                                 f"problem per device")
        return [problem] * mesh.size
    return [problem[dev] for dev in mesh.devices]


def make_round(problem, steps_per_round: int, *,
               mesh: Optional[Mesh] = None, max_ship: int = 16,
               calls: Optional[int] = None) -> Callable:
    """Build the round body.  With no mesh (or a mesh of one shard) it
    maps ``Lanes`` to ``(lanes, open_work)``; ``open_work`` is int32[K]
    on the host: per instance, active lanes plus donatable slots (0 means
    drained).  With a mesh of several shards it is
    :func:`make_distributed_round`, eager, its open work read back the
    same way.

    The single-device body is a ``round_graph.GraphedRound`` of two
    parts.  The *plan* runs the ``steps_per_round`` engine steps, the
    steal's matching and installation, and starts the receiving lanes'
    replay (``steal.replay_begin``); it returns the lanes, the open work
    and ``need``, the deepest task received, as one int32 vector, and the
    replay's state.  The host reads that vector back (the round's one
    wait for the card) and runs ``ceil(need / steal.REPLAY_CHUNK)``
    *chunks* of CONVERTINDEX passes into the plan's lanes
    (``steal.replay_chunk``): none on a round where no lane received a
    task.  The rows the chunks leave alone are the whole replay's
    (``engine.replay_path`` with ``passes = need``), so the round is the
    D+1-pass round bitwise.  On a CUDA device the first call runs eager
    (the warm-up), the second captures the plan and a chunk as CUDA
    graphs, and every later call replays them; on any other device both
    run eager.  ``calls``, the most calls the caller will make where it
    knows it, keeps a body eager that gets too few to pay for its capture
    (``round_graph.MIN_CALLS``)."""
    if mesh is not None and mesh.size > 1:
        return round_graph.eager(
            make_distributed_round(problem, mesh, steps_per_round, max_ship),
            "mesh")
    if mesh is not None:
        problem = problems_per_shard(problem, mesh)[0]
        single = make_round(problem, steps_per_round, calls=calls)

        def one_shard(lanes: ShardedLanes):
            out, open_work = single(lanes.shards[0])
            return ShardedLanes([out]), open_work

        return one_shard
    if steps_per_round < 1:
        # The replay writes into the stack of the round's last engine step.
        raise ValueError(f"steps_per_round must be >= 1, got "
                         f"{steps_per_round}")
    expand = make_expand(problem, steps_per_round)
    il = idx_len(problem)

    def plan(lanes: Lanes) -> Tuple[Lanes, torch.Tensor, steal.Replay]:
        lanes = expand(lanes)
        lanes, received = steal.assign_tasks(*steal.balance_plan(lanes))
        with spans.span("replay", device=True):
            replay, need = steal.replay_begin(problem, lanes, received)
        return lanes, torch.cat([_open_work(lanes), need[None]]), replay

    def chunk(lanes: Lanes, replay: steal.Replay) -> None:
        steal.replay_chunk(problem, lanes, replay)

    def chunks(flags: torch.Tensor) -> Tuple[int, torch.Tensor]:
        """``plan``'s flags as read back: (the chunks ``need`` asks for,
        the open work)."""
        return steal.replay_chunks(int(flags[-1]), il), flags[:-1]

    return round_graph.GraphedRound(plan, chunk, chunks, calls=calls)


def make_distributed_round(problem, mesh: Mesh, steps_per_round: int,
                           max_ship: int = 16
                           ) -> Callable[[ShardedLanes],
                                         Tuple[ShardedLanes, torch.Tensor]]:
    """The round over every shard of ``mesh``: each shard expands and
    balances its own lanes, then the cross-device steal, the incumbent
    min and the per-instance open-work sum (onto shard 0's device).
    ``problem`` as in :func:`problems_per_shard`."""
    if max_ship < 1:
        raise ValueError(f"max_ship must be >= 1, got {max_ship}")
    problems = problems_per_shard(problem, mesh)
    expands: Dict[torch.device, Callable] = {}
    for dev, p in zip(mesh.devices, problems):
        if dev not in expands:
            expands[dev] = make_expand(p, steps_per_round)

    def round_fn(lanes: ShardedLanes) -> Tuple[ShardedLanes, torch.Tensor]:
        # The intra-device steal's replay waits for the cross-device one:
        # neither steal reads the stacks, and a lane receives at most once
        # a round (a receiver is no longer idle), so one replay per device
        # rebuilds the stacks both would.
        shards, received = [], []
        for dev, s in zip(mesh.devices, lanes.shards):
            s, got = steal.assign_tasks(*steal.balance_plan(
                expands[dev](s)))
            shards.append(s)
            received.append(got)
        shards, cross = cross_device_assign(shards, max_ship)
        shards = replay_per_device(problems, mesh, shards,
                                   [a | b for a, b in zip(received, cross)])
        home = shards[0].idx.device
        for s in shards:
            roofline.record_collective("all-reduce", s.best)
        best = torch.stack([s.best.to(home) for s in shards]).amin(dim=0)
        shards = [s._replace(best=best.to(s.idx.device)) for s in shards]
        opens = [_open_work(s) for s in shards]
        for o in opens:
            roofline.record_collective("all-reduce", o)
        open_work = torch.stack([o.to(home) for o in opens]
                                ).sum(dim=0, dtype=torch.int32)
        return ShardedLanes(shards), open_work

    return round_fn

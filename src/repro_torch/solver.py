"""The Solver session API of the port (counterpart of ``repro.solver``).

    cfg = SolverConfig(lanes=1024, steps_per_round=64, device="cuda")
    solver = Solver(cfg)
    res = solver.solve(registry.problem("vc", "gnp:100:10:7"))   # engine
    ref = solver.oracle(registry.problem("vc", "gnp:100:10:7"))  # serial
    assert res.stats.best == ref.best

    svc = solver.serve(max_n=100, slots=4)                        # service

``device`` takes the place of the reference's ``backend``: on "cuda" the
node evaluation launches the CUDA kernels, on "cpu" it runs the plain
versions.  "cuda" is the default and raises when no card is present.
Telemetry (``trace_path``, ``metrics``) is the reference's.  With
``mesh`` (a ``repro_torch.core.distributed.Mesh``) the lanes are sharded
over the mesh's devices, ``lanes`` per shard, and the rounds steal across
shards (``max_ship`` tasks a shard a round); ``autoscale`` lets the
service grow and shrink its mesh.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch import registry as _registry
from repro_torch.core.api import BinaryProblem, resolve_device, tree_map
from repro_torch.core.distributed import (Mesh, SolveStats, _gather_lanes,
                                         _shard_lanes, make_round,
                                         problems_per_shard)
from repro_torch.core.engine import Lanes, init_lanes
from repro_torch.core.serial import serial_rb
from repro_torch.obs import spans

__all__ = [
    "ConfigError",
    "EVENT_KINDS",
    "OracleResult",
    "ProgressEvent",
    "SolveResult",
    "Solver",
    "SolverConfig",
    "SolveStats",
    "emit",
]


class ConfigError(ValueError):
    """An invalid :class:`SolverConfig`."""


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Frozen execution policy for a solver session.

    Attributes:
      lanes: engine lanes per device (total lanes = lanes x mesh shards).
      steps_per_round: engine steps between steal phases (R).
      max_rounds: hard round budget (bootstrap rounds included).
      bootstrap_rounds / bootstrap_steps: short ramp-up rounds that flood
        initial tasks.
      fused_steps: validated for parity with the reference and recorded
        in the trace; the tree is the same for every value.
      device: where the lanes and tables live ("cuda" or "cpu").
      checkpoint_every / checkpoint_path: periodic checkpointing policy of
        :meth:`Solver.solve` (``checkpoint_every > 0`` requires a path).
      resume_from: checkpoint to restore before solving (elastic: any lane
        count; the instance-slot count must match the problem).
      scheduler: service admission policy name ("priority" | "sjf" |
        "fifo"), validated when the config meets :meth:`Solver.serve`.
      trace_path: write a JSONL telemetry trace here (the reference's
        ``obs.trace`` schema; render with ``tools/trace_report.py``).  The
        search tree is bit-identical with tracing on or off (DESIGN.md
        §8).
      metrics: collect an in-process metrics registry, queryable as a
        ``MetricsSnapshot`` via ``Solver.metrics()`` /
        ``SolverService.metrics()`` and attached to "round"/"done"
        :class:`ProgressEvent`\\ s.
      mesh: a ``repro_torch.core.distributed.Mesh``, or None (one
        device): honoured by :meth:`Solver.solve` and the sharded service.
        Its devices are the shards' and must be of ``device``'s type.
      max_ship: cross-device tasks shipped per shard per round.
      autoscale: a ``repro_torch.service.scheduler.AutoscalePolicy`` (or
        None), service only: each round the driver asks it for a target
        shard count keyed on the admission queue depth and resizes the
        mesh (``SolverService.resize``).  Ignored by :meth:`Solver.solve`.
    """

    lanes: int = 32
    steps_per_round: int = 64
    max_rounds: int = 100000
    bootstrap_rounds: int = 0
    bootstrap_steps: int = 8
    fused_steps: int = 1
    device: str = "cuda"
    checkpoint_every: int = 0
    checkpoint_path: Optional[str] = None
    resume_from: Optional[str] = None
    scheduler: str = "priority"
    mesh: Optional[Any] = None
    max_ship: int = 16
    autoscale: Optional[Any] = None
    trace_path: Optional[str] = None
    metrics: bool = False

    def __post_init__(self):
        if self.lanes < 1:
            raise ConfigError(f"lanes must be >= 1, got {self.lanes}")
        if self.steps_per_round < 1:
            raise ConfigError(
                f"steps_per_round must be >= 1, got {self.steps_per_round}")
        if self.max_ship < 1:
            raise ConfigError(f"max_ship must be >= 1, got {self.max_ship}")
        if self.bootstrap_rounds < 0 or self.bootstrap_steps < 1:
            raise ConfigError(
                f"bad bootstrap policy: rounds={self.bootstrap_rounds} "
                f"steps={self.bootstrap_steps}")
        if self.fused_steps < 1:
            raise ConfigError(
                f"fused_steps must be >= 1, got {self.fused_steps}")
        if self.checkpoint_every < 0:
            raise ConfigError(
                f"checkpoint_every must be >= 0, got {self.checkpoint_every}")
        if self.checkpoint_every and not self.checkpoint_path:
            raise ConfigError(
                "checkpoint_every > 0 requires checkpoint_path")
        if not isinstance(self.scheduler, str) or not self.scheduler:
            raise ConfigError(
                f"scheduler must be a policy name, got {self.scheduler!r}")
        if self.trace_path is not None and (
                not isinstance(self.trace_path, str) or not self.trace_path):
            raise ConfigError(
                f"trace_path must be a path, got {self.trace_path!r}")
        try:
            device_type = torch.device(self.device).type
        except (RuntimeError, TypeError) as e:
            raise ConfigError(f"bad device {self.device!r}: {e}") from None
        if self.mesh is not None:
            if not isinstance(self.mesh, Mesh):
                raise ConfigError(
                    f"mesh must be a repro_torch.core.distributed.Mesh, got "
                    f"{type(self.mesh).__name__}")
            if self.mesh.device_type != device_type:
                raise ConfigError(
                    f"mesh of {self.mesh.device_type} devices with device="
                    f"{self.device!r}: the shards' devices are the mesh's")


#: Every ProgressEvent kind a driver may emit (the reference's set).
EVENT_KINDS = frozenset({
    "round", "checkpoint", "admit", "incumbent", "retire", "reject",
    "cancel", "expire", "resize", "done",
})


@dataclasses.dataclass(frozen=True)
class ProgressEvent:
    """One typed progress notification.  :meth:`Solver.solve` emits
    "round" (``round``, ``open_work``, ``best``, ``lanes``) after every
    main round and "done" when the solve drains.  ``metrics`` carries a
    ``repro_torch.obs.MetricsSnapshot`` on "round"/"done" events when
    ``SolverConfig.metrics`` is set (None otherwise)."""

    kind: str
    round: int
    open_work: int = 0
    best: Optional[int] = None
    rid: Optional[int] = None
    path: Optional[str] = None
    reason: Optional[str] = None
    lanes: Optional[Lanes] = None
    metrics: Optional[Any] = None

    def __post_init__(self):
        if self.kind not in EVENT_KINDS:
            raise ValueError(
                f"unknown ProgressEvent kind {self.kind!r} (known: "
                f"{', '.join(sorted(EVENT_KINDS))})")


EventCallback = Callable[[ProgressEvent], None]


def emit(on_event: Optional[EventCallback], kind: str, **fields) -> None:
    """The one ProgressEvent emission path: validates ``kind`` even with
    no listener, then delivers the event when one is attached."""
    if kind not in EVENT_KINDS:
        raise ValueError(
            f"unknown ProgressEvent kind {kind!r} (known: "
            f"{', '.join(sorted(EVENT_KINDS))})")
    if on_event is not None:
        on_event(ProgressEvent(kind=kind, **fields))


class SolveResult(NamedTuple):
    """Outcome of :meth:`Solver.solve` (payload squeezed for K = 1)."""

    payload: Any
    stats: SolveStats
    lanes: Lanes


class OracleResult(NamedTuple):
    """Outcome of :meth:`Solver.oracle` (SERIAL-RB ground truth)."""

    best: int
    nodes: int


class Solver:
    """A solver session: one config, the engine and the serial oracle."""

    def __init__(self, config: Optional[SolverConfig] = None,
                 on_event: Optional[EventCallback] = None):
        self.config = config or SolverConfig()
        self.on_event = on_event
        self._obs = None          # RoundCollector of the most recent solve

    def metrics(self):
        """``repro_torch.obs.MetricsSnapshot`` of the most recent (or
        running) :meth:`solve`, or None when telemetry was off (enable
        with ``SolverConfig(metrics=True)`` or ``trace_path=...``)."""
        return self._obs.snapshot() if self._obs is not None else None

    def _resolve(self, problem):
        """ProblemHandle -> BinaryProblem on the config's device, or with a
        mesh one per distinct device of it (a device -> problem mapping);
        a raw BinaryProblem passes through (with a mesh, its tables must
        lie on every shard's device)."""
        mesh = self.config.mesh
        if isinstance(problem, _registry.ProblemHandle):
            if mesh is None:
                return problem.build(device=str(resolve_device(
                    self.config.device)))
            return {dev: problem.build(device=str(dev))
                    for dev in mesh.distinct()}
        if isinstance(problem, BinaryProblem):
            if mesh is not None:
                try:
                    problems_per_shard(problem, mesh)
                except ValueError as e:
                    raise ConfigError(str(e)) from e
            return problem
        raise TypeError(
            f"expected a registry.ProblemHandle or BinaryProblem, got "
            f"{type(problem).__name__}")

    def oracle(self, problem) -> OracleResult:
        """SERIAL-RB on the family's registered scalar oracle."""
        if isinstance(problem, _registry.ProblemHandle):
            py = problem.oracle()
        else:
            py = problem                   # an already-built PyProblem
        best, nodes, _ = serial_rb(py)
        return OracleResult(best=best, nodes=nodes)

    def solve(self, problem) -> SolveResult:
        """Run rounds until the work drains (the paper's PARALLEL-RB) or
        ``max_rounds`` is reached.  The host reads back one
        value per round, the open-work count; with telemetry on, the
        collector copies the lane counters once more after it.

        ``resume_from`` restores a checkpoint written by either package at
        any lane count (elastic restart, paper §VII): surplus tasks wait in
        a host-side pool and are installed into idle lanes at round
        boundaries.

        With ``mesh`` the lanes are sharded, ``config.lanes`` per shard,
        and every round (the bootstrap ones too) steals across shards.
        ``SolveResult.lanes`` is then a ``ShardedLanes`` (its fields read
        as the gathered arrays; ``.gather()`` gives one ``Lanes``);
        checkpoints hold the gathered lanes and resume onto any number of
        shards.
        """
        from repro_torch.core import checkpoint as ckpt

        cfg = self.config
        mesh = cfg.mesh
        bound = self._resolve(problem)
        if mesh is None:
            problem, total_lanes = bound, cfg.lanes
        else:
            problem = problems_per_shard(bound, mesh)[0]
            total_lanes = cfg.lanes * mesh.size
        bootstrap_rounds = cfg.bootstrap_rounds
        round_fn = make_round(bound, cfg.steps_per_round, mesh=mesh,
                              max_ship=cfg.max_ship)
        boot_fn = (make_round(bound, cfg.bootstrap_steps, mesh=mesh,
                              max_ship=cfg.max_ship, calls=bootstrap_rounds)
                   if bootstrap_rounds else round_fn)

        pool: list = []
        if cfg.resume_from is not None:
            if not os.path.exists(cfg.resume_from):
                raise ConfigError(
                    f"resume_from checkpoint not found: {cfg.resume_from}")
            try:
                lanes, pool = ckpt.restore(cfg.resume_from, problem,
                                           total_lanes)
            except ValueError as e:        # e.g. instance-slot mismatch
                raise ConfigError(
                    f"resume_from {cfg.resume_from!r} is incompatible with "
                    f"this problem/config: {e}") from e
            bootstrap_rounds = max(bootstrap_rounds, 1)  # respread work
        else:
            lanes = init_lanes(problem, total_lanes)
        if mesh is not None:
            lanes = _shard_lanes(lanes, mesh)

        collector = None
        if cfg.metrics or cfg.trace_path is not None:
            from repro_torch import obs
            # As the reference's, the solve's collector counts no devices.
            collector = obs.RoundCollector(
                mode="solve", lanes=total_lanes,
                slots=problem.num_instances,
                steps_per_round=cfg.steps_per_round,
                fused_steps=cfg.fused_steps,
                backend=(lanes.idx.device.type if mesh is None
                         else mesh.device_type),
                trace=(obs.TraceWriter(cfg.trace_path)
                       if cfg.trace_path else None))
            collector.start(lanes)      # after restore: deltas = this run
        self._obs = collector

        def feed_pool(lanes):
            nonlocal pool
            if pool:
                lanes, pool = ckpt.install_pending(
                    problem, _gather_lanes(lanes), pool)
                if mesh is not None:
                    lanes = _shard_lanes(lanes, mesh)
            return lanes

        def run_round(fn, lanes):
            fed = bool(pool)
            lanes = feed_pool(lanes)
            if collector is not None:
                collector.before_round(lanes, dirty=fed)
            # The round read its open work back (its ``readback`` span).
            lanes, open_work = fn(lanes)
            open_now = int(open_work.sum())
            if collector is not None:
                collector.after_round(rounds + 1, lanes, open_now)
            return lanes, open_now

        def snap():
            return (collector.snapshot()
                    if collector is not None and cfg.metrics else None)

        run = spans.begin_run("solve")
        rounds, done = 0, False
        for _ in range(bootstrap_rounds):
            with spans.span("round", run=run, round=rounds + 1):
                lanes, open_now = run_round(boot_fn, lanes)
            rounds += 1
            if open_now == 0 and not pool:
                done = True
                break
        while not done and rounds < cfg.max_rounds:
            with spans.span("round", run=run, round=rounds + 1):
                lanes, open_now = run_round(round_fn, lanes)
                rounds += 1
                if self.on_event is not None:
                    # The incumbent readback costs a sync: only pay it when
                    # someone is listening.
                    with spans.span("event"):
                        emit(self.on_event, "round", round=rounds,
                             open_work=open_now, best=int(lanes.best.min()),
                             lanes=lanes, metrics=snap())
                if (cfg.checkpoint_every and cfg.checkpoint_path
                        and rounds % cfg.checkpoint_every == 0):
                    ckpt.save(cfg.checkpoint_path, _gather_lanes(lanes),
                              payload_dtype=problem.payload_dtype)
                    emit(self.on_event, "checkpoint", round=rounds,
                         path=cfg.checkpoint_path)
            done = open_now == 0 and not pool

        stats = SolveStats(
            best=int(lanes.best.min()),
            rounds=rounds,
            nodes=int(lanes.nodes.sum()),
            t_s=int(lanes.t_s.sum()),
            t_r=int(lanes.t_r.sum()),
            donated=int(lanes.donated.sum()),
            lanes=int(lanes.active.shape[0]),
            t_c=int(lanes.t_c.sum()),
        )
        spans.read_device()     # the last round's replay span, now done
        if collector is not None:
            collector.finish(rounds=rounds, best=lanes.best.tolist())
            collector.close()
        emit(self.on_event, "done", round=rounds, open_work=0,
             best=stats.best, metrics=snap())
        payload = lanes.best_payload
        if problem.num_instances == 1:
            # Single-instance API: drop the K=1 incumbent-table dim.
            payload = tree_map(lambda p: p[0], payload)
        return SolveResult(payload=payload, stats=stats, lanes=lanes)

    def serve(self, *, max_n: int, slots: int):
        """The multi-tenant :class:`repro_torch.service.SolverService`
        under this config (lanes, steps_per_round, device, scheduler, mesh,
        max_ship, autoscale) and event stream.  With ``mesh`` the lane
        pool is sharded (``lanes`` per shard), the stacked tables are
        bound once per distinct device and rounds steal across shards.

        Its ``submit()`` returns a Ticket; any registered *servable*
        family can be submitted, validated at ``submit()`` time
        (:class:`repro_torch.service.AdmissionError`).  The service has its
        own checkpoint surface (``SolverService.save`` / ``.restore``), so
        a config carrying ``checkpoint_every`` or ``resume_from`` is
        refused here rather than silently ignored.
        """
        from repro_torch.service.driver import SolverService
        from repro_torch.service.scheduler import SCHEDULERS

        if self.config.scheduler not in SCHEDULERS:
            raise ConfigError(
                f"unknown scheduler {self.config.scheduler!r} (registered "
                f"policies: {', '.join(sorted(SCHEDULERS))})")
        unsupported = [
            name for name, is_set in (
                ("checkpoint_every", bool(self.config.checkpoint_every)),
                ("resume_from", self.config.resume_from is not None),
            ) if is_set]
        if unsupported:
            raise ConfigError(
                f"SolverConfig fields not honored by the service driver: "
                f"{', '.join(unsupported)} — use SolverService.save/restore "
                f"for service checkpoints")
        resolve_device(self.config.device)
        return SolverService.from_config(self.config, max_n=max_n,
                                         slots=slots, on_event=self.on_event)

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
Telemetry (``trace_path``, ``metrics``) and the mesh (``mesh``,
``max_ship``, ``autoscale``) come with later slices: a config that sets
them is refused.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch import registry as _registry
from repro_torch.core.api import BinaryProblem, resolve_device, tree_map
from repro_torch.core.distributed import SolveStats, make_round
from repro_torch.core.engine import Lanes, init_lanes
from repro_torch.core.serial import serial_rb

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
      lanes: engine lanes on the device.
      steps_per_round: engine steps between steal phases (R).
      max_rounds: hard round budget (bootstrap rounds included).
      bootstrap_rounds / bootstrap_steps: short ramp-up rounds that flood
        initial tasks.
      fused_steps: validated for parity with the reference; the tree is
        the same for every value.
      device: where the lanes and tables live ("cuda" or "cpu").
      checkpoint_every / checkpoint_path: periodic checkpointing policy of
        :meth:`Solver.solve` (``checkpoint_every > 0`` requires a path).
      resume_from: checkpoint to restore before solving (elastic: any lane
        count; the instance-slot count must match the problem).
      scheduler: service admission policy name ("priority" | "sjf" |
        "fifo"), validated when the config meets :meth:`Solver.serve`.
      mesh / max_ship / autoscale / trace_path / metrics: the reference's
        multi-device and telemetry fields, not ported yet; setting any of
        them raises ``ConfigError``.
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
        unported = [name for name, is_set in (
            ("mesh", self.mesh is not None),
            ("max_ship", self.max_ship != 16),
            ("autoscale", self.autoscale is not None),
            ("trace_path", self.trace_path is not None),
            ("metrics", bool(self.metrics))) if is_set]
        if unported:
            raise ConfigError(
                f"SolverConfig {', '.join(unported)}: not ported to "
                f"repro_torch yet (multi-GPU and telemetry are ROADMAP "
                f"Queue 1 items 9 and 8); use the repro package for them")
        try:
            torch.device(self.device)
        except (RuntimeError, TypeError) as e:
            raise ConfigError(f"bad device {self.device!r}: {e}") from None


#: Every ProgressEvent kind a driver may emit (the reference's set).
EVENT_KINDS = frozenset({
    "round", "checkpoint", "admit", "incumbent", "retire", "reject",
    "cancel", "expire", "resize", "done",
})


@dataclasses.dataclass(frozen=True)
class ProgressEvent:
    """One typed progress notification.  :meth:`Solver.solve` emits
    "round" (``round``, ``open_work``, ``best``, ``lanes``) after every
    main round and "done" when the solve drains."""

    kind: str
    round: int
    open_work: int = 0
    best: Optional[int] = None
    rid: Optional[int] = None
    path: Optional[str] = None
    reason: Optional[str] = None
    lanes: Optional[Lanes] = None

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

    def _resolve(self, problem) -> BinaryProblem:
        """ProblemHandle -> BinaryProblem on the config's device; a raw
        BinaryProblem passes through."""
        if isinstance(problem, _registry.ProblemHandle):
            return problem.build(device=str(resolve_device(
                self.config.device)))
        if isinstance(problem, BinaryProblem):
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
        """Run rounds until the work drains (the paper's PARALLEL-RB on
        one device) or ``max_rounds`` is reached.  The host reads back one
        value per round, the open-work count.

        ``resume_from`` restores a checkpoint written by either package at
        any lane count (elastic restart, paper §VII): surplus tasks wait in
        a host-side pool and are installed into idle lanes at round
        boundaries.
        """
        from repro_torch.core import checkpoint as ckpt

        cfg = self.config
        problem = self._resolve(problem)
        bootstrap_rounds = cfg.bootstrap_rounds
        round_fn = make_round(problem, cfg.steps_per_round,
                              fused_steps=cfg.fused_steps)
        boot_fn = (make_round(problem, cfg.bootstrap_steps,
                              fused_steps=cfg.fused_steps)
                   if bootstrap_rounds else round_fn)

        pool: list = []
        if cfg.resume_from is not None:
            if not os.path.exists(cfg.resume_from):
                raise ConfigError(
                    f"resume_from checkpoint not found: {cfg.resume_from}")
            try:
                lanes, pool = ckpt.restore(cfg.resume_from, problem,
                                           cfg.lanes)
            except ValueError as e:        # e.g. instance-slot mismatch
                raise ConfigError(
                    f"resume_from {cfg.resume_from!r} is incompatible with "
                    f"this problem/config: {e}") from e
            bootstrap_rounds = max(bootstrap_rounds, 1)  # respread work
        else:
            lanes = init_lanes(problem, cfg.lanes)

        def feed_pool(lanes):
            nonlocal pool
            if pool:
                lanes, pool = ckpt.install_pending(problem, lanes, pool)
            return lanes

        rounds, done = 0, False
        for _ in range(bootstrap_rounds):
            lanes, open_work = boot_fn(feed_pool(lanes))
            rounds += 1
            if int(open_work.sum()) == 0 and not pool:
                done = True
                break
        while not done and rounds < cfg.max_rounds:
            lanes, open_work = round_fn(feed_pool(lanes))
            rounds += 1
            open_now = int(open_work.sum())
            if self.on_event is not None:
                # The incumbent readback costs a sync: only pay it when
                # someone is listening.
                emit(self.on_event, "round", round=rounds,
                     open_work=open_now, best=int(lanes.best.min()),
                     lanes=lanes)
            if (cfg.checkpoint_every and cfg.checkpoint_path
                    and rounds % cfg.checkpoint_every == 0):
                ckpt.save(cfg.checkpoint_path, lanes)
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
        emit(self.on_event, "done", round=rounds, open_work=0,
             best=stats.best)
        payload = lanes.best_payload
        if problem.num_instances == 1:
            # Single-instance API: drop the K=1 incumbent-table dim.
            payload = tree_map(lambda p: p[0], payload)
        return SolveResult(payload=payload, stats=stats, lanes=lanes)

    def serve(self, *, max_n: int, slots: int):
        """The multi-tenant :class:`repro_torch.service.SolverService`
        under this config (lanes, steps_per_round, device, scheduler) and
        event stream, on one device.

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

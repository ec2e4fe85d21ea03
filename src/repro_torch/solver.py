"""The Solver session API of the port (counterpart of ``repro.solver``).

    cfg = SolverConfig(lanes=1024, steps_per_round=64, device="cuda")
    solver = Solver(cfg)
    res = solver.solve(registry.problem("vc", "gnp:100:10:7"))   # engine
    ref = solver.oracle(registry.problem("vc", "gnp:100:10:7"))  # serial
    assert res.stats.best == ref.best

``device`` takes the place of the reference's ``backend``: on "cuda" the
node evaluation launches the CUDA kernel, on "cpu" it runs the plain
version.  "cuda" is the default and raises when no card is present.
Checkpoints, telemetry, the mesh and the service come with later slices.
"""

from __future__ import annotations

import dataclasses
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
    """

    lanes: int = 32
    steps_per_round: int = 64
    max_rounds: int = 100000
    bootstrap_rounds: int = 0
    bootstrap_steps: int = 8
    fused_steps: int = 1
    device: str = "cuda"

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
        value per round, the open-work count."""
        cfg = self.config
        problem = self._resolve(problem)
        round_fn = make_round(problem, cfg.steps_per_round,
                              fused_steps=cfg.fused_steps)
        boot_fn = make_round(problem, cfg.bootstrap_steps,
                             fused_steps=cfg.fused_steps)
        lanes = init_lanes(problem, cfg.lanes)

        rounds, done = 0, False
        for _ in range(cfg.bootstrap_rounds):
            lanes, open_work = boot_fn(lanes)
            rounds += 1
            if int(open_work.sum()) == 0:
                done = True
                break
        while not done and rounds < cfg.max_rounds:
            lanes, open_work = round_fn(lanes)
            rounds += 1
            open_now = int(open_work.sum())
            if self.on_event is not None:
                # The incumbent readback costs a sync: only pay it when
                # someone is listening.
                emit(self.on_event, "round", round=rounds,
                     open_work=open_now, best=int(lanes.best.min()),
                     lanes=lanes)
            done = open_now == 0

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

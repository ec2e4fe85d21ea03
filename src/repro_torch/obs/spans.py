"""Host-time spans of the port's round and service loops.

Where :mod:`repro_torch.obs.collect` counts what a round did, a span says
how long the host spent on each phase of it: one span a phase, never one
an engine step or a replay pass.  A round that replays its CUDA graph
(``core.round_graph``) runs none of the phases' host code: it records one
``graph`` span in place of ``expand``, ``balance`` and ``replay``.

================  ===========================================  ===========
span              where                                        parent
================  ===========================================  ===========
``round``         one iteration of ``Solver.solve``'s loop;    --
                  all of ``SolverService.step_round``
``expand``        ``core.engine.make_expand.expand``           ``round``
``balance``       ``core.steal.balance_plan``,                 ``round``
                  ``core.steal.assign_tasks``
``replay``        ``core.steal.replay_received``               ``round``
``readback``      the round's one host read of the open work   ``round``
``event``         ``Solver.solve``'s "round" ProgressEvent     ``round``
                  (only with a listener)
``admit``         ``SolverService._admit_and_place``           ``round``
``rebuild``       ``SolverService._rebuild_stacks``            ``admit``
``retire``        ``step_round`` after the readback            ``round``
``request``       ``SolverService.submit`` to the request's    --
                  terminal state (carries its ``rid``)
``queued``        ``submit`` to the request's admission        ``request``
``graph``         a replayed round's copy-in, graph launch      ``round``
                  and clone-out (``core.round_graph``)
================  ===========================================  ===========

A name may be opened in more than one function (``balance`` twice a
round): readers sum by name.  Stamps are ``time.perf_counter_ns()``; the
recorder creates no tensor and reads none, so a round records the same
work with spans on or off, and none of this waits for the device.

One process-wide :data:`RECORDER` keeps the finished spans in a ring of
``2**16`` (the oldest dropped), so a days-long solve holds bounded
memory.  It is on by default; :func:`disable` turns it off.  Nesting
follows a stack of open spans per thread, so a phase deep in the engine
needs no round argument: it takes its run and round from the span that
encloses it.  Each ``Solver.solve`` and each ``SolverService`` begins a
run (:func:`begin_run`) of its mode, ``"solve"`` or ``"service"``.

Read them in memory (:func:`newest_run`, :func:`run_spans`,
:func:`self_ns`) or as a Chrome trace-event file (:func:`export_chrome`)
on the clock of ``torch.profiler``'s ``export_chrome_trace``, so that
the two files load together in Perfetto.

The spans are not records of the JSONL trace (``obs/trace.py``): that
schema is the reference's, record for record.
"""

from __future__ import annotations

import collections
import itertools
import json
import os
import threading
import time
from typing import Dict, Iterable, List, NamedTuple, Optional

#: Finished spans the process-wide recorder keeps.
CAPACITY = 1 << 16

#: ``torch.profiler``'s Chrome traces count microseconds from the start of
#: the current 7,889,238-second interval of the Unix epoch
#: (``baseTimeNanoseconds``); :func:`export_chrome` writes the same.
_TRACE_BASE_INTERVAL_S = 7889238


class Span(NamedTuple):
    """One finished span: ``parent`` is the id of the span that caused it
    (None for a root), ``run`` the id of its solve or service, ``round``
    the round it opened in, ``rid`` the request's id (``request`` and
    ``queued`` only)."""

    id: int
    name: str
    start_ns: int
    end_ns: int
    parent: Optional[int]
    run: int
    round: int
    rid: Optional[int] = None

    @property
    def duration_ns(self) -> int:
        return self.end_ns - self.start_ns


class _Opened:
    """The context manager :meth:`SpanRecorder.span` returns."""

    __slots__ = ("rec", "name", "run", "round", "pushed")

    def __init__(self, rec: "SpanRecorder", name: str, run: Optional[int],
                 round_no: Optional[int]):
        self.rec, self.name, self.run, self.round = rec, name, run, round_no
        self.pushed = False

    def __enter__(self) -> "_Opened":
        if self.rec.enabled:
            self.rec._push(self.name, self.run, self.round)
            self.pushed = True
        return self

    def __exit__(self, *exc) -> bool:
        if self.pushed:
            self.rec._pop()
        return False


class SpanRecorder:
    """A ring of finished spans and, per thread, the stack of open ones."""

    def __init__(self, capacity: int = CAPACITY):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.enabled = True
        self._done: collections.deque = collections.deque(maxlen=capacity)
        self._open: Dict[int, list] = {}          # open request spans
        self._ids = itertools.count(1)
        self._run_ids = itertools.count(1)
        self._newest: Dict[str, int] = {}         # mode -> newest run
        self._round: Dict[int, int] = {}          # run -> its newest round
        self._local = threading.local()

    # -- recording -----------------------------------------------------------

    def begin_run(self, mode: str) -> int:
        """A new run id, the newest of ``mode``."""
        run = next(self._run_ids)
        self._newest[mode] = run
        if len(self._round) >= self.capacity:
            self._round.pop(next(iter(self._round)))
        self._round[run] = 0
        return run

    def span(self, name: str, *, run: Optional[int] = None,
             round: Optional[int] = None) -> _Opened:
        """A span over a ``with`` block.  ``run`` and ``round`` default to
        the enclosing span's; a ``round`` given becomes the run's current
        round, which request spans opened later take."""
        return _Opened(self, name, run, round)

    def _stack(self) -> list:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def _push(self, name: str, run: Optional[int],
              round_no: Optional[int]) -> None:
        stack = self._stack()
        top = stack[-1] if stack else None
        if run is None:
            run = top[4] if top is not None else 0
        if round_no is None:
            round_no = (top[5] if top is not None
                        else self._round.get(run, 0))
        else:
            self._round[run] = round_no
        stack.append([next(self._ids), name, time.perf_counter_ns(),
                      top[0] if top is not None else None, run, round_no])

    def _pop(self) -> None:
        sid, name, start, parent, run, round_no = self._stack().pop()
        self._done.append(Span(sid, name, start, time.perf_counter_ns(),
                               parent, run, round_no))

    def open(self, name: str, *, run: int, rid: Optional[int] = None,
             parent: Optional[int] = None) -> int:
        """Open a span that outlives the call (a request's); returns its
        id for :meth:`close`, 0 when the recorder is off."""
        if not self.enabled:
            return 0
        if len(self._open) >= self.capacity:     # never closed: drop oldest
            self._open.pop(next(iter(self._open)))
        sid = next(self._ids)
        self._open[sid] = [name, time.perf_counter_ns(), parent or None, run,
                           self._round.get(run, 0), rid]
        return sid

    def close(self, sid: int) -> None:
        """Finish the span :meth:`open` returned (0 or an unknown id: no-op)."""
        entry = self._open.pop(sid, None)
        if entry is not None:
            name, start, parent, run, round_no, rid = entry
            self._done.append(Span(sid, name, start, time.perf_counter_ns(),
                                   parent, run, round_no, rid))

    # -- reading -------------------------------------------------------------

    def spans(self, run: Optional[int] = None) -> List[Span]:
        """Finished spans, oldest first; of one run when given."""
        done = list(self._done)
        return done if run is None else [s for s in done if s.run == run]

    def newest_run(self, mode: str) -> Optional[int]:
        """The newest run of ``mode`` ("solve" / "service"), or None."""
        return self._newest.get(mode)

    def run_spans(self, mode: str) -> List[Span]:
        """The finished spans of the newest run of ``mode``."""
        run = self.newest_run(mode)
        return [] if run is None else self.spans(run)

    def export_chrome(self, path: str, run: Optional[int] = None) -> int:
        """Write the finished spans (of one run when given) as Chrome
        trace events (``"ph": "X"``, microseconds) on the clock of
        ``torch.profiler``'s ``export_chrome_trace``; returns how many."""
        spans = self.spans(run)
        offset = time.time_ns() - time.perf_counter_ns()   # read once, here
        base = (int(time.time()) // _TRACE_BASE_INTERVAL_S
                * _TRACE_BASE_INTERVAL_S * 1_000_000_000)
        pid = os.getpid()
        events = [{"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                   "args": {"name": "repro_torch spans"}}]
        for s in spans:
            args = {"id": s.id, "run": s.run, "round": s.round}
            if s.parent is not None:
                args["parent"] = s.parent
            if s.rid is not None:
                args["rid"] = s.rid
            events.append({
                "ph": "X", "name": s.name, "cat": "repro_torch", "pid": pid,
                # Request spans overlap each other: a row of their own.
                "tid": 1 if s.rid is not None else 0,
                "ts": (s.start_ns + offset - base) / 1e3,
                "dur": s.duration_ns / 1e3, "args": args})
        with open(path, "w") as f:
            json.dump({"displayTimeUnit": "ms", "baseTimeNanoseconds": base,
                       "traceEvents": events}, f)
        return len(spans)


def self_ns(spans: Iterable[Span]) -> Dict[int, int]:
    """Each span's self time by id: its duration less the part of it that
    its children cover (their union, so overlapping children count once).
    A child whose parent is not among ``spans`` is ignored."""
    spans = list(spans)
    children: Dict[int, List[Span]] = collections.defaultdict(list)
    for s in spans:
        if s.parent is not None:
            children[s.parent].append(s)
    out = {}
    for s in spans:
        covered, edge = 0, s.start_ns
        for c in sorted(children.get(s.id, ()), key=lambda c: c.start_ns):
            lo, hi = max(c.start_ns, edge), min(c.end_ns, s.end_ns)
            if hi > lo:
                covered += hi - lo
                edge = hi
        out[s.id] = s.duration_ns - covered
    return out


#: The process-wide recorder the port's loops write to.
RECORDER = SpanRecorder()


def span(name: str, *, run: Optional[int] = None,
         round: Optional[int] = None) -> _Opened:
    """:meth:`SpanRecorder.span` of :data:`RECORDER`."""
    return RECORDER.span(name, run=run, round=round)


def begin_run(mode: str) -> int:
    """:meth:`SpanRecorder.begin_run` of :data:`RECORDER`."""
    return RECORDER.begin_run(mode)


def open_span(name: str, *, run: int, rid: Optional[int] = None,
              parent: Optional[int] = None) -> int:
    """:meth:`SpanRecorder.open` of :data:`RECORDER`."""
    return RECORDER.open(name, run=run, rid=rid, parent=parent)


def close_span(sid: int) -> None:
    """:meth:`SpanRecorder.close` of :data:`RECORDER`."""
    RECORDER.close(sid)


def enable() -> None:
    """Record spans (the default)."""
    RECORDER.enabled = True


def disable() -> None:
    """Record nothing: every span becomes a no-op."""
    RECORDER.enabled = False


def newest_run(mode: str) -> Optional[int]:
    return RECORDER.newest_run(mode)


def run_spans(mode: str) -> List[Span]:
    return RECORDER.run_spans(mode)


def export_chrome(path: str, run: Optional[int] = None) -> int:
    """:meth:`SpanRecorder.export_chrome` of :data:`RECORDER`."""
    return RECORDER.export_chrome(path, run)

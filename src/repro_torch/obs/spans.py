"""Spans of the port's round and service loops: the host's time of each
phase and, on the card, the device's time of a round's phases.

Where :mod:`repro_torch.obs.collect` counts what a round did, a span says
how long the host spent on each phase of it: one span a phase, never one
an engine step or a replay pass.  A round that replays its CUDA graphs
(``core.round_graph``) runs none of the plan's host code: it records one
``graph`` span in place of ``expand``, ``balance`` and the plan's
``replay``, with the ``readback`` and the chunks' ``replay`` inside it.

================  ===========================================  ===========
span              where                                        parent
================  ===========================================  ===========
``round``         one iteration of ``Solver.solve``'s loop;    --
                  all of ``SolverService.step_round``
``expand``        ``core.engine.make_expand.expand``           ``round``
``balance``       ``core.steal.balance_plan``,                 ``round``
                  ``core.steal.assign_tasks``
``replay``        ``make_round``'s plan, around                ``round``,
                  ``steal.replay_begin``; the replay chunks    ``graph``
                  (``core.round_graph``); the mesh's
                  ``steal.replay_received``
``readback``      ``core.round_graph.read_back``: the round's  ``round``,
                  one host read of the open work (and need)    ``graph``
``event``         ``Solver.solve``'s "round" ProgressEvent     ``round``
                  (only with a listener)
``admit``         ``SolverService._admit_and_place``           ``round``
``rebuild``       ``SolverService._rebuild_stacks``            ``admit``
``retire``        ``step_round`` after the readback            ``round``
``request``       ``SolverService.submit`` to the request's    --
                  terminal state (carries its ``rid``)
``queued``        ``submit`` to the request's admission        ``request``
``graph``         a replayed round's copy-in, graph launches,   ``round``
                  readback and clone-out (``core.round_graph``)
================  ===========================================  ===========

On a CUDA round of one device (``core.round_graph.GraphedRound``, eager
or replayed) the phases ``expand``, ``balance`` (twice) and ``replay``
(twice: the plan's and the chunks') also record a *device span*: a
``Span`` of ``clock`` "device", no parent, and the run and round of its
round.

================  ===========================================  ===========
device span       where the events are recorded                clock
================  ===========================================  ===========
``expand``        around ``make_expand.expand``'s 64 steps     ``device``
``balance``       around ``balance_plan`` and ``assign_tasks``  ``device``
``replay``        around ``replay_begin`` (in the plan) and     ``device``
                  around the round's replay chunks (deferred)
================  ===========================================  ===========

Two timing CUDA events on the round's stream bound each one, and nothing
else is enqueued.  While ``GraphedRound`` captures, the events are
recorded into the graph (``external=True``: event-record nodes), so every
replay records them again; the wrapper keeps them and hands them back to
the recorder at each replay (:func:`pend_device`).  The host never waits
for them: the round's own readback (``core.round_graph.read_back``) has
already waited for the card when :func:`read_device` reads their elapsed
times and files the spans.  The round's replay chunks run after that
readback, so their ``replay`` span is *deferred* (:func:`defer_device`):
it keeps its round and is filed once its events have completed, by the
next round's readback at the latest.  Durations are the card's;
positions are placed so that the last device span filed ends when
:func:`read_device` runs, on the host's clock (the two clocks share no
reading).  On the CPU, on a mesh of several shards, and with the
recorder off, no event is made and no device span is filed.

A name may be opened in more than one function (``balance`` twice a
round): readers sum by name and ``clock``.  Stamps are
``time.perf_counter_ns()``.  The recorder creates no tensor and reads
none, and on the card enqueues nothing but the device spans' event
records, so a round computes the same lanes with spans on or off, and
none of this waits for the device.

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
the two files load together in Perfetto; device spans are a row of
their own there.

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
    ``queued`` only), ``clock`` "host" or, for a device span, "device"."""

    id: int
    name: str
    start_ns: int
    end_ns: int
    parent: Optional[int]
    run: int
    round: int
    rid: Optional[int] = None
    clock: str = "host"

    @property
    def duration_ns(self) -> int:
        return self.end_ns - self.start_ns


class _Opened:
    """The context manager :meth:`SpanRecorder.span` returns."""

    __slots__ = ("rec", "name", "run", "round", "pushed", "device", "start")

    def __init__(self, rec: "SpanRecorder", name: str, run: Optional[int],
                 round_no: Optional[int], device: bool = False):
        self.rec, self.name, self.run, self.round = rec, name, run, round_no
        self.pushed = False
        self.device = device
        self.start = None

    def __enter__(self) -> "_Opened":
        if self.rec.enabled:
            self.rec._push(self.name, self.run, self.round)
            self.pushed = True
        if self.device:
            self.start = self.rec._event()
        return self

    def __exit__(self, *exc) -> bool:
        if self.start is not None:
            self.rec._close_device(self.name, self.start)
        if self.pushed:
            self.rec._pop()
        return False


class _DevicePhases:
    """The context manager :meth:`SpanRecorder.device_phases` returns:
    ``recorded`` holds the ``(name, start, end)`` events of the device
    spans opened inside it."""

    __slots__ = ("rec", "device", "recorded", "outer", "defer")

    def __init__(self, rec: "SpanRecorder", device, defer: bool = False):
        self.rec, self.device, self.defer = rec, device, defer
        self.recorded: list = []
        self.outer = None

    def __enter__(self) -> "_DevicePhases":
        local = self.rec._local
        self.outer = getattr(local, "armed", None)
        if self.rec.enabled and self.device.type == "cuda":
            local.armed = (self.device, self.recorded)
        return self

    def __exit__(self, *exc) -> bool:
        self.rec._local.armed = self.outer
        if self.defer:
            self.rec.defer_device(self.recorded)
        else:
            self.rec.pend_device(self.recorded)
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
        self._pending: list = []                  # the last round's events
        self._deferred: list = []                 # (name, start, end, run,
                                                  # round) filed when done

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
             round: Optional[int] = None, device: bool = False) -> _Opened:
        """A span over a ``with`` block.  ``run`` and ``round`` default to
        the enclosing span's; a ``round`` given becomes the run's current
        round, which request spans opened later take.  ``device``: inside
        :meth:`device_phases`, also a device span of the same name over
        the work the block enqueues."""
        return _Opened(self, name, run, round, device)

    def device_phases(self, device, defer: bool = False) -> _DevicePhases:
        """Arm device spans for a round body run on ``device`` (a
        ``torch.device``) inside the ``with`` block, and on leaving it
        make its events the pending ones (:meth:`pend_device`), or with
        ``defer`` deferred ones (:meth:`defer_device`).  Off the card, or
        with the recorder off, nothing is armed and nothing is left
        pending."""
        return _DevicePhases(self, device, defer)

    def _event(self):
        """A timing CUDA event recorded on the armed device's current
        stream (into the graph while capturing), or None when unarmed."""
        armed = getattr(self._local, "armed", None)
        if armed is None:
            return None
        import torch
        event = torch.cuda.Event(enable_timing=True, external=True)
        event.record(torch.cuda.current_stream(armed[0]))
        return event

    def _close_device(self, name: str, start) -> None:
        """Record the end event of device span ``name`` opened with
        ``start`` and keep the pair among the armed block's spans."""
        self._local.armed[1].append((name, start, self._event()))

    def pend_device(self, recorded) -> None:
        """Make ``recorded`` (``(name, start, end)`` events) the device
        spans of the round just enqueued, replacing any that were never
        read: a replayed graph records the same events again.  With the
        recorder off nothing is pending."""
        self._pending = list(recorded) if self.enabled else []

    def defer_device(self, recorded) -> None:
        """Keep ``recorded`` (``(name, start, end)`` events enqueued after
        the round's readback) under the run and round of the enclosing
        span, to be filed by a later :meth:`read_device` once their events
        have completed.  Fresh events only: a graph's would be recorded
        again before they are read.  With the recorder off nothing is
        kept."""
        if not self.enabled or not recorded:
            return
        run, round_no = self._here()
        self._deferred.extend((name, start, end, run, round_no)
                              for name, start, end in recorded)
        del self._deferred[:-self.capacity]

    def read_device(self) -> int:
        """File the deferred device spans whose events have completed,
        each under its own run and round, and the pending ones under the
        run and round of the enclosing span; call it after the host has
        waited for the round.  Returns how many were filed.  It never
        waits: a deferred span not yet completed stays deferred, and the
        pending ones are filed only when all of theirs have completed.
        Each elapsed time costs the host some microseconds, so a span
        takes two reads, one for the first: its start from the first
        span's and its duration."""
        pending, self._pending = self._pending, []
        if not self.enabled:
            self._deferred = []
            return 0
        ready, waiting = [], []
        for entry in self._deferred:
            (ready if _completed(entry[1], entry[2]) else waiting).append(
                entry)
        self._deferred = waiting
        here = self._here()
        spans = ready + [(name, start, end) + here
                         for name, start, end in pending]
        try:       # raises unless every event has completed; never waits
            ms = _elapsed(spans)
        except RuntimeError:
            spans = ready
            ms = _elapsed(spans)
        now = time.perf_counter_ns()
        last = max((start + took for start, took in ms), default=0.0)
        for (name, _, _, run, round_no), (start, took) in zip(spans, ms):
            start_ns = now - round((last - start) * 1e6)
            self._done.append(Span(
                next(self._ids), name, start_ns, start_ns + round(took * 1e6),
                None, run, round_no, clock="device"))
        return len(ms)

    def _here(self) -> tuple:
        """The run and round of the enclosing span, (0, 0) outside one."""
        stack = self._stack()
        return (stack[-1][4], stack[-1][5]) if stack else (0, 0)

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
                   "args": {"name": "repro_torch spans"}},
                  {"ph": "M", "name": "thread_name", "pid": pid, "tid": 2,
                   "args": {"name": "device (CUDA events)"}}]
        for s in spans:
            args = {"id": s.id, "run": s.run, "round": s.round}
            if s.parent is not None:
                args["parent"] = s.parent
            if s.rid is not None:
                args["rid"] = s.rid
            events.append({
                "ph": "X", "name": s.name, "cat": "repro_torch", "pid": pid,
                # Request spans overlap each other, device spans the host's:
                # a row each of their own.
                "tid": (2 if s.clock == "device"
                        else 1 if s.rid is not None else 0),
                "ts": (s.start_ns + offset - base) / 1e3,
                "dur": s.duration_ns / 1e3, "args": args})
        with open(path, "w") as f:
            json.dump({"displayTimeUnit": "ms", "baseTimeNanoseconds": base,
                       "traceEvents": events}, f)
        return len(spans)


def _completed(start, end) -> bool:
    """Whether both events of a device span have completed (never
    waits)."""
    try:
        start.elapsed_time(end)
    except RuntimeError:
        return False
    return True


def _elapsed(spans: list) -> list:
    """``(start, duration)`` in milliseconds of each ``(name, start, end,
    ...)`` span, the start from the first span's; raises RuntimeError
    when an event has not completed."""
    if not spans:
        return []
    origin = spans[0][1]
    return [(origin.elapsed_time(start) if start is not origin else 0.0,
             start.elapsed_time(end)) for _, start, end, *_ in spans]


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
         round: Optional[int] = None, device: bool = False) -> _Opened:
    """:meth:`SpanRecorder.span` of :data:`RECORDER`."""
    return RECORDER.span(name, run=run, round=round, device=device)


def device_phases(device, defer: bool = False) -> _DevicePhases:
    """:meth:`SpanRecorder.device_phases` of :data:`RECORDER`."""
    return RECORDER.device_phases(device, defer)


def pend_device(recorded) -> None:
    """:meth:`SpanRecorder.pend_device` of :data:`RECORDER`."""
    RECORDER.pend_device(recorded)


def defer_device(recorded) -> None:
    """:meth:`SpanRecorder.defer_device` of :data:`RECORDER`."""
    RECORDER.defer_device(recorded)


def read_device() -> int:
    """:meth:`SpanRecorder.read_device` of :data:`RECORDER`."""
    return RECORDER.read_device()


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

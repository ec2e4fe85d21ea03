"""One CUDA graph for a round's plan, and one for a chunk of its replay.

A round of the port (64 engine steps, the steal, its replay passes, the
open-work count) is tens of thousands of small eager PyTorch operations
whose host dispatch, not the card, sets its time.  No round function
reads back to the host, the kernels launch on torch's current stream and
the shapes are fixed for a solve or a service, so the round can be
captured once as ``torch.cuda.CUDAGraph`` s and replayed: a graph launch
in place of every dispatch, the same kernels in the same order, the same
tree bitwise.

:class:`GraphedRound` runs a single-device round
(``core.distributed.make_round``) as two bodies:

* the **plan** ``Lanes -> (lanes, flags, state)``: all of the round
  that runs once (in ``make_round``: the engine steps, the steal, the
  start of the replay) and a small int32 vector ``flags``;
* the **chunk** ``(lanes, state) -> None``: a fixed piece of work in
  place into the plan's lanes, launched as many times as the round
  needs (in ``make_round``: a chunk of replay passes).

Between them the host reads ``flags`` back, the round's one wait for the
card (:func:`read_back`), and the caller's host function ``chunks(flags)
-> (n, open_work)`` says how many chunks to launch, none on a round that
needs none.  The chunks are stream-ordered before whatever later reads
the lanes.  The round returns the lanes and the open work, already on
the host.

* **when**: on a CUDA device.  On any other device both bodies run
  eager; a mesh of several shards never reaches this class:
  ``make_round`` gives it to :func:`eager`, which counts its rounds as
  ``"mesh"`` and reads its open work back;
* **warm-up, capture, replay**: the first call with a new *key* (shape,
  dtype and device of every ``Lanes`` leaf) runs eager: it builds and
  loads the kernels, warms the caching allocator and fixes every shape.
  The second captures both bodies, each into a private memory pool, and
  replays; every later call with that key replays.  A new key drops the
  graphs and starts again;
* **functional**: the inputs are copied into the plan graph's static
  inputs, the chunks write into its static outputs, and the caller gets
  clones of those, never the graph's own buffers, so callers may keep or
  edit what a round returned, as they do with an eager round's;
* **launch accounting**: ``_build.LAUNCHES`` counts on the host, which a
  replay never reaches.  The launches made while capturing (which ran
  nothing) are taken back out; every replay of the plan adds the plan's,
  every chunk launched the chunk's, so every count reads as the eager
  rounds would have made it;
* **fallback**: a capture that raises (a body that syncs) warns once and
  leaves the round eager from then on, each such round counted as
  ``"capture_failed"``;
* **short bodies**: a capture costs about one eager round more than the
  round it replays, so it pays only from a body's third call on.  A
  caller that knows a body gets fewer calls (``Solver.solve``'s
  bootstrap body, ``bootstrap_rounds`` of them) says so with ``calls``,
  and such a body stays eager, each round counted as ``"short"``.

A replayed round records one ``graph`` span (``obs/spans.py``) around the
copy-in, the plan's launch, the readback, the chunks and the clone-out;
inside it the ``readback`` and ``replay`` spans.  The plan's ``expand``,
``balance`` and ``replay`` spans are recorded only on eager rounds and
while capturing.  Their device spans are recorded on every CUDA round:
an eager round arms them (``spans.device_phases``) and the plan records
fresh events; the capture arms them too, so its events become
event-record nodes of the graph, which the wrapper keeps and hands back
to the recorder (``spans.pend_device``) at every replay.  The chunks'
``replay`` device span is two fresh events around the chunk launches;
it completes after the readback, so it is deferred
(``spans.defer_device``) and filed under its own round by the next
round's readback.
"""

from __future__ import annotations

import warnings
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.core.api import tree_leaves, tree_map
from repro_torch.kernels import _build
from repro_torch.obs import spans

#: Round calls since the last ``reset_counts()``: graphs captured, rounds
#: replayed, and the rounds that ran eager, by reason (not on a card, a
#: mesh of several shards, a new key's warm-up, a failed capture, a body
#: with too few calls to pay for a capture).
COUNTS: Dict[str, int] = dict.fromkeys(
    ("captures", "replays", "cpu", "mesh", "warmup", "capture_failed",
     "short"), 0)

#: The fewest calls of a body for which a capture pays: the warm-up, the
#: capture (about two eager rounds' host time) and one replay.
MIN_CALLS = 3


def reset_counts() -> None:
    for name in COUNTS:
        COUNTS[name] = 0


def read_back(values: torch.Tensor) -> torch.Tensor:
    """The round's one wait for the card: ``values`` (the open work and,
    on one device, ``need``) copied to the host in one copy, inside the
    round's ``readback`` span."""
    with spans.span("readback"):
        # torch-lint: disable=trace-safety -- the round's one readback
        return values.to("cpu", copy=True)


def eager(fn: Callable, reason: str) -> Callable:
    """The round body ``fn`` left eager, each call counted under
    ``reason`` in :data:`COUNTS`; it records no device span, and its
    open work comes back to the host (:func:`read_back`)."""
    def counted(lanes):
        COUNTS[reason] += 1
        spans.pend_device(())
        lanes, open_work = fn(lanes)
        return lanes, read_back(open_work)

    return counted


def _add(launches: Dict[str, int]) -> None:
    for name, n in launches.items():
        _build.LAUNCHES[name] += n


class CudaGraph:
    """Capture and replay on the card (``torch.cuda.CUDAGraph``): the
    backend of :class:`GraphedRound`.  A test may give another with the
    same three members."""

    @staticmethod
    def applies(device: torch.device) -> bool:
        return device.type == "cuda"

    def __init__(self, device: torch.device):
        self.device = device
        self.graph = torch.cuda.CUDAGraph()

    def capture(self, fn: Callable):
        """Record ``fn()`` into the graph (nothing runs) on a side stream
        ordered after the current one, into a private memory pool, and
        return its outputs: the graph's static outputs."""
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.device(self.device), torch.cuda.stream(side):
            self.graph.capture_begin()
            try:
                out = fn()
            finally:
                self.graph.capture_end()
        current.wait_stream(side)
        return out

    def replay(self) -> None:
        self.graph.replay()


def _key(lanes) -> Tuple:
    return tuple((tuple(x.shape), x.dtype, x.device)
                 for x in tree_leaves(lanes))


class GraphedRound:
    """The round of ``plan`` and ``chunk`` run as CUDA graphs where it can
    be, ``chunks`` deciding on the host how many chunks a round launches
    (see the module's docstring); :meth:`fn` is the same round eager.
    ``calls`` is the most calls the caller will make, where it knows
    it."""

    def __init__(self, plan: Callable, chunk: Callable, chunks: Callable,
                 backend=CudaGraph, calls: Optional[int] = None):
        self.plan = plan
        self.chunk = chunk
        self.chunks = chunks
        self.backend = backend
        self.calls = calls
        self._key: Optional[Tuple] = None
        self._graph = None
        self._chunk_graph = None
        self._static_in = None
        self._static_out = None
        self._launches: Dict[str, int] = {}
        self._chunk_launches: Dict[str, int] = {}
        self._device_spans: list = []
        self._failed = False

    def __call__(self, lanes):
        device = lanes.idx.device
        if not self.backend.applies(device):
            COUNTS["cpu"] += 1
            return self.fn(lanes)
        if self._failed:
            COUNTS["capture_failed"] += 1
            return self.fn(lanes)
        if self.calls is not None and self.calls < MIN_CALLS:
            COUNTS["short"] += 1
            return self.fn(lanes)
        key = _key(lanes)
        if key != self._key:
            self._graph = self._chunk_graph = None
            self._static_in = self._static_out = None
            self._key = key
            COUNTS["warmup"] += 1
            return self.fn(lanes)
        if self._graph is None and not self._capture(lanes, device):
            COUNTS["capture_failed"] += 1
            return self.fn(lanes)
        COUNTS["replays"] += 1
        with spans.span("graph"):
            for static, leaf in zip(tree_leaves(self._static_in),
                                    tree_leaves(lanes)):
                static.copy_(leaf)
            self._graph.replay()
            spans.pend_device(self._device_spans)
            _add(self._launches)
            out, flags, _ = self._static_out
            open_work = self._finish(flags, device, self._replay_chunk)
            return tree_map(torch.clone, out), open_work

    def fn(self, lanes):
        """The round eager: the plan, the readback, the chunks."""
        device = lanes.idx.device
        with spans.device_phases(device):
            lanes, flags, replay = self.plan(lanes)
        return lanes, self._finish(flags, device,
                                   lambda: self.chunk(lanes, replay))

    def _replay_chunk(self) -> None:
        self._chunk_graph.replay()
        _add(self._chunk_launches)

    def _finish(self, flags: torch.Tensor, device: torch.device,
                run_chunk: Callable) -> torch.Tensor:
        """Read ``flags`` back, file the device spans that have completed,
        and run the chunks ``self.chunks`` asks for inside the ``replay``
        span; returns the open work on the host."""
        host = read_back(flags)
        spans.read_device()
        n, open_work = self.chunks(host)
        with spans.device_phases(device, defer=True):
            with spans.span("replay", device=True):
                for _ in range(n):
                    run_chunk()
        return open_work

    def _capture(self, lanes, device: torch.device) -> bool:
        """Capture ``plan`` on static inputs shaped as ``lanes``, then
        ``chunk`` on the plan's static outputs; False (and this round
        eager from now on) when either capture raises."""
        static_in = tree_map(torch.clone, lanes)
        before = dict(_build.LAUNCHES)
        plan_graph, chunk_graph = self.backend(device), self.backend(device)
        try:
            with spans.device_phases(device) as phases:
                out = plan_graph.capture(lambda: self.plan(static_in))
            mid = dict(_build.LAUNCHES)
            chunk_graph.capture(lambda: self.chunk(out[0], out[2]))
        except RuntimeError as e:
            self._failed = True
            warnings.warn(f"the round body could not be captured as a CUDA "
                          f"graph and runs eager from now on: {e}",
                          RuntimeWarning, stacklevel=3)
            return False
        finally:
            after = dict(_build.LAUNCHES)
            _build.LAUNCHES.update(before)
        self._graph, self._chunk_graph = plan_graph, chunk_graph
        self._static_in, self._static_out = static_in, out
        self._device_spans = phases.recorded
        self._launches = {name: n - before[name] for name, n in mid.items()
                          if n != before[name]}
        self._chunk_launches = {name: n - mid[name]
                                for name, n in after.items()
                                if n != mid[name]}
        COUNTS["captures"] += 1
        return True

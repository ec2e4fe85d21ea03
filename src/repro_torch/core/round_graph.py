"""One CUDA graph for a round body.

A round of the port (64 engine steps, the steal, its D+1 replay passes,
the open-work count) is tens of thousands of small eager PyTorch
operations whose host dispatch, not the card, sets its time.  No round
function reads back to the host, the kernels launch on torch's current
stream and the shapes are fixed for a solve or a service, so the whole
round can be captured once as a ``torch.cuda.CUDAGraph`` and replayed:
one graph launch in place of every dispatch, the same kernels in the
same order, the same tree bitwise.

:class:`GraphedRound` wraps a single-device round body ``Lanes ->
(Lanes, open_work)`` (``core.distributed.make_round``):

* **when**: on a CUDA device.  On any other device the body runs eager,
  exactly as without the wrapper; a mesh of several shards never reaches
  it: ``make_round`` gives it to :func:`eager`, which counts its rounds as
  ``"mesh"``;
* **warm-up, capture, replay**: the first call with a new *key* (shape,
  dtype and device of every ``Lanes`` leaf) runs eager: it builds and
  loads the kernels, warms the caching allocator and fixes every shape.
  The second captures into a private memory pool and replays; every
  later call with that key replays.  A new key drops the graph and
  starts again;
* **functional**: the inputs are copied into the graph's static inputs,
  and the caller gets clones of its static outputs (``open_work``
  included), never the graph's own buffers, so callers may keep or edit
  what a round returned, as they do with an eager round's;
* **launch accounting**: ``_build.LAUNCHES`` counts on the host, which a
  replay never reaches.  The launches made while capturing (which ran
  nothing) are taken back out and added again on every replay, so every
  count reads as the eager rounds would have made it;
* **fallback**: a capture that raises (a body that syncs) warns once and
  leaves that body eager from then on, each such round counted as
  ``"capture_failed"``.
* **short bodies**: a capture costs about one eager round more than the
  round it replays, so it pays only from a body's third call on.  A
  caller that knows a body gets fewer calls (``Solver.solve``'s
  bootstrap body, ``bootstrap_rounds`` of them) says so with ``calls``,
  and such a body stays eager, each round counted as ``"short"``.

A replayed round records one ``graph`` span (``obs/spans.py``) around the
copy-in, the replay and the clone-out; the ``expand``, ``balance`` and
``replay`` spans inside the body are recorded only on eager rounds and
while capturing.  Their device spans are recorded on every CUDA round:
an eager round arms them (``spans.device_phases``) and the body records
fresh events; the capture arms them too, so its events become
event-record nodes of the graph, which the wrapper keeps and hands back
to the recorder (``spans.pend_device``) at every replay.
"""

from __future__ import annotations

import warnings
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.core.api import tree_leaves, tree_map
from repro_torch.kernels import _build
from repro_torch.obs import spans

#: Round-body calls since the last ``reset_counts()``: graphs captured,
#: rounds replayed, and the rounds that ran eager, by reason (not on a
#: card, a mesh of several shards, a new key's warm-up, a failed capture,
#: a body with too few calls to pay for a capture).
COUNTS: Dict[str, int] = dict.fromkeys(
    ("captures", "replays", "cpu", "mesh", "warmup", "capture_failed",
     "short"), 0)

#: The fewest calls of a body for which a capture pays: the warm-up, the
#: capture (about two eager rounds' host time) and one replay.
MIN_CALLS = 3


def reset_counts() -> None:
    for name in COUNTS:
        COUNTS[name] = 0


def eager(fn: Callable, reason: str) -> Callable:
    """The round body ``fn`` left eager, each call counted under
    ``reason`` in :data:`COUNTS`; it records no device span."""
    def counted(lanes):
        COUNTS[reason] += 1
        spans.pend_device(())
        return fn(lanes)

    return counted


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
    """The round body ``fn`` run as one CUDA graph where it can be (see the
    module's docstring); ``fn`` stays reachable as ``.fn``.  ``calls`` is
    the most calls the caller will make, where it knows it."""

    def __init__(self, fn: Callable, backend=CudaGraph,
                 calls: Optional[int] = None):
        self.fn = fn
        self.backend = backend
        self.calls = calls
        self._key: Optional[Tuple] = None
        self._graph = None
        self._static_in = None
        self._static_out = None
        self._launches: Dict[str, int] = {}
        self._device_spans: list = []
        self._failed = False

    def __call__(self, lanes):
        device = lanes.idx.device
        if not self.backend.applies(device):
            COUNTS["cpu"] += 1
            return self._eager(lanes, device)
        if self._failed:
            COUNTS["capture_failed"] += 1
            return self._eager(lanes, device)
        if self.calls is not None and self.calls < MIN_CALLS:
            COUNTS["short"] += 1
            return self._eager(lanes, device)
        key = _key(lanes)
        if key != self._key:
            self._graph = self._static_in = self._static_out = None
            self._key = key
            COUNTS["warmup"] += 1
            return self._eager(lanes, device)
        if self._graph is None and not self._capture(lanes, device):
            COUNTS["capture_failed"] += 1
            return self._eager(lanes, device)
        COUNTS["replays"] += 1
        with spans.span("graph"):
            for static, leaf in zip(tree_leaves(self._static_in),
                                    tree_leaves(lanes)):
                static.copy_(leaf)
            self._graph.replay()
            spans.pend_device(self._device_spans)
            for name, n in self._launches.items():
                _build.LAUNCHES[name] += n
            return tree_map(torch.clone, self._static_out)

    def _eager(self, lanes, device: torch.device):
        """``fn(lanes)`` run eager, its device spans armed on the card."""
        with spans.device_phases(device):
            return self.fn(lanes)

    def _capture(self, lanes, device: torch.device) -> bool:
        """Capture ``fn`` on static inputs shaped as ``lanes``; False (and
        this body eager from now on) when the capture raises."""
        static_in = tree_map(torch.clone, lanes)
        before = dict(_build.LAUNCHES)
        graph = self.backend(device)
        try:
            with spans.device_phases(device) as phases:
                out = graph.capture(lambda: self.fn(static_in))
        except RuntimeError as e:
            self._failed = True
            warnings.warn(f"the round body could not be captured as a CUDA "
                          f"graph and runs eager from now on: {e}",
                          RuntimeWarning, stacklevel=3)
            return False
        finally:
            captured = {name: n - before[name]
                        for name, n in _build.LAUNCHES.items()}
            _build.LAUNCHES.update(before)
        self._graph, self._static_in, self._static_out = graph, static_in, out
        self._device_spans = phases.recorded
        self._launches = {name: n for name, n in captured.items() if n}
        COUNTS["captures"] += 1
        return True

"""Three-term roofline and device memory of one step, counted while the
step runs (counterpart of ``repro.roofline``).

The reference walks the compiled HLO: it multiplies each op by its
loops' trip counts, models which elementwise ops a TPU compiler fuses,
and reads buffer sizes from XLA's memory analysis.  Eager PyTorch has no
lowering step and no buffer assignment: each ATen operation is one
kernel, nothing is fused and nothing loops behind the host's back.  So
:func:`analyze` runs the real step function once, as the card would run
it, under a ``TorchDispatchMode`` that sees every ATen operation.  Given
tensors on the ``meta`` device (shapes and dtypes, no storage) the run
allocates nothing; given real tensors it counts the same.

* **FLOPs**: ``torch.utils.flop_counter``'s formulas (mm, addmm, bmm,
  baddbmm, convolution, SDPA), plus the FLOPs each hand-written kernel
  records through :func:`record_kernel` (its cost function's).
* **HBM bytes**: each operation reads each input once and writes each
  output once; a view or other aliasing operation counts nothing; an
  in-place (or ``out=``) operation counts the tensor it writes once.  A
  kernel counts its cost function's bytes (its inputs and outputs).
* **score bytes**: the bytes of the operations that run inside
  ``kernels.plain_grad.PlainGrad``'s backward: the plain versions the
  training backward recomputes, whose score blocks (attention's
  ``[S, S]`` tiles, the SSD's chunk matrices) cross HBM.  They are part
  of the HBM bytes, reported beside them, not subtracted: a backward
  kernel that kept them on chip would save them.
* **collective bytes**: what one shard sends another in a round, as the
  mesh's round records it (:func:`record_collective`: the task rows and
  counts the cross-device steal gathers, the incumbent min and the
  open-work sum), by the reference's collective names.
* **memory** (:class:`MemoryCounts`): the live set of storages, keyed
  by storage so that views count once, each freed when its last tensor
  goes.

The terms: compute = FLOPs / peak (plus the kernels' non-FLOP issue
time), memory = HBM bytes / HBM rate, collective = collective bytes /
link rate, all seconds.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Callable, Dict, Iterator, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import plain_grad
from repro_torch.kernels.autotune import PEAK_FLOPS, KernelCost

__all__ = ["DTYPE_BYTES", "MemoryCounts", "RooflineCounts", "analyze",
           "dominant", "model_flops", "record_collective", "record_kernel"]

#: Bytes per element, the reference's table in PyTorch's names.
DTYPE_BYTES = {
    torch.bool: 1, torch.int8: 1, torch.uint8: 1, torch.int16: 2,
    torch.int32: 4, torch.int64: 8, torch.float16: 2, torch.bfloat16: 2,
    torch.float32: 4, torch.float64: 8, torch.float8_e4m3fn: 1,
    torch.float8_e5m2: 1, torch.complex64: 8, torch.complex128: 16,
}

#: Operations that allocate and neither read nor write: they move no
#: bytes.
_NO_WRITE = ("empty", "empty_strided", "empty_like", "new_empty",
             "new_empty_strided")

#: Matrix products: the reference's ``dots``.
_DOTS = ("mm", "addmm", "bmm", "baddbmm")


@dataclasses.dataclass
class RooflineCounts:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_bytes: float = 0.0
    per_collective: Dict[str, float] = dataclasses.field(default_factory=dict)
    dots: int = 0
    #: bytes of the plain recomputes inside the training backward
    #: (``PlainGrad``): part of ``hbm_bytes``, reported beside it.
    score_bytes: float = 0.0
    #: seconds the hand-written kernels' operations take beyond their
    #: FLOPs at the bf16 peak: popcounts and logic, the SFU's exps, f32
    #: products (each launch's cost function's ``op_s`` less its FLOPs'
    #: share).
    issue_s: float = 0.0
    #: launches of each hand-written kernel.
    kernels: Dict[str, int] = dataclasses.field(default_factory=dict)

    def terms(self, peak_flops: float, hbm_bw: float, link_bw: float
              ) -> Dict[str, float]:
        """``memory_kernel_adj_s`` is the memory term less the score
        bytes: what it would be if the backward's recomputes kept their
        blocks on chip."""
        return {
            "compute_s": self.flops / peak_flops + self.issue_s,
            "memory_s": self.hbm_bytes / hbm_bw,
            "memory_kernel_adj_s": max(self.hbm_bytes - self.score_bytes,
                                       0.0) / hbm_bw,
            "collective_s": self.collective_bytes / link_bw,
        }


@dataclasses.dataclass
class MemoryCounts:
    """Device memory of one step, the reference's fields: the tensors
    passed in (and any the step reads that it did not allocate, such as
    a closure's tables), the live peak inside the step above them and
    its new outputs, the outputs, and the outputs that are arguments
    (written in place: AdamW's params and moments, decode's cache)."""

    argument_bytes: int = 0
    temp_bytes: int = 0
    output_bytes: int = 0
    alias_bytes: int = 0

    @property
    def peak_bytes(self) -> int:
        return (self.argument_bytes + self.temp_bytes + self.output_bytes
                - self.alias_bytes)


def _tensors(tree: Any) -> Iterator[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _bytes(t: torch.Tensor) -> int:
    """Bytes a read or write of ``t`` moves: its elements, at most its
    storage (a broadcast view reads its storage once)."""
    return min(t.numel() * DTYPE_BYTES[t.dtype],
               t.untyped_storage().nbytes())


class _Counter(TorchDispatchMode):
    """Counts every ATen operation of a run; tracks the live storages."""

    def __init__(self, args: Tuple):
        super().__init__()
        self.counts = RooflineCounts()
        self.live: Dict[int, int] = {}
        self.arguments: Dict[int, int] = {}
        for t in _tensors(args):
            self._argument(t)
        self.peak = self.current = sum(self.live.values())
        self.closed = False

    def _argument(self, t: torch.Tensor) -> None:
        key = _key(t)
        if key not in self.live:
            nbytes = t.untyped_storage().nbytes()
            self.live[key] = self.arguments[key] = nbytes

    def _allocated(self, t: torch.Tensor) -> None:
        storage = t.untyped_storage()
        key = storage._cdata
        if key in self.live:
            return
        nbytes = storage.nbytes()
        self.live[key] = nbytes
        self.current += nbytes
        self.peak = max(self.peak, self.current)
        weakref.finalize(storage, self._freed, key)

    def _freed(self, key: int) -> None:
        if self.closed or key in self.arguments:
            return
        nbytes = self.live.pop(key, 0)
        self.current -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        inputs = list(_tensors((args, kwargs)))
        for t in inputs:
            if _key(t) not in self.live:
                # Held outside the step all along: an argument.
                self._argument(t)
                nbytes = self.live[_key(t)]
                self.current += nbytes
                self.peak += nbytes
        outputs = list(_tensors(out))
        in_keys = {_key(t) for t in inputs}
        for t in outputs:
            self._allocated(t)
        self._count(func, args, kwargs, out, inputs, outputs, in_keys)
        return out

    def _count(self, func, args, kwargs, out, inputs, outputs,
               in_keys) -> None:
        c = self.counts
        packet = func._overloadpacket
        if packet in flop_registry:
            c.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        if packet.__name__ in _DOTS:
            c.dots += 1
        if packet.__name__ in _NO_WRITE:
            return
        schema = func._schema
        written = [v for a, v in zip(schema.arguments, args)
                   if a.alias_info is not None and a.alias_info.is_write
                   and isinstance(v, torch.Tensor)]
        written += [kwargs[a.name] for a in schema.arguments
                    if a.alias_info is not None and a.alias_info.is_write
                    and isinstance(kwargs.get(a.name), torch.Tensor)]
        if not written and all(_key(t) in in_keys for t in outputs):
            return                                   # a view
        written_ids = {id(t) for t in written}
        nbytes = sum(_bytes(t) for t in inputs
                     if id(t) not in written_ids)
        nbytes += sum(_bytes(t) for t in written)
        nbytes += sum(_bytes(t) for t in outputs
                      if _key(t) not in in_keys)
        c.hbm_bytes += nbytes
        if plain_grad.recomputing():
            c.score_bytes += nbytes

    def kernel(self, name: str, cost: KernelCost) -> None:
        c = self.counts
        c.flops += cost.flops
        c.hbm_bytes += cost.nbytes
        c.issue_s += max(cost.op_s - cost.flops / PEAK_FLOPS[torch.bfloat16],
                         0.0)
        c.kernels[name] = c.kernels.get(name, 0) + 1

    def collective(self, kind: str, nbytes: int) -> None:
        c = self.counts
        c.collective_bytes += nbytes
        c.per_collective[kind] = c.per_collective.get(kind, 0.0) + nbytes

    def finish(self, out: Any) -> MemoryCounts:
        self.closed = True
        outs: Dict[int, int] = {}
        for t in _tensors(out):
            outs[_key(t)] = t.untyped_storage().nbytes()
        arg_b = sum(self.arguments.values())
        out_b = sum(outs.values())
        alias_b = sum(n for k, n in outs.items() if k in self.arguments)
        return MemoryCounts(argument_bytes=arg_b,
                            temp_bytes=self.peak - arg_b - (out_b - alias_b),
                            output_bytes=out_b, alias_bytes=alias_b)


#: The counters of the :func:`analyze` calls in progress, innermost last.
_ACTIVE: List[_Counter] = []


def record_kernel(name: str, cost: KernelCost) -> None:
    """A hand-written kernel's abstract launch (a wrapper's ``meta``
    route): its cost goes to the innermost :func:`analyze` in progress,
    if any."""
    if _ACTIVE:
        _ACTIVE[-1].kernel(name, cost)


def record_collective(kind: str, piece: torch.Tensor) -> None:
    """One shard's ``piece`` of a collective (``"all-gather"``,
    ``"all-reduce"``): the bytes it sends, to the innermost
    :func:`analyze` in progress, if any."""
    if _ACTIVE:
        _ACTIVE[-1].collective(kind, _bytes(piece))


def analyze(fn: Callable, *args
            ) -> Tuple[RooflineCounts, MemoryCounts, Any]:
    """Run ``fn(*args)`` once, counting as the card would run it: ->
    (roofline counts, memory, ``fn``'s output).  ``args`` on ``meta``
    make it a dry run that allocates nothing."""
    counter = _Counter(args)
    _ACTIVE.append(counter)
    try:
        with counter:
            out = fn(*args)
    finally:
        _ACTIVE.pop()
    return counter.counts, counter.finish(out), out


def model_flops(cfg, tokens: int, is_train: bool) -> float:
    """MODEL_FLOPS = 6·N_active·D tokens (2 fwd + 4 bwd per param-token);
    serving counts 2·N_active·D."""
    n = cfg.active_param_count()
    return (6.0 if is_train else 2.0) * n * tokens


def dominant(terms: Dict[str, float]) -> str:
    """The largest of the three terms: ``compute_s``, ``memory_s`` or
    ``collective_s``."""
    three = {k: terms[k] for k in ("compute_s", "memory_s", "collective_s")}
    return max(three, key=three.get)

"""Route choice for the bitset count kernels on Hopper (counterpart of
``repro.kernels.autotune``).

The reference picks a Pallas ``tile`` and ``stages`` for a TPU; the
port's kernels have neither.  What ``count_stats`` and
``stacked_count_stats`` do have is two compiled routes:

* ``narrow`` (w <= 32 words a row): the lane's mask words held in
  registers for every k-step (``count_stats_kernel<KS>``,
  ``stacked_count_stats_kernel<MAXW>``);
* ``wide`` (any w): registers that do not grow with w, the mask words
  re-read from L1 where they are needed (``*_wide_kernel``).

:func:`choose` scores the valid routes with :func:`predict_cost`, the
H100 roofline of one pass plus a launch, and caches the pick per ``(n, w,
L, K, device type)``; the wrappers pass the route to the launcher.  The
roofline costs both routes the same and a tie goes to ``narrow``, so with
no :func:`measured_choice` every launch takes the route the launchers took
before routes were an argument.  :func:`measured_choice` times both routes
on the card and overrides the cache with the faster.

The H100 constants and :func:`roofline` are what ``chip_smoke.py``
computes its bounds from.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

#: NVIDIA H100 SXM (data sheet): 132 SMs, HBM3 at 3.35 TB/s, 989 TFLOP/s
#: dense bf16 on the tensor cores, 67 TFLOP/s float32 outside them; its
#: SM clock runs up to 1980 MHz (``nvidia-smi --query-gpu=clocks.max.sm``).
SMS = 132
HBM_BYTES_PER_S = 3.35e12
SM_CLOCK_HZ = 1.98e9
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
#: Results per clock per SM on compute capability 9.0 (CUDA C++
#: Programming Guide, arithmetic instruction throughput): ``__popc`` 16,
#: the SFU (exp2, reciprocal, tanh) 16, 32-bit AND/OR 64.
POPC_PER_CLOCK_PER_SM = 16
SFU_PER_CLOCK_PER_SM = 16
LOGIC_PER_CLOCK_PER_SM = 64
#: A launch's floor: the device time of an empty kernel with
#: ``popcount_reduce``'s grid and block (``chip_smoke.py`` phase 11:
#: 0.95 us on an H100 80GB HBM3 at 700 W).
LAUNCH_OVERHEAD_S = 0.95e-6

#: Clock cycles the spin kernel of :func:`measured_choice` waits for each
#: launch the host queues behind it (50 us at 2 GHz: more than the
#: wrapper's host time per launch).
_SPIN_CYCLES_PER_LAUNCH = 100_000

#: Routes in order of preference on a tie.
ROUTES = ("narrow", "wide")
#: The narrow kernels hold at most this many words of a row.
NARROW_MAX_WORDS = 32


class KernelCost(NamedTuple):
    """The work of one kernel launch, from its inputs (each kernel's
    ``cost`` function beside its wrapper): ``flops`` its floating-point
    products, ``op_s`` the least seconds of all its operations at the
    card's peak rate for their type (products in their dtype, popcounts,
    logic, the SFU's exps), ``nbytes`` each input read once and each
    output written once.  ``chip_smoke.py``'s bounds and the dry run's
    roofline both read it."""

    flops: float
    op_s: float
    nbytes: int

    def bound(self) -> Tuple[float, str]:
        """(least seconds, what bounds them): the larger of ``op_s`` and
        the bytes over HBM's rate."""
        bytes_s = self.nbytes / HBM_BYTES_PER_S
        if self.op_s >= bytes_s:
            return self.op_s, "operations"
        return bytes_s, "bytes"


def issue_s(ops: int, per_clock_per_sm: int, sms: int = SMS,
            clock_hz: float = SM_CLOCK_HZ) -> float:
    """Seconds to issue ``ops`` instructions of a unit that completes
    ``per_clock_per_sm`` a clock on each of ``sms`` SMs at ``clock_hz``."""
    return ops / (per_clock_per_sm * sms * clock_hz)


class KernelChoice(NamedTuple):
    """One decision: the route, and the milliseconds of each route when
    :func:`measured_choice` timed them."""

    route: str
    measured_ms: Optional[Dict[str, float]] = None


_CACHE: Dict[Tuple[int, int, int, int, str], KernelChoice] = {}


def routes(w: int) -> Tuple[str, ...]:
    """The routes that take rows of ``w`` words."""
    return ROUTES if w <= NARROW_MAX_WORDS else ("wide",)


class Roofline(NamedTuple):
    """The least time of one pass and what sets it: the bytes the pass
    must move over HBM's rate, or its popcounts over their issue rate on
    the CUDA cores, whichever is larger."""

    seconds: float
    bound_by: str            # "bytes" or "operations"
    nbytes: int
    popcounts: int
    bytes_s: float
    popcount_s: float


def popcount_issue_s(popcounts: int, sms: int = SMS,
                     clock_hz: float = SM_CLOCK_HZ) -> float:
    """Seconds to issue ``popcounts`` ``__popc`` on ``sms`` SMs at
    ``clock_hz``."""
    return issue_s(popcounts, POPC_PER_CLOCK_PER_SM, sms, clock_hz)


def roofline(n: int, w: int, lanes: int, k: int = 1, *,
             valid_pairs: Optional[int] = None, sms: int = SMS,
             clock_hz: float = SM_CLOCK_HZ) -> Roofline:
    """The H100 roofline of one pass at ``(n, w, L, K)``; K = 1 is
    ``count_stats``, K > 1 ``stacked_count_stats``:

    * bytes: each input read once and the output written once (the
      table, mask and valid words and the output; with K > 1 the K tables
      and the ids too);
    * operations: none that bound ``count_stats`` (its AND-popcounts are
      binary products on the tensor cores); ``stacked_count_stats`` issues
      one ``__popc`` per valid (lane, vertex) pair and word.

    ``valid_pairs`` counts the valid pairs of the data, parked lanes
    excluded (default: every vertex of every lane); ``sms`` and
    ``clock_hz`` default to the data sheet's, and ``chip_smoke.py`` passes
    the card's.  Both routes move the same bytes and issue the same
    popcounts, so the model does not tell them apart.
    """
    if k == 1:
        nbytes = 4 * (n * w + 2 * lanes * w + 4 * lanes)
        popcounts = 0
    else:
        nbytes = 4 * (k * n * w + lanes + 2 * lanes * w + 4 * lanes)
        pairs = lanes * n if valid_pairs is None else int(valid_pairs)
        popcounts = pairs * w
    bytes_s = nbytes / HBM_BYTES_PER_S
    popcount_s = popcount_issue_s(popcounts, sms, clock_hz)
    if popcount_s >= bytes_s:
        return Roofline(popcount_s, "operations", nbytes, popcounts, bytes_s,
                        popcount_s)
    return Roofline(bytes_s, "bytes", nbytes, popcounts, bytes_s, popcount_s)


def predict_cost(n: int, w: int, lanes: int, k: int = 1,
                 route: str = "narrow") -> Optional[float]:
    """Modelled seconds of one launch on an H100: :func:`roofline` plus
    the launch overhead; None where the route does not take ``w``."""
    if route not in routes(w):
        return None
    return roofline(n, w, lanes, k).seconds + LAUNCH_OVERHEAD_S


def choose(n: int, w: int, lanes: int = 1, k: int = 1,
           device_type: str = "cuda") -> KernelChoice:
    """The route for a ``(n, w, L, K)`` launch: the least
    :func:`predict_cost`, ``ROUTES`` order on a tie.  Cached per shape
    and device type; a :func:`measured_choice` for the same key takes
    precedence."""
    key = (n, w, lanes, k, device_type)
    hit = _CACHE.get(key)
    if hit is None:
        hit = KernelChoice(min(routes(w), key=lambda r: predict_cost(
            n, w, lanes, k, r)))
        _CACHE[key] = hit
    return hit


def measured_choice(n: int, w: int, lanes: int = 1, k: int = 1, *,
                    iters: int = 200, device="cuda",
                    seed: int = 0) -> KernelChoice:
    """Time every valid route on the card and cache the faster under the
    key :func:`choose` reads.  ``count_stats`` for K = 1,
    ``stacked_count_stats`` (ids interleaved) otherwise, on random words.
    A route's time is the device time of ``iters`` back-to-back launches
    after a warm-up, between two CUDA events: a spin kernel holds the
    stream while the host queues them, so the host's own time per launch
    (tens of microseconds, more than these kernels take) stays out.
    Raises on the CPU: there is nothing to time."""
    from repro_torch.core.api import resolve_device
    from repro_torch.kernels import bitset_ops

    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError(f"measured_choice times the CUDA kernels; "
                           f"{dev} has none")
    gen = torch.Generator(device="cpu").manual_seed(seed)

    def words(*shape):
        return torch.randint(-2 ** 31, 2 ** 31, shape, generator=gen,
                             dtype=torch.int64).to(torch.int32).to(dev)

    mask, valid = words(lanes, w), words(lanes, w)
    if k == 1:
        table = words(n, w)

        def run(route):
            return bitset_ops.count_stats(table, mask, valid, route=route)
    else:
        tables = words(k, n, w)
        inst = (torch.arange(lanes, dtype=torch.int32) % k).to(dev)

        def run(route):
            return bitset_ops.stacked_count_stats(tables, inst, mask, valid,
                                                  route=route)

    times = {}
    with torch.cuda.device(dev):
        for route in routes(w):
            run(route)
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(_SPIN_CYCLES_PER_LAUNCH * iters)
            start.record()
            for _ in range(iters):
                run(route)
            end.record()
            torch.cuda.synchronize()
            times[route] = start.elapsed_time(end) / iters
    best = KernelChoice(min(times, key=times.get), dict(times))
    _CACHE[(n, w, lanes, k, dev.type)] = best
    return best


def clear_cache() -> None:
    """Drop every cached decision (tests, re-tuning)."""
    _CACHE.clear()

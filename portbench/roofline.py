"""The H100's published peaks and the least time of the program's bitset
kernels, frozen here so that the yardstick does not move with the
program.

Peaks: NVIDIA H100 SXM data sheet (dense rates, 700 W): HBM3 at
3.35 TB/s.  A card set below 700 W runs slower under load; the run
prints the card's power limit beside every reading.

Bytes of one launch, each input read once and the output written once:

* ``count_stats`` (n, w, L): the table ``n * w`` words, the mask and
  valid words ``2 * L * w``, the output ``4 * L`` words;
* ``stacked_count_stats`` (K, n, w, L): the K tables ``K * n * w``, the
  lane ids ``L``, the masks ``2 * L * w``, the output ``4 * L``.

``count_stats`` does its AND-popcounts as binary products on the tensor
cores, so no operation bounds it.  ``stacked_count_stats`` issues one
popcount per valid (lane, vertex) pair and word, a number that depends on
each launch's masks, which the trace does not hold: it is left out, so
that kernel's share is a floor of its true share.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12


def count_stats_bytes(n: int, w: int, lanes: int) -> int:
    return 4 * (n * w + 2 * lanes * w + 4 * lanes)


def stacked_count_stats_bytes(k: int, n: int, w: int, lanes: int) -> int:
    return 4 * (k * n * w + lanes + 2 * lanes * w + 4 * lanes)


def bound_s(nbytes: int) -> float:
    """The least seconds of a launch that moves ``nbytes``."""
    return nbytes / HBM_BYTES_PER_S


def share_pct(launches: int, launch_bound_s: float, device_s: float):
    """Per cent of the roofline: the launches' summed least time over
    their measured device time; None when nothing was measured."""
    if launches <= 0 or device_s <= 0:
        return None
    return 100.0 * launches * launch_bound_s / device_s

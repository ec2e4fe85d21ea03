"""Readers of the program's device-clock spans (``repro_torch.obs.spans``,
``clock`` "device") over a cell's window rounds.

On the card every round of one device records a device span around each
of its phases, ``expand``, ``balance`` (twice) and ``replay``: the card's
time between two CUDA events recorded at the phase's edges, inside the
round's CUDA graph when it replays one.  A reader takes the window's
rounds as ``portbench/spans.py`` does (the saturated window's last round
left out) and returns the mean device milliseconds a round of every span
of its name.

A reader returns None, never a wrong number, when the program files no
device spans (a tree without them, the recorder off, the CPU) or when a
window round has none of its name.
"""

from __future__ import annotations

from typing import Optional

from portbench.spans import window_spans


def device_ms(name: str):
    """The reader of ``<name>_dev_ms.*``: the mean over the window's rounds
    of the summed durations of the round's device spans ``name``, in
    milliseconds."""
    def read(r: dict) -> Optional[float]:
        got = window_spans(r)
        if got is None:
            return None
        run, _, rounds = got
        mine = [s for s in run if s.name == name and s.round in rounds
                and getattr(s, "clock", "host") == "device"]
        if {s.round for s in mine} != set(rounds):
            return None
        return sum(s.duration_ns for s in mine) / len(rounds) / 1e6
    return read

"""Readers of the program's own host-time spans (``repro_torch.obs.spans``)
over a cell's window rounds.

The recorder lives in the run's process, on by default; a reader takes
the newest run of the cell's mode and the window's rounds by number, as
the cell's driver counts them:

* ``saturated`` (mode "solve"): the window opens in round F + S's
  listener (F = ``notes["full_round"]``, S = the mix's ``settle_rounds``)
  and holds W = ``window["rounds"]`` rounds; the spans are read over
  rounds F + S + 1 ... F + S + W - 1.  The last window round is left out
  because its listener closes the window and, in a traced run, starts
  the profiler, host work inside its ``event`` span that no user pays;
* ``closed_loop`` (mode "service"): rounds w + 1 ... w + W, with w the
  mix's ``warm_rounds``.

A reader returns None, never a wrong number, when the program records no
spans (a tree without ``repro_torch.obs.spans``, or the recorder off) or
when the ring no longer holds every window round.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from portbench.stats import percentile

#: The recorder's mode of each driver whose window the spans cover.
MODES = {"saturated": "solve", "closed_loop": "service"}


def _recorder():
    try:
        from repro_torch.obs import spans
    except ImportError:
        return None
    return spans


def window_rounds(r: dict) -> Optional[range]:
    """The numbers of the rounds a span reader reads, or None."""
    driver, mix = r["mix"].get("driver"), r["mix"]
    w = int(r["window"].get("rounds") or 0)
    if driver == "saturated":
        first = int(r["notes"]["full_round"]) + int(mix["settle_rounds"]) + 1
        last = first + w - 2
    elif driver == "closed_loop":
        first = int(mix["warm_rounds"]) + 1
        last = first + w - 1
    else:
        return None
    return range(first, last + 1) if last >= first else None


def window_spans(r: dict) -> Optional[Tuple[list, List, range]]:
    """(every span of the run, its ``round`` spans in the window, the
    window's rounds), or None when there is nothing to read."""
    rec = _recorder()
    mode = MODES.get(r["mix"].get("driver"))
    rounds = window_rounds(r)
    if rec is None or mode is None or rounds is None:
        return None
    run = rec.run_spans(mode)
    tops = [s for s in run if s.name == "round" and s.round in rounds]
    if {s.round for s in tops} != set(rounds):
        return None
    return run, tops, rounds


def self_ms(name: str):
    """The reader of ``<name>_ms.*``: the mean over the window's rounds of
    the self time (a span's duration less its children's) of every span
    ``name`` in the round, in milliseconds."""
    def read(r: dict) -> Optional[float]:
        got = window_spans(r)
        if got is None:
            return None
        run, _, rounds = got
        inside = [s for s in run if s.round in rounds and s.parent is not None]
        own = _recorder().self_ns(inside)
        total = sum(own[s.id] for s in inside if s.name == name)
        return total / len(rounds) / 1e6
    return read


def request_wait_p50_s(r: dict) -> Optional[float]:
    """The median ``queued`` span, submission to admission, in seconds,
    over the requests admitted in the window's rounds (the span ends
    inside one of their ``round`` spans)."""
    got = window_spans(r)
    if got is None:
        return None
    run, tops, _ = got
    waits = [s.duration_ns * 1e-9 for s in run if s.name == "queued"
             and any(t.start_ns <= s.end_ns <= t.end_ns for t in tops)]
    return percentile(waits, 50) if waits else None

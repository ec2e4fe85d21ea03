"""JSONL solve-trace schema + writer (counterpart of ``repro.obs.trace``;
DESIGN.md §8).  The schema is the reference's, kind for kind and field for
field, so ``tools/trace_report.py`` reads the port's traces unchanged.

One trace is a sequence of JSON records, one per line, each carrying its
kind under ``"t"``.  :data:`TRACE_KINDS` is the single source of truth
for the schema — the writer validates every record at write time and
``tools/trace_report.py`` re-validates with the same tables when it
reads, so a malformed trace fails loudly at BOTH ends (the CI
trace-smoke step gates on the reader's exit status).

Record kinds (``[]`` marks fields the emitters always include but the
schema treats as optional, for forward compatibility):

  meta       schema, mode ("solve"|"service"), lanes, slots
             [steps_per_round, fused_steps, backend, config]
  round      round, open, active, nodes, steal_req, steal_recv,
             donated, inst_nodes
             [steal_recv_cross, steps, dispatches, ship_depths, best,
             queue_depth]  — every count is a DELTA over the jitted
             round (host-side installs are excluded from steal counts)
  incumbent  round, inst, best        [rid]
  admit      round, rid               [slot, waited]
  retire     round, rid               [best, waited, ran]
  expire     round, rid               [best, waited, ran]
  cancel     round, rid               [best, waited, ran]
  reject     round, rid               [reason]
  resize     round, lanes, devices    — the service re-laid its pool onto
             a different mesh / lane count (per-lane totals collapse onto
             lane 0, mirroring the engine's carried counters, so summary
             ledgers stay reconcilable across elastic events)
  summary    rounds, nodes, lane_nodes, inst_nodes
             [round, best, lane_recv, lane_req, lane_donated,
             lane_cross, steps, dispatches]  — per-lane/-instance totals
             accumulated from the round deltas (a drain-again service
             appends a fresh summary; readers use the LAST one)

Unknown kinds and missing required fields raise :class:`TraceError`;
unknown EXTRA fields are allowed so the schema can grow without breaking
old readers.
"""

from __future__ import annotations

import json
from typing import Dict, FrozenSet, List

__all__ = [
    "TRACE_KINDS",
    "TRACE_SCHEMA_VERSION",
    "TraceError",
    "TraceWriter",
    "read_trace",
    "validate_record",
]

TRACE_SCHEMA_VERSION = 1

_LIFECYCLE = frozenset({"round", "rid"})

#: kind -> required fields (beyond the ``"t"`` discriminator itself).
TRACE_KINDS: Dict[str, FrozenSet[str]] = {
    "meta": frozenset({"schema", "mode", "lanes", "slots"}),
    "round": frozenset({"round", "open", "active", "nodes", "steal_req",
                        "steal_recv", "donated", "inst_nodes"}),
    "incumbent": frozenset({"round", "inst", "best"}),
    "admit": _LIFECYCLE,
    "retire": _LIFECYCLE,
    "expire": _LIFECYCLE,
    "cancel": _LIFECYCLE,
    "reject": _LIFECYCLE,
    "resize": frozenset({"round", "lanes", "devices"}),
    "summary": frozenset({"rounds", "nodes", "lane_nodes", "inst_nodes"}),
}


class TraceError(ValueError):
    """A record violating :data:`TRACE_KINDS`, or an unreadable trace."""


def validate_record(record: dict) -> None:
    """Raise :class:`TraceError` unless ``record`` satisfies the schema."""
    kind = record.get("t")
    if kind is None:
        raise TraceError(f"record has no 't' kind field: {record!r}")
    required = TRACE_KINDS.get(kind)
    if required is None:
        raise TraceError(
            f"unknown trace record kind {kind!r} (known: "
            f"{', '.join(sorted(TRACE_KINDS))})")
    missing = [f for f in sorted(required) if f not in record]
    if missing:
        raise TraceError(
            f"{kind!r} record missing required fields {missing}: {record!r}")


class TraceWriter:
    """Append-only JSONL writer, schema-validated per record.

    Every write flushes, so a crash mid-run leaves a readable prefix and
    long-lived services never need an explicit close to be inspectable.
    ``None``-valued fields are dropped from the record.
    """

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "w")

    def write(self, kind: str, **fields) -> None:
        record = {"t": kind}
        record.update((k, v) for k, v in fields.items() if v is not None)
        validate_record(record)
        self._f.write(json.dumps(record, separators=(",", ":")) + "\n")
        self._f.flush()

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()


def read_trace(path: str) -> List[dict]:
    """Parse and validate a whole trace; raises :class:`TraceError` with
    the 1-based line number on the first bad line."""
    records = []
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            if not line.strip():
                continue
            try:
                record = json.loads(line)
            except ValueError as e:
                raise TraceError(f"{path}:{lineno}: not JSON: {e}") from e
            if not isinstance(record, dict):
                raise TraceError(
                    f"{path}:{lineno}: record is not an object")
            try:
                validate_record(record)
            except TraceError as e:
                raise TraceError(f"{path}:{lineno}: {e}") from None
            records.append(record)
    return records

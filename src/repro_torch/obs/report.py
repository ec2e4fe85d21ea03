"""Summarise a JSONL solve or service trace of the port (counterpart of
``tools/trace_report.py``; DESIGN.md §8).

Reads a trace written with ``SolverConfig(trace_path=...)`` (either
driver), re-validates every record against the port's schema
(:data:`repro_torch.obs.trace.TRACE_KINDS`), cross-checks the accounting
(per-instance node counts must sum to the engine total, which must equal
the per-lane sum) and prints the load-balance story:

  * lane utilisation: mean active fraction per round and the idle share;
  * balance: Gini coefficient of the per-lane node totals (0 = even,
    1 = one lane did everything);
  * steal efficiency: received / requested, intra- vs cross-device, and
    the root depths of shipped subtrees (shallow = heavy tasks);
  * tree shape: nodes, steps, dispatches, per-instance node totals;
  * service runs also get the request ledger (admit / retire / expire /
    cancel / reject counts, wait and run rounds, peak queue depth).

Usage:

  python -m repro_torch.obs.report TRACE.jsonl [--json]

Exit status: 0 on a clean report, 2 on a schema violation or an internal
inconsistency (``TraceError``).  :func:`analyze` is the programmatic form.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from repro_torch.core.api import INF_VALUE
from repro_torch.obs.trace import TRACE_SCHEMA_VERSION, TraceError, read_trace


def gini(values: List[int]) -> float:
    """Gini coefficient of a non-negative sample (0 = even, ->1 = skewed)."""
    vals = sorted(float(v) for v in values)
    n = len(vals)
    total = sum(vals)
    if n == 0 or total == 0:
        return 0.0
    # Rank formula: G = (2 sum i x_i) / (n sum x) - (n + 1) / n, i 1-based.
    weighted = sum(i * v for i, v in enumerate(vals, 1))
    return 2.0 * weighted / (n * total) - (n + 1.0) / n


def _stats(sample: List[float]) -> dict:
    if not sample:
        return {"count": 0, "mean": 0.0, "min": 0, "max": 0}
    return {"count": len(sample), "mean": sum(sample) / len(sample),
            "min": min(sample), "max": max(sample)}


def analyze(records: List[dict]) -> dict:
    """Trace records -> report dict; raises TraceError on inconsistency."""
    if not records:
        raise TraceError("empty trace: no records")
    meta = records[0]
    if meta["t"] != "meta":
        raise TraceError(f"first record must be 'meta', got {meta['t']!r}")
    if meta["schema"] != TRACE_SCHEMA_VERSION:
        raise TraceError(f"trace schema {meta['schema']} != reader schema "
                         f"{TRACE_SCHEMA_VERSION}")
    summaries = [r for r in records if r["t"] == "summary"]
    if not summaries:
        raise TraceError("trace has no 'summary' record (run incomplete?)")
    summary = summaries[-1]          # a re-drained service appends; use last
    rounds = [r for r in records if r["t"] == "round"]
    lanes = int(meta["lanes"])

    lane_nodes = summary["lane_nodes"]
    inst_nodes = summary["inst_nodes"]
    nodes = int(summary["nodes"])
    if sum(lane_nodes) != nodes:
        raise TraceError(f"per-lane node totals sum to {sum(lane_nodes)} "
                         f"but summary says {nodes}")
    if sum(inst_nodes) != nodes:
        raise TraceError(f"per-instance node totals sum to {sum(inst_nodes)} "
                         f"but summary says {nodes}")

    util = [r["active"] / lanes for r in rounds] if lanes else []
    ship = [d for r in rounds for d in r.get("ship_depths", [])]
    recv = sum(r["steal_recv"] for r in rounds)
    req = sum(r["steal_req"] for r in rounds)
    cross = sum(r.get("steal_recv_cross", 0) for r in rounds)
    lifecycle = {kind: sum(1 for r in records if r["t"] == kind)
                 for kind in ("admit", "retire", "expire", "cancel",
                              "reject")}
    waits = [r["waited"] for r in records
             if r["t"] == "admit" and r.get("waited") is not None]
    runs = [r["ran"] for r in records
            if r["t"] in ("retire", "expire", "cancel")
            and r.get("ran") is not None]
    return {
        "mode": meta["mode"],
        "schema": meta["schema"],
        "lanes": lanes,
        "slots": int(meta["slots"]),
        "rounds": int(summary["rounds"]),
        "nodes": nodes,
        "steps": summary.get("steps"),
        "dispatches": summary.get("dispatches"),
        "best": [b for b in (summary.get("best") or [])
                 if b < INF_VALUE] or summary.get("best"),
        "lane_nodes": lane_nodes,
        "inst_nodes": inst_nodes,
        "gini_lane_nodes": gini(lane_nodes),
        "mean_utilization": (sum(util) / len(util)) if util else 0.0,
        "idle_pct": 100.0 * (1.0 - (sum(util) / len(util))) if util else 0.0,
        "steal_requests": req,
        "steal_received": recv,
        "steal_received_cross": cross,
        "steal_success_rate": (recv / req) if req else 0.0,
        "ship_depth": _stats([float(d) for d in ship]),
        "incumbent_updates": sum(1 for r in records if r["t"] == "incumbent"),
        "max_queue_depth": max(
            (r.get("queue_depth", 0) for r in rounds), default=0),
        "lifecycle": lifecycle,
        "wait_rounds": _stats([float(w) for w in waits]),
        "run_rounds": _stats([float(x) for x in runs]),
    }


def render(report: dict) -> str:
    out = [f"trace report — mode={report['mode']} lanes={report['lanes']} "
           f"slots={report['slots']} (schema v{report['schema']})",
           f"  rounds={report['rounds']} nodes={report['nodes']} "
           f"steps={report['steps']} dispatches={report['dispatches']}",
           f"  load balance: gini={report['gini_lane_nodes']:.3f} "
           f"mean util={report['mean_utilization']:.3f} "
           f"idle={report['idle_pct']:.1f}%"]
    intra = report["steal_received"] - report["steal_received_cross"]
    out.append(f"  stealing: requests={report['steal_requests']} "
               f"received={report['steal_received']} "
               f"(intra={intra} cross={report['steal_received_cross']}) "
               f"success={report['steal_success_rate']:.1%}")
    ship = report["ship_depth"]
    if ship["count"]:
        out.append(f"  shipped subtrees: {ship['count']} "
                   f"root depth mean={ship['mean']:.1f} "
                   f"min={ship['min']:.0f} max={ship['max']:.0f}")
    out.append(f"  incumbents: {report['incumbent_updates']} updates; "
               f"best={report['best']}")
    out.append("  per-instance nodes: "
               + " ".join(str(n) for n in report["inst_nodes"]))
    if report["mode"] == "service":
        lc = report["lifecycle"]
        out.append("  requests: " + " ".join(
            f"{k}={lc[k]}" for k in
            ("admit", "retire", "expire", "cancel", "reject")))
        wait, run = report["wait_rounds"], report["run_rounds"]
        out.append(f"  latency (rounds): wait mean={wait['mean']:.1f} "
                   f"max={wait['max']:.0f}; run mean={run['mean']:.1f} "
                   f"max={run['max']:.0f}; "
                   f"peak queue={report['max_queue_depth']}")
    return "\n".join(out)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.obs.report",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("trace", help="JSONL trace path "
                                  "(SolverConfig.trace_path / --trace)")
    ap.add_argument("--json", action="store_true",
                    help="emit the report as JSON instead of text")
    args = ap.parse_args(argv)
    try:
        report = analyze(read_trace(args.trace))
    except (OSError, TraceError) as e:
        print(f"trace_report: {e}", file=sys.stderr)
        return 2
    print(json.dumps(report, indent=2) if args.json else render(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())

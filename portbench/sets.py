"""Run a cell several times, one process a run as the check does, and
report each metric's median and spread (the distance between the
quartiles of ``statistics.quantiles(values, n=4)`` over the median).

    python3 portbench/sets.py --workload <cell> --seeds 11,12,13 \\
        --seconds <s> [--trace 1] [--sets 2] [--out runs.jsonl]

``--sets 2`` runs the seeds twice, set after set; each set's spread is
reported and the wider one is what a bound is set from.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from portbench.stats import spread  # noqa: E402


def run_once(workload, seed, seconds, trace):
    t = time.perf_counter()
    out = subprocess.run(
        [sys.executable, str(ROOT / "portbench" / "run.py"), "--workload",
         workload, "--seed", str(seed), "--seconds", str(seconds),
         "--trace", str(trace)], cwd=str(ROOT), capture_output=True,
        text=True, check=False)
    lines = out.stdout.strip().splitlines()
    line = json.loads(lines[-1]) if out.returncode == 0 and lines else None
    return dict(seed=seed, rc=out.returncode, wall_s=time.perf_counter() - t,
                result=line, stderr=out.stderr[-3000:])


def summary(runs):
    values = {}
    for r in runs:
        if r["result"] is None:
            continue
        for name, m in r["result"]["metrics"].items():
            values.setdefault(name, []).append(m["value"])
    out = {}
    for name, vs in values.items():
        out[name] = dict(median=statistics.median(vs), n=len(vs),
                         spread=spread(vs) if len(vs) >= 2 else None,
                         values=vs)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--sets", type=int, default=1)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    ok = True
    for k in range(args.sets):
        runs = [run_once(args.workload, s, args.seconds, args.trace)
                for s in seeds]
        for r in runs:
            res = r["result"]
            ok &= res is not None and res["correct"]
            print(json.dumps(dict(set=k, seed=r["seed"], rc=r["rc"],
                                  wall_s=round(r["wall_s"], 2),
                                  correct=res and res["correct"],
                                  metrics={n: m["value"] for n, m in
                                           (res or {}).get("metrics",
                                                           {}).items()},
                                  checks=(res or {}).get("checks"))))
            if res is None or not res["correct"]:
                print(r["stderr"], file=sys.stderr)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(dict(r, set=k)) + "\n")
        print(json.dumps(dict(set=k, summary=summary(runs))))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

"""The control of ``correct``, on the card at the cell's own size.

    python3 portbench/control.py --workload <cell> --seeds 11,12,13 \\
        --seconds <s>

For each seed, one run of the cell that also puts the control in the
program's place: the plain reference with its proof dropped (it prunes a
subtree whose bound lies within one of the incumbent), judged by the same
comparison.  Prints per seed the program's numbers (the lower readings)
and the control's (the upper readings).  The benchmark's own runs never
run the control.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

T0 = time.perf_counter()
ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    from portbench import harness
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        r = harness.run_cell(ROOT, args.workload, seed, args.seconds, False,
                             t0=t0, control=True)
        print(json.dumps(dict(
            seed=seed, correct=r["correct"],
            program={n: c["value"] for n, c in r["checks"].items()},
            control={n: c["value"] for n, c in r["control_checks"].items()},
            metrics={n: m["value"] for n, m in r["metrics"].items()},
            notes=r["notes"])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

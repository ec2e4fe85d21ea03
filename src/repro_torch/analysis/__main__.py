"""torch-lint CLI: the port's static analysis.

  python -m repro_torch.analysis                  # src/repro_torch and
                                                  # chip_smoke.py
  python -m repro_torch.analysis PATH ...         # files or directories
  python -m repro_torch.analysis --json out.json  # findings as JSON ('-':
                                                  # stdout)
  python -m repro_torch.analysis --list-rules     # the rule catalogue
  python -m repro_torch.analysis --rule trace-safety   # one rule only

Exit status: 0 with no error-severity finding, 1 otherwise, 2 on an
unknown rule.  Paths resolve against the checkout this package lives
in, which is also where the rules read their ground truth (the CUDA
sources, the tests, the snapshot).  Stdlib only: it runs where no torch
is installed.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
from typing import List, Optional

from repro_torch.analysis import all_rules, lint_paths
from repro_torch.analysis.core import DEFAULT_PATHS


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("paths", nargs="*",
                    help="files or directories to lint (default: "
                         f"{' '.join(DEFAULT_PATHS)})")
    ap.add_argument("--json", metavar="FILE", default=None,
                    help="also write the findings as JSON ('-' for stdout)")
    ap.add_argument("--rule", action="append", default=None,
                    help="run only this rule (repeatable)")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalogue and exit")
    args = ap.parse_args(argv)

    rules = all_rules()
    if args.list_rules:
        for name in sorted(rules):
            cls = rules[name]
            print(f"{name:18s} [{cls.severity}] {cls.description}")
        return 0
    for r in (args.rule or []):
        if r not in rules:
            print(f"lint: unknown rule {r!r} (known: {sorted(rules)})",
                  file=sys.stderr)
            return 2

    result = lint_paths(args.paths or None, rules=args.rule)
    for f in result.findings:
        print(f.format())
    errors = result.errors
    warnings = len(result.findings) - len(errors)
    print(f"lint: {result.files} files, {len(errors)} error(s), "
          f"{warnings} warning(s), {len(result.scanned)} functions in the "
          f"round loop's scope")
    if args.json:
        text = json.dumps({
            "files": result.files, "errors": len(errors),
            "warnings": warnings, "scanned": result.scanned,
            "findings": [{"rule": f.rule, "path": f.path, "line": f.line,
                          "severity": f.severity, "message": f.message}
                         for f in result.findings]}, indent=2)
        if args.json == "-":
            print(text)
        else:
            pathlib.Path(args.json).write_text(text + "\n", encoding="utf-8")
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())

"""Run the ``bash`` command blocks of the README's port section, so the
port's documented invocations cannot rot (counterpart of
``tools/docs_smoke.py``).

The extraction rules are the reference's, kept as dumb so the README
stays plain markdown:

  * only fenced blocks whose info string is exactly ``bash`` run;
  * backslash continuations are joined into one command;
  * ``#`` end-of-line comments are allowed (bash strips them);
  * commands matching ``--skip`` (default: ``pytest``: the test suite is
    its own job) are reported and not run.

Only the README's section ``## PyTorch/CUDA port`` (up to the next
``## `` heading) is read.  The port's API surface check
(``python -m repro_torch.analysis.api_surface``) is appended to the
commands, as the reference appends its own (``--no-api-surface`` opts
out).

Usage:

  python -m repro_torch.analysis.docs_smoke [--readme README.md] [--list]
      [--skip REGEX]

Each command runs through ``bash -c`` from the README's directory with
the inherited environment; the first failure stops the run with its exit
code.  Like the rest of ``repro_torch.analysis`` it needs only the
standard library.
"""

from __future__ import annotations

import argparse
import pathlib
import re
import subprocess
import sys
import time
from typing import List, Optional

FENCE_RE = re.compile(r"^```(\w*)\s*$")

#: The README's heading of the port's section.
SECTION = "## PyTorch/CUDA port"

#: The API surface check appended to the commands.
API_SURFACE = "PYTHONPATH=src {python} -m repro_torch.analysis.api_surface"


def extract_bash_commands(text: str) -> List[str]:
    """-> list of commands from ``bash`` fenced blocks, continuations
    joined."""
    commands, in_bash, pending = [], False, ""
    for line in text.splitlines():
        m = FENCE_RE.match(line)
        if m:
            if in_bash and pending:
                commands.append(pending.strip())
                pending = ""
            in_bash = not in_bash and m.group(1) == "bash"
            continue
        if not in_bash:
            continue
        if line.rstrip().endswith("\\"):
            pending += line.rstrip()[:-1] + " "
            continue
        pending += line
        if pending.strip() and not pending.lstrip().startswith("#"):
            commands.append(pending.strip())
        pending = ""
    return commands


def port_section(text: str) -> str:
    """The README's port section: from its heading to the next ``## ``
    heading (empty when the README has none)."""
    lines = text.splitlines()
    start = next((i for i, line in enumerate(lines)
                  if line.startswith(SECTION)), None)
    if start is None:
        return ""
    end = next((i for i in range(start + 1, len(lines))
                if lines[i].startswith("## ")), len(lines))
    return "\n".join(lines[start:end])


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--readme", default="README.md")
    ap.add_argument("--skip", default="pytest",
                    help="regex of commands to report but not run")
    ap.add_argument("--list", action="store_true",
                    help="print the extracted commands and exit")
    ap.add_argument("--no-api-surface", action="store_true",
                    help="do not append the port's API surface check")
    args = ap.parse_args(argv)

    readme = pathlib.Path(args.readme).resolve()
    commands = extract_bash_commands(
        port_section(readme.read_text(encoding="utf-8")))
    if not commands:
        print(f"docs-smoke: no bash commands in {args.readme}'s "
              f"{SECTION!r} section", file=sys.stderr)
        return 1
    if not args.no_api_surface:
        commands.append(API_SURFACE.format(python=sys.executable))

    skip = re.compile(args.skip) if args.skip else None
    if args.list:
        for cmd in commands:
            mark = "SKIP " if skip and skip.search(cmd) else "RUN  "
            print(mark + cmd)
        return 0

    for i, cmd in enumerate(commands, 1):
        if skip and skip.search(cmd):
            print(f"[{i}/{len(commands)}] SKIP {cmd}", flush=True)
            continue
        print(f"[{i}/{len(commands)}] RUN  {cmd}", flush=True)
        t0 = time.time()
        proc = subprocess.run(["bash", "-c", cmd], cwd=readme.parent,
                              check=False)
        print(f"[{i}/{len(commands)}] exit={proc.returncode} "
              f"({time.time() - t0:.1f}s)", flush=True)
        if proc.returncode != 0:
            print("docs-smoke: FAILED", file=sys.stderr)
            return proc.returncode
    print("docs-smoke: all documented commands ran clean")
    return 0


if __name__ == "__main__":
    sys.exit(main())

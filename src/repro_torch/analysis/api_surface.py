"""Public-API surface snapshot of the port's front-door modules
(counterpart of ``tools/api_surface.py``).

``repro_torch.registry``, ``.solver``, ``.service``, ``.obs``,
``.analysis``, ``.serve``, ``.train`` and ``.roofline`` are the port's
public API.  This tool renders each module's ``__all__`` (dataclass
fields, NamedTuple fields, class methods, function signatures) into a
canonical text and compares it with the checked-in snapshot
``api_surface.txt`` beside this file:

  python -m repro_torch.analysis.api_surface            # check: exit 1
                                                        # and a diff on drift
  python -m repro_torch.analysis.api_surface --update   # rewrite it
  python -m repro_torch.analysis.api_surface --snapshot PATH [--update]

Unlike the rest of ``repro_torch.analysis`` it imports the modules it
renders, and so torch.
"""

from __future__ import annotations

import argparse
import dataclasses
import difflib
import importlib
import inspect
import pathlib
import re
import sys
from typing import List, Optional

MODULES = ("repro_torch.registry", "repro_torch.solver",
           "repro_torch.service", "repro_torch.obs", "repro_torch.analysis",
           "repro_torch.serve", "repro_torch.train", "repro_torch.roofline")
SNAPSHOT = pathlib.Path(__file__).resolve().with_name("api_surface.txt")


def _signature(obj) -> str:
    try:
        sig = str(inspect.signature(obj))
    except (TypeError, ValueError):
        return "(...)"
    # Callable defaults repr with a memory address: canonicalise.
    return re.sub(r"<(function|bound method) ([^ ]+) at 0x[0-9a-f]+>",
                  r"<\1 \2>", sig)


def _const_repr(obj) -> str:
    # Set and dict order varies per process (hash randomisation): sort.
    if isinstance(obj, (set, frozenset)):
        body = ", ".join(repr(x) for x in sorted(obj, key=repr))
        return f"{type(obj).__name__}({{{body}}})"
    if isinstance(obj, dict):
        body = ", ".join(f"{k!r}: {_const_repr(v)}" for k, v in
                         sorted(obj.items(), key=lambda kv: repr(kv[0])))
        return f"{{{body}}}"
    return repr(obj)


def _describe_class(name: str, obj: type) -> List[str]:
    if dataclasses.is_dataclass(obj):
        fields = ", ".join(f"{f.name}: {getattr(f.type, '__name__', f.type)}"
                           for f in dataclasses.fields(obj))
        lines = [f"  dataclass {name}({fields})"]
    elif issubclass(obj, tuple) and hasattr(obj, "_fields"):
        lines = [f"  namedtuple {name}({', '.join(obj._fields)})"]
    else:
        bases = ", ".join(b.__name__ for b in obj.__bases__)
        lines = [f"  class {name}({bases})"]
    for mname, member in sorted(vars(obj).items()):
        if mname.startswith("_") and mname != "__init__":
            continue
        if isinstance(member, property):
            lines.append(f"    property {mname}")
        elif isinstance(member, (classmethod, staticmethod)):
            lines.append(f"    {type(member).__name__} {mname}"
                         f"{_signature(member.__func__)}")
        elif callable(member):
            lines.append(f"    def {mname}{_signature(member)}")
    return lines


def render() -> str:
    out = []
    for modname in MODULES:
        mod = importlib.import_module(modname)
        out.append(f"module {modname}")
        for name in sorted(mod.__all__):
            obj = getattr(mod, name)
            if isinstance(obj, type):
                out.extend(_describe_class(name, obj))
            elif callable(obj):
                out.append(f"  def {name}{_signature(obj)}")
            else:
                out.append(f"  const {name} = {_const_repr(obj)}")
        out.append("")
    return "\n".join(out)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.api_surface",
        description=__doc__.splitlines()[0])
    ap.add_argument("--update", action="store_true",
                    help="rewrite the snapshot instead of checking it")
    ap.add_argument("--snapshot", type=pathlib.Path, default=SNAPSHOT,
                    help="the snapshot file (default: api_surface.txt "
                         "beside this module)")
    args = ap.parse_args(argv)

    current = render()
    if args.update:
        args.snapshot.write_text(current, encoding="utf-8")
        print(f"api-surface: snapshot updated -> {args.snapshot}")
        return 0
    if not args.snapshot.exists():
        print(f"api-surface: {args.snapshot} missing; run with --update",
              file=sys.stderr)
        return 1
    want = args.snapshot.read_text(encoding="utf-8")
    if current == want:
        print(f"api-surface: {', '.join(MODULES)} match the snapshot")
        return 0
    sys.stderr.write("api-surface: PUBLIC API CHANGED: review the diff, then "
                     "rerun with --update to accept:\n")
    sys.stderr.writelines(difflib.unified_diff(
        want.splitlines(keepends=True), current.splitlines(keepends=True),
        fromfile=str(args.snapshot), tofile="current"))
    return 1


if __name__ == "__main__":
    sys.exit(main())

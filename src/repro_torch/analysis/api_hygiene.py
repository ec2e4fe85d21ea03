"""api-hygiene: the port's exports snapshotted, deprecations well formed
(counterpart of ``repro.analysis.api_hygiene``).

1. **Exports are snapshotted.**  For every front-door module of
   ``repro_torch.analysis.api_surface.MODULES``, each name of the
   module's ``__all__`` must appear under that module's section of the
   snapshot ``src/repro_torch/analysis/api_surface.txt``.  The static
   half of the snapshot guard: ``python -m
   repro_torch.analysis.api_surface`` catches drift but imports torch;
   this clause catches a forgotten snapshot update with no import at
   all.  ``MODULES`` and ``__all__`` are read from the AST.
2. **Deprecation shims use the exactly-once pattern.**  Every
   ``warnings.warn(..., DeprecationWarning, ...)`` passes
   ``stacklevel=2`` (the warning points at the caller) and, when its
   message is a literal, says "deprecated".
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Set

from repro_torch.analysis.core import (Finding, Module, RepoContext, Rule,
                                       register)

SURFACE_TOOL = "src/repro_torch/analysis/api_surface.py"
SNAPSHOT = "src/repro_torch/analysis/api_surface.txt"

_SNAPSHOT_ENTRY = re.compile(
    r"^  (?:def|const|dataclass|namedtuple|class)\s+([A-Za-z_][A-Za-z_0-9]*)")


def parse_snapshot(text: str) -> Dict[str, Set[str]]:
    """api_surface.txt -> {module: {exported names}}."""
    sections: Dict[str, Set[str]] = {}
    current: Optional[str] = None
    for line in text.splitlines():
        if line.startswith("module "):
            current = line[len("module "):].strip()
            sections[current] = set()
        elif current is not None:
            m = _SNAPSHOT_ENTRY.match(line)
            if m:
                sections[current].add(m.group(1))
    return sections


def module_all(mod: Module) -> Optional[Dict[str, int]]:
    """``__all__`` names -> line number, or None when absent."""
    for node in mod.tree.body:
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets = [node.target]
        else:
            continue
        if any(isinstance(t, ast.Name) and t.id == "__all__"
               for t in targets):
            if not isinstance(node.value, (ast.List, ast.Tuple)):
                return None
            return {e.value: e.lineno for e in node.value.elts
                    if isinstance(e, ast.Constant)
                    and isinstance(e.value, str)}
    return None


@register
class ApiHygieneRule(Rule):
    name = "api-hygiene"
    description = ("public exports snapshotted in analysis/api_surface.txt; "
                   "deprecation shims use the exactly-once pattern")
    severity = "error"

    def run(self, ctx: RepoContext) -> List[Finding]:
        findings: List[Finding] = []

        def add(mod, node, msg):
            f = self.finding(mod, node, msg)
            if f is not None:
                findings.append(f)

        self._check_snapshot(ctx, add)
        for mod in ctx.modules:
            self._check_deprecations(mod, add)
        return findings

    def _check_snapshot(self, ctx: RepoContext, add) -> None:
        modules = ctx.literal(SURFACE_TOOL, "MODULES")
        text = ctx.read(SNAPSHOT)
        if not isinstance(modules, tuple) or text is None:
            return
        sections = parse_snapshot(text)
        update = "run `python -m repro_torch.analysis.api_surface --update`"
        for dotted in modules:
            # Only modules in the analysed set: a run over a few files
            # does not re-audit the whole package.
            mod = ctx.by_dotted.get(dotted)
            if mod is None:
                continue
            exported = module_all(mod)
            if exported is None:
                add(mod, 1, f"front-door module {dotted} has no literal "
                            "__all__: the api-surface snapshot needs one")
                continue
            known = sections.get(dotted)
            if known is None:
                add(mod, 1, f"module {dotted} is in api_surface.MODULES but "
                            f"has no section in {SNAPSHOT}: {update}")
                continue
            for name, lineno in sorted(exported.items()):
                if name not in known:
                    add(mod, lineno, f"export {dotted}.{name} is missing "
                                     f"from {SNAPSHOT}: {update} and review "
                                     "the diff")

    def _check_deprecations(self, mod: Module, add) -> None:
        for call in ast.walk(mod.tree):
            if not isinstance(call, ast.Call):
                continue
            func = call.func
            is_warn = (isinstance(func, ast.Attribute) and func.attr == "warn"
                       and isinstance(func.value, ast.Name)
                       and func.value.id == "warnings") or \
                (isinstance(func, ast.Name) and func.id == "warn")
            if not is_warn or not any(
                    isinstance(n, ast.Name) and n.id == "DeprecationWarning"
                    for a in list(call.args) + [k.value for k in
                                                call.keywords]
                    for n in ast.walk(a)):
                continue
            stacklevel = None
            if len(call.args) >= 3 and isinstance(call.args[2],
                                                  ast.Constant):
                stacklevel = call.args[2].value
            for kw in call.keywords:
                if kw.arg == "stacklevel" and isinstance(kw.value,
                                                         ast.Constant):
                    stacklevel = kw.value.value
            if stacklevel != 2:
                add(mod, call, "DeprecationWarning must be raised with "
                               "stacklevel=2 so the warning points at the "
                               "caller (the exactly-once shim pattern)")
            msg = call.args[0] if call.args else None
            if isinstance(msg, ast.Constant) and isinstance(msg.value, str) \
                    and "deprecat" not in msg.value.lower():
                add(mod, call, "deprecation shim message should say "
                               "'deprecated' so the warning filters can pin "
                               "it")

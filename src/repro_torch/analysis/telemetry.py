"""telemetry-schema: the port's emit()/trace-write call sites checked
statically (counterpart of ``repro.analysis.telemetry``).

``solver.emit`` and ``TraceWriter.write`` raise on unknown kinds and
missing fields, but only when the call runs: a typo in a rarely taken
branch ships silently.  Every call site with a *literal* kind is held to
the port's own tables, read through the AST (no import):

  * ``EVENT_KINDS`` of ``src/repro_torch/solver.py``;
  * ``TRACE_KINDS`` of ``src/repro_torch/obs/trace.py`` (kind -> required
    fields).

Checked shapes (a kind held in a variable is left to the runtime check):

  * ``emit(cb, "kind", ...)``, ``self._emit("kind", ...)`` (the service
    driver's form), ``obj.emit("kind", ...)`` and
    ``ProgressEvent(kind="kind", ...)`` -> kind in EVENT_KINDS;
  * ``<trace>.write("kind", field=..., ...)`` where the receiver mentions
    ``trace`` -> kind in TRACE_KINDS and its required fields among the
    keywords (unless ``**kw`` is forwarded);
  * ``.lifecycle("kind", ...)`` and the driver's
    ``._note_lifecycle("kind", ...)`` -> kind in TRACE_KINDS.
"""

from __future__ import annotations

import ast
from typing import List, Optional

from repro_torch.analysis.core import (Finding, Module, RepoContext, Rule,
                                       register)

_EVENT_TABLE = ("src/repro_torch/solver.py", "EVENT_KINDS")
_TRACE_TABLE = ("src/repro_torch/obs/trace.py", "TRACE_KINDS")


def _literal_str(node) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _mentions_trace(node) -> bool:
    for n in ast.walk(node):
        name = n.id if isinstance(n, ast.Name) else \
            n.attr if isinstance(n, ast.Attribute) else ""
        if "trace" in name.lower():
            return True
    return False


@register
class TelemetrySchemaRule(Rule):
    name = "telemetry-schema"
    description = ("emit()/trace write() call sites must use known "
                   "EVENT_KINDS/TRACE_KINDS with required fields")
    severity = "error"

    def run(self, ctx: RepoContext) -> List[Finding]:
        event_kinds = ctx.literal(*_EVENT_TABLE)
        trace_kinds = ctx.literal(*_TRACE_TABLE)
        if not isinstance(event_kinds, (set, frozenset)):
            event_kinds = None
        if not isinstance(trace_kinds, dict):
            trace_kinds = None
        findings: List[Finding] = []
        for mod in ctx.modules:
            if mod.rel in (_EVENT_TABLE[0], _TRACE_TABLE[0]):
                continue     # the tables' own modules define the schema
            for call in ast.walk(mod.tree):
                if isinstance(call, ast.Call):
                    msg = self._check(call, event_kinds, trace_kinds)
                    f = msg and self.finding(mod, call, msg)
                    if f:
                        findings.append(f)
        return findings

    @staticmethod
    def _event_kind(call: ast.Call) -> Optional[str]:
        func = call.func
        if isinstance(func, ast.Name) and func.id == "emit":
            return _literal_str(call.args[1]) if len(call.args) >= 2 \
                else None
        if isinstance(func, ast.Attribute) and func.attr in ("emit",
                                                             "_emit"):
            return _literal_str(call.args[0]) if call.args else None
        if isinstance(func, ast.Name) and func.id == "ProgressEvent":
            for kw in call.keywords:
                if kw.arg == "kind":
                    return _literal_str(kw.value)
            return _literal_str(call.args[0]) if call.args else None
        return None

    def _check(self, call: ast.Call, event_kinds,
               trace_kinds) -> Optional[str]:
        kind = self._event_kind(call)
        if kind is not None:
            if event_kinds is not None and kind not in event_kinds:
                return (f"unknown progress-event kind {kind!r}: not in "
                        f"solver.EVENT_KINDS "
                        f"({', '.join(sorted(event_kinds))})")
            return None
        func = call.func
        if not isinstance(func, ast.Attribute) or not call.args \
                or trace_kinds is None:
            return None
        kind = _literal_str(call.args[0])
        if kind is None:
            return None
        if func.attr == "write" and _mentions_trace(func.value):
            if kind not in trace_kinds:
                return (f"unknown trace record kind {kind!r}: not in "
                        f"obs.trace.TRACE_KINDS "
                        f"({', '.join(sorted(trace_kinds))})")
            if any(kw.arg is None for kw in call.keywords):
                return None
            missing = sorted(set(trace_kinds[kind])
                             - {kw.arg for kw in call.keywords})
            if missing:
                return (f"trace record {kind!r} is missing required "
                        f"field(s) {missing} (TRACE_KINDS[{kind!r}] = "
                        f"{{{', '.join(sorted(trace_kinds[kind]))}}})")
        elif func.attr in ("lifecycle", "_note_lifecycle") and \
                kind not in trace_kinds:
            return (f"unknown lifecycle kind {kind!r}: not in "
                    f"obs.trace.TRACE_KINDS")
        return None

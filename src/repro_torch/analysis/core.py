"""Lint framework core of the port: findings, rule registry,
suppressions, runner (counterpart of ``repro.analysis.core``).

  * A :class:`Rule` is a *project-level* pass: ``run(ctx)`` sees every
    analysed module at once, because the invariants (the round loop's
    reach, the kernel bindings against their C sources, the telemetry
    schemas) cross files.
  * Rules report :class:`Finding` objects (rule, file, line, message,
    severity).  ``error`` findings fail the run; ``warning`` findings are
    printed and do not change the exit status.
  * Inline suppressions: ``# torch-lint: disable=<rule> -- <reason>`` on
    the offending line (or the line directly above) silences that rule
    there.  The reason is mandatory: a suppression without one, or one
    naming an unknown rule, is itself a finding (rule ``suppression``).
    The marker differs from the reference's, so neither package's lint
    reads the other's comments.
  * There is no file allowlist: the port's idle modules (``models/``, the
    LM kernels) still carry kernel bindings that the rules check.

Everything here is stdlib-only: neither ``torch`` nor ``repro_torch``'s
other modules are imported, so the lint runs where no torch is installed.
"""

from __future__ import annotations

import ast
import dataclasses
import pathlib
import re
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Type

__all__ = [
    "DEFAULT_PATHS",
    "Finding",
    "LintResult",
    "Module",
    "RepoContext",
    "Rule",
    "all_rules",
    "lint_paths",
    "register",
]

#: What a run with no paths analyses, relative to the repo root.
DEFAULT_PATHS: Tuple[str, ...] = ("src/repro_torch", "chip_smoke.py")

_SUPPRESS_RE = re.compile(
    r"#\s*torch-lint:\s*disable=([A-Za-z0-9_,-]+)"
    r"(?:\s+--\s+(?P<reason>\S.*))?")

#: The checkout this package lives in (src/repro_torch/analysis/core.py).
PACKAGE_ROOT = pathlib.Path(__file__).resolve().parents[3]


@dataclasses.dataclass(frozen=True)
class Finding:
    """One lint diagnostic, anchored to a file:line."""

    rule: str
    path: str          # repo-relative, '/'-separated
    line: int
    message: str
    severity: str = "error"    # "error" | "warning"

    def format(self) -> str:
        return (f"{self.path}:{self.line}: [{self.rule}] "
                f"{self.severity}: {self.message}")


class Module:
    """A parsed source file: path, text, AST, and suppression table."""

    def __init__(self, path: pathlib.Path, rel: str, text: str,
                 tree: ast.Module):
        self.path = path
        self.rel = rel
        self.text = text
        self.tree = tree
        self.lines = text.splitlines()
        # line -> (set of rule names or {"*"}, reason or None)
        self.suppressions: Dict[int, Tuple[frozenset, Optional[str]]] = {}
        for lineno, line in enumerate(self.lines, 1):
            m = _SUPPRESS_RE.search(line)
            if m:
                rules = frozenset(r.strip() for r in m.group(1).split(",")
                                  if r.strip())
                self.suppressions[lineno] = (rules, m.group("reason"))

    def suppressed(self, rule: str, line: int) -> bool:
        """True when ``rule`` is disabled on ``line`` (same line or the
        line directly above the reported one)."""
        for cand in (line, line - 1):
            entry = self.suppressions.get(cand)
            if entry and (rule in entry[0] or "*" in entry[0]):
                return True
        return False

    def dotted(self, src_root: pathlib.Path) -> Optional[str]:
        """Module's dotted import name relative to ``src_root`` (the
        directory on ``sys.path``), or None if outside it."""
        try:
            rel = self.path.resolve().relative_to(src_root.resolve())
        except ValueError:
            return None
        parts = list(rel.with_suffix("").parts)
        if parts and parts[-1] == "__init__":
            parts = parts[:-1]
        return ".".join(parts) if parts else None


class RepoContext:
    """Everything a rule needs: the analysed modules plus repo anchors.

    ``repo_root`` is the checkout being linted; ground-truth files that
    are not among the analysed modules (the CUDA sources, ``tests/``,
    the snapshot) are read from it and from nowhere else.  ``scanned`` is
    filled by the trace-safety rule: the ``module:qualname`` of every
    function in the round loop's scope.
    """

    def __init__(self, modules: Sequence[Module],
                 repo_root: Optional[pathlib.Path] = None):
        self.modules = list(modules)
        self.repo_root = repo_root if repo_root is not None else PACKAGE_ROOT
        self.src_root = self.repo_root / "src"
        self.scanned: List[str] = []
        self._file_cache: Dict[str, Optional[str]] = {}
        self.by_dotted: Dict[str, Module] = {}
        self.by_rel: Dict[str, Module] = {}
        for mod in self.modules:
            self.by_rel[mod.rel] = mod
            name = mod.dotted(self.src_root)
            if name:
                self.by_dotted[name] = mod

    def read(self, rel: str) -> Optional[str]:
        """Text of a repo-relative file, or None if absent.  Prefers the
        analysed module set (so a miniature tree's files win)."""
        if rel not in self._file_cache:
            mod = self.by_rel.get(rel)
            text = mod.text if mod is not None else None
            path = self.repo_root / rel
            if text is None and path.is_file():
                text = path.read_text(encoding="utf-8")
            self._file_cache[rel] = text
        return self._file_cache[rel]

    def corpus(self, directory: str, pattern: str) -> str:
        """The texts of the checkout's ``directory/pattern`` files
        joined ("" where there are none)."""
        return "\n".join(f.read_text(encoding="utf-8") for f in
                         sorted((self.repo_root / directory).glob(pattern)))

    def literal(self, rel: str, name: str) -> Optional[object]:
        """Evaluate the module-level assignment ``name = <literal>`` in a
        repo file through the AST, with no import.  ``frozenset(...)``,
        ``dict(...)``, ``tuple(...)`` of literals unwrap, and names bound
        earlier at module level resolve (``TRACE_KINDS`` reusing
        ``_LIFECYCLE``).  None when absent or not a literal."""
        text = self.read(rel)
        if text is None:
            return None
        try:
            tree = ast.parse(text)
        except SyntaxError:
            return None
        env: Dict[str, object] = {}
        for node in tree.body:
            targets: List[ast.expr] = []
            value: Optional[ast.expr] = None
            if isinstance(node, ast.Assign):
                targets, value = node.targets, node.value
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                targets, value = [node.target], node.value
            for tgt in targets:
                if isinstance(tgt, ast.Name):
                    evaluated = literal_eval(value, env)
                    if evaluated is not None:
                        env[tgt.id] = evaluated
                    if tgt.id == name:
                        return evaluated
        return None


_CONSTRUCTORS = {"frozenset": frozenset, "set": set, "tuple": tuple,
                 "list": list, "dict": dict}


def literal_eval(node: ast.expr,
                 env: Optional[Dict[str, object]] = None) -> Optional[object]:
    """``ast.literal_eval`` that also unwraps ``frozenset(...)`` /
    ``set(...)`` / ``dict(...)`` / ``tuple(...)`` / ``list(...)`` calls
    and resolves names bound in ``env``; None where it cannot."""
    env = env or {}
    if isinstance(node, ast.Name):
        return env.get(node.id)
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
            and node.func.id in _CONSTRUCTORS and not node.keywords:
        ctor = _CONSTRUCTORS[node.func.id]
        if not node.args:
            return ctor()
        if len(node.args) == 1:
            inner = literal_eval(node.args[0], env)
            try:
                return None if inner is None else ctor(inner)
            except TypeError:
                return None
        return None
    if isinstance(node, ast.Dict):
        out = {}
        for k, v in zip(node.keys, node.values):
            key = None if k is None else literal_eval(k, env)
            val = literal_eval(v, env)
            if key is None or val is None:
                return None
            out[key] = val
        return out
    try:
        return ast.literal_eval(node)
    except (ValueError, SyntaxError, TypeError):
        return None


class Rule:
    """Base class for a project-level lint pass.

    Subclasses set ``name``/``description``/``severity`` and implement
    :meth:`run`, building findings with :meth:`finding` (which applies the
    inline-suppression table).
    """

    name = "abstract"
    description = ""
    severity = "error"

    def run(self, ctx: RepoContext) -> List[Finding]:  # pragma: no cover
        raise NotImplementedError

    def finding(self, mod: Module, node, message: str,
                severity: Optional[str] = None) -> Optional[Finding]:
        """A Finding for ``node`` (an AST node or an int line number),
        or None where an inline suppression covers it."""
        line = node if isinstance(node, int) else getattr(node, "lineno", 1)
        if mod.suppressed(self.name, line):
            return None
        return Finding(rule=self.name, path=mod.rel, line=line,
                       message=message,
                       severity=severity or self.severity)


_REGISTRY: Dict[str, Type[Rule]] = {}


def register(cls: Type[Rule]) -> Type[Rule]:
    """Class decorator adding a Rule to the registry."""
    if cls.name in _REGISTRY and _REGISTRY[cls.name] is not cls:
        raise ValueError(f"duplicate lint rule name {cls.name!r}")
    _REGISTRY[cls.name] = cls
    return cls


def all_rules() -> Dict[str, Type[Rule]]:
    """Registered rules by name (import ``repro_torch.analysis`` to
    populate)."""
    return dict(_REGISTRY)


@dataclasses.dataclass
class LintResult:
    findings: List[Finding]
    files: int
    scanned: List[str]     # functions in the round loop's scope

    @property
    def errors(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == "error"]


def _rel(path: pathlib.Path, root: pathlib.Path) -> str:
    try:
        rel = str(path.resolve().relative_to(root.resolve()))
    except ValueError:
        rel = str(path)
    return rel.replace("\\", "/")


def _collect_files(root: pathlib.Path,
                   paths: Sequence[str]) -> List[pathlib.Path]:
    files: List[pathlib.Path] = []
    for p in paths:
        path = pathlib.Path(p)
        path = path if path.is_absolute() else root / p
        candidates: Iterable[pathlib.Path] = (
            [path] if path.is_file() else sorted(path.rglob("*.py")))
        files.extend(candidates)
    return files


def _suppression_findings(mod: Module) -> List[Finding]:
    out = []
    for lineno, (rules, reason) in sorted(mod.suppressions.items()):
        if reason is None:
            out.append(Finding(
                rule="suppression", path=mod.rel, line=lineno,
                message="suppression is missing its reason: write "
                        "'# torch-lint: disable=<rule> -- why'"))
        unknown = rules - set(_REGISTRY) - {"*"}
        if unknown:
            out.append(Finding(
                rule="suppression", path=mod.rel, line=lineno,
                message=f"suppression names unknown rule(s) "
                        f"{sorted(unknown)}"))
    return out


def lint_paths(paths: Optional[Sequence[str]] = None,
               root: Optional[pathlib.Path] = None,
               rules: Optional[Sequence[str]] = None) -> LintResult:
    """Run the registered rules over ``paths`` (files or directories,
    resolved against ``root``; by default :data:`DEFAULT_PATHS` of this
    checkout).  The caller decides the exit status from
    ``result.errors``."""
    root = root if root is not None else PACKAGE_ROOT
    files = _collect_files(root, paths or DEFAULT_PATHS)

    modules: List[Module] = []
    findings: List[Finding] = []
    for f in files:
        rel = _rel(f, root)
        try:
            text = f.read_text(encoding="utf-8")
        except OSError as e:
            findings.append(Finding(rule="parse", path=rel, line=1,
                                    message=f"unreadable: {e}"))
            continue
        try:
            tree = ast.parse(text, filename=rel)
        except SyntaxError as e:
            findings.append(Finding(rule="parse", path=rel,
                                    line=e.lineno or 1,
                                    message=f"syntax error: {e.msg}"))
            continue
        modules.append(Module(f, rel, text, tree))

    ctx = RepoContext(modules, repo_root=root)
    for mod in modules:
        findings.extend(_suppression_findings(mod))

    for name in (rules if rules is not None else sorted(_REGISTRY)):
        cls = _REGISTRY.get(name)
        if cls is None:
            raise KeyError(f"unknown lint rule {name!r} "
                           f"(known: {sorted(_REGISTRY)})")
        findings.extend(cls().run(ctx))

    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return LintResult(findings=findings, files=len(modules),
                      scanned=sorted(ctx.scanned))

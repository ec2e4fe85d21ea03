"""kernel-contract: the Hopper kernels' bindings, completeness and build
(counterpart of ``repro.analysis.pallas_contract``).

The port's kernels are ``extern "C"`` launchers in ``kernels/csrc/*.cu``,
built by ``kernels/_build.py`` and called through ``ctypes``.  A ctypes
``argtypes`` list that disagrees with its C signature passes garbage
with no error, and no CPU test reaches a launch, so the bindings are
checked against the sources here:

(a) **ABI.**  Every ``_build.launch("<name>", ARGTYPES, ARGS, device)``
    call: ARGTYPES (a literal, resolved through module-level names and
    aliases such as ``_PTR, _INT = ...``) plus the stream ``c_void_p``
    must match, argument for argument, the parameters of ``extern "C"
    int <name>_launch(...)`` in ``kernels/csrc/<name>.cu`` (a pointer is
    ``c_void_p``, ``int`` is ``c_int``, ``float`` is ``c_float``), and
    ``len(ARGS)`` must equal ``len(ARGTYPES)``.  A direct binding
    ``fn.argtypes = [...]`` of a symbol fetched from ``_build.load(...)``
    is checked against that symbol's declaration the same way.
(b) **Completeness.**  Every name of ``_build.KERNELS`` has its
    ``csrc/<name>.cu`` with ``<name>_launch``, a wrapper ``def <name>`` in
    ``kernels/ops.py``, a plain version ``<name>_ref`` in
    ``kernels/ref.py``, a mention in some ``tests/test_torch_*.py`` and a
    ``kernel_entry("<name>", ...)`` in ``chip_smoke.py``; a ``.cu`` under
    ``csrc/`` that is not in ``KERNELS`` is a finding, and so is a launch
    of a name that is not.
(c) **Launch path.**  Every launch goes through ``_build.launch``, which
    counts it in ``LAUNCHES``: a symbol fetched from ``_build.load(...)``
    and called directly bypasses the count.
(d) **Target.**  ``_build.NVCC_FLAGS`` compiles for ``sm_90a``.
(e) **No blocking call in a launcher.**  A kernel's ``.cu`` calls none of
    ``cudaDeviceSynchronize``, ``cudaStreamSynchronize``, a blocking
    ``cudaMemcpy``, ``cudaMalloc`` or ``cudaFree``: each waits for the
    card inside the round loop, where ``set_sync_debug_mode`` cannot see
    it, and breaks a CUDA-graph capture.

(b), (d) and (e) run when ``kernels/_build.py`` is among the analysed
files.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Tuple

from repro_torch.analysis.core import (Finding, Module, RepoContext, Rule,
                                       literal_eval, register)

KERNELS_DIR = "src/repro_torch/kernels"
BUILD = f"{KERNELS_DIR}/_build.py"

#: ``extern "C" int <symbol>(<params>)``.
_C_DECL = re.compile(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)')
#: Runtime calls that block the host until the card is done.
_BLOCKING = re.compile(r"\b(cudaDeviceSynchronize|cudaStreamSynchronize|"
                       r"cudaMemcpy|cudaMalloc|cudaFree)\s*\(")
_C_SCALARS = {"int": "c_int", "float": "c_float", "double": "c_double",
              "long long": "c_longlong", "int64_t": "c_int64",
              "unsigned": "c_uint", "unsigned int": "c_uint",
              "uint32_t": "c_uint32", "int32_t": "c_int32"}


def c_signature(source: str, symbol: str) -> Optional[List[str]]:
    """The ctypes names of ``symbol``'s parameters in a C source, or None
    when it declares no such ``extern "C"`` function."""
    for m in _C_DECL.finditer(source):
        if m.group(1) != symbol:
            continue
        out = []
        for param in m.group(2).split(","):
            param = " ".join(param.split())
            if not param or param == "void":
                continue
            if "*" in param:
                out.append("c_void_p")
                continue
            words = [w for w in param.split() if w != "const"][:-1]
            out.append(_C_SCALARS.get(" ".join(words), " ".join(words)))
        return out
    return None


def _ctypes_name(node) -> Optional[str]:
    """``ctypes.c_int`` / ``c_int`` -> ``"c_int"``."""
    if isinstance(node, ast.Attribute) and node.attr.startswith("c_"):
        return node.attr
    if isinstance(node, ast.Name) and node.id.startswith("c_"):
        return node.id
    return None


class _Env:
    """Module-level names bound to ctypes types or lists of them."""

    def __init__(self, mod: Module):
        self.values: Dict[str, object] = {}
        for node in mod.tree.body:
            if not isinstance(node, ast.Assign):
                continue
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    val = self.types(node.value)
                    if val is not None:
                        self.values[tgt.id] = val
                elif isinstance(tgt, ast.Tuple) and \
                        isinstance(node.value, ast.Tuple) and \
                        len(tgt.elts) == len(node.value.elts):
                    for t, v in zip(tgt.elts, node.value.elts):
                        val = self.types(v)
                        if isinstance(t, ast.Name) and val is not None:
                            self.values[t.id] = val

    def types(self, node):
        """A ctypes name (str), a list of them, or None."""
        name = _ctypes_name(node)
        if name is not None:
            return name
        if isinstance(node, ast.Name):
            return self.values.get(node.id)
        if isinstance(node, (ast.List, ast.Tuple)):
            items = [self.types(e) for e in node.elts]
            if any(not isinstance(i, str) for i in items):
                return None
            return list(items)
        if isinstance(node, ast.BinOp):
            left, right = self.types(node.left), self.types(node.right)
            if isinstance(node.op, ast.Add) and isinstance(left, list) \
                    and isinstance(right, list):
                return left + right
            if isinstance(node.op, ast.Mult):
                count = literal_eval(node.right)
                if isinstance(left, list) and isinstance(count, int):
                    return left * count
        return None


def _is_build(mod: Module, func, attr: str) -> bool:
    """``_build.<attr>`` from a module, or bare ``<attr>`` inside
    ``_build.py`` itself."""
    if isinstance(func, ast.Attribute) and func.attr == attr:
        return isinstance(func.value, ast.Name) and \
            func.value.id == "_build"
    return isinstance(func, ast.Name) and func.id == attr and \
        mod.rel.endswith("kernels/_build.py")


@register
class KernelContractRule(Rule):
    name = "kernel-contract"
    description = ("ctypes bindings match the extern \"C\" launchers; every "
                   "kernel has a .cu, a wrapper, a plain version, a test and "
                   "a smoke entry; launches are counted; sm_90a; no "
                   "launcher blocks the host")
    severity = "error"

    def run(self, ctx: RepoContext) -> List[Finding]:
        findings: List[Finding] = []
        kernels = ctx.literal(BUILD, "KERNELS")
        kernels = tuple(kernels) if isinstance(kernels, (tuple, list)) \
            else ()

        def add(mod, node, msg):
            f = self.finding(mod, node, msg)
            if f is not None:
                findings.append(f)

        for mod in ctx.modules:
            env = _Env(mod)
            for call in ast.walk(mod.tree):
                if isinstance(call, ast.Call) and \
                        _is_build(mod, call.func, "launch"):
                    self._check_launch(ctx, mod, env, call, kernels, add)
            self._check_direct(ctx, mod, env, add)
        build = ctx.by_rel.get(BUILD)
        if build is not None:
            self._check_complete(ctx, build, kernels, add)
            self._check_target(ctx, build, add)
        return findings

    # -- (a) ABI of _build.launch ----------------------------------------

    def _check_launch(self, ctx, mod, env, call, kernels, add) -> None:
        if len(call.args) < 3 or not isinstance(call.args[0], ast.Constant):
            return                        # launch() itself, or dynamic
        name = call.args[0].value
        if kernels and name not in kernels:
            add(mod, call, f"launch of {name!r}, which is not in "
                           f"_build.KERNELS {list(kernels)}")
            return
        types = env.types(call.args[1])
        if not isinstance(types, list):
            add(mod, call, f"{name}: argtypes are not a literal list the "
                           "lint can read (use [ctypes...] * n + ...)")
            return
        args = call.args[2]
        if isinstance(args, ast.List) and not any(
                isinstance(e, ast.Starred) for e in args.elts) and \
                len(args.elts) != len(types):
            add(mod, call, f"{name}: {len(args.elts)} arguments for "
                           f"{len(types)} argtypes")
        self._compare(ctx, mod, call, name, f"{name}_launch",
                      types + ["c_void_p"], add)

    def _compare(self, ctx, mod, anchor, lib, symbol, types, add) -> None:
        source = ctx.read(f"{KERNELS_DIR}/csrc/{lib}.cu")
        want = c_signature(source, symbol) if source is not None else None
        if want is None:
            add(mod, anchor, f"no extern \"C\" int {symbol}(...) in "
                             f"kernels/csrc/{lib}.cu")
            return
        if len(want) != len(types):
            add(mod, anchor, f"{symbol}: {len(types)} ctypes argtypes (the "
                             f"stream included) for {len(want)} C "
                             f"parameters")
            return
        for i, (py, c) in enumerate(zip(types, want), 1):
            if py != c:
                add(mod, anchor, f"{symbol}: argument {i} is {py} in "
                                 f"Python but {c} in kernels/csrc/{lib}.cu")
                return

    # -- (a) and (c): direct bindings ------------------------------------

    def _check_direct(self, ctx, mod, env, add) -> None:
        """``fn = _build.load("lib").symbol`` then ``fn.argtypes = [...]``:
        the binding is checked against the symbol, and the fetch is a
        launch that bypasses ``_build.launch``."""
        fetched: Dict[str, Tuple[ast.AST, str, str]] = {}
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Assign):
                continue
            val = node.value
            if isinstance(val, ast.Attribute) and \
                    isinstance(val.value, ast.Call) and \
                    _is_build(mod, val.value.func, "load") and \
                    val.value.args and \
                    isinstance(val.value.args[0], ast.Constant):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        fetched[tgt.id] = (node, val.value.args[0].value,
                                           val.attr)
                add(mod, node, f"{val.attr} of {val.value.args[0].value}.cu "
                               "is called outside _build.launch, so its "
                               "launches are not counted in LAUNCHES")
            for tgt in node.targets:
                if isinstance(tgt, ast.Attribute) and \
                        tgt.attr == "argtypes" and \
                        isinstance(tgt.value, ast.Name) and \
                        tgt.value.id in fetched:
                    _, lib, symbol = fetched[tgt.value.id]
                    types = env.types(node.value)
                    if isinstance(types, list):
                        self._compare(ctx, mod, node, lib, symbol, types,
                                      add)

    # -- (b) completeness -------------------------------------------------

    def _check_complete(self, ctx, build: Module, kernels, add) -> None:
        anchor = next((n for n in build.tree.body if isinstance(n, ast.Assign)
                       and any(isinstance(t, ast.Name) and t.id == "KERNELS"
                               for t in n.targets)), 1)
        if not kernels:
            add(build, anchor, "_build.KERNELS is not a literal tuple of "
                               "kernel names")
            return
        ops = self._module_names(ctx, f"{KERNELS_DIR}/ops.py")
        refs = self._module_names(ctx, f"{KERNELS_DIR}/ref.py")
        tests = ctx.corpus("tests", "test_torch_*.py")
        smoke = ctx.read("chip_smoke.py") or ""
        for name in kernels:
            source = ctx.read(f"{KERNELS_DIR}/csrc/{name}.cu")
            missing = []
            if source is None:
                missing.append(f"kernels/csrc/{name}.cu")
            elif c_signature(source, f"{name}_launch") is None:
                missing.append(f"extern \"C\" int {name}_launch in its .cu")
            if name not in ops:
                missing.append(f"a wrapper `def {name}` in kernels/ops.py")
            if f"{name}_ref" not in refs:
                missing.append(f"a plain version `{name}_ref` in "
                               "kernels/ref.py")
            if not re.search(rf"\b{name}\b", tests):
                missing.append("a parity test in tests/test_torch_*.py")
            if not re.search(rf"kernel_entry\(\s*\"{name}\"", smoke):
                missing.append(f"a kernel_entry(\"{name}\", ...) in "
                               "chip_smoke.py")
            if missing:
                add(build, anchor, f"kernel {name!r} lacks "
                                   + "; ".join(missing))
            for m in _BLOCKING.finditer(source or ""):
                line = source.count("\n", 0, m.start()) + 1
                add(build, anchor, f"kernels/csrc/{name}.cu:{line} calls "
                                   f"{m.group(1)}, which blocks the host "
                                   "inside the round loop")
        for cu in self._sources(ctx):
            if cu not in kernels:
                add(build, anchor, f"kernels/csrc/{cu}.cu is not in "
                                   "_build.KERNELS: nothing builds or "
                                   "checks it")

    @staticmethod
    def _module_names(ctx: RepoContext, rel: str) -> set:
        """Names a module binds at top level: defs, imports (with their
        aliases) and assignments."""
        text = ctx.read(rel)
        if text is None:
            return set()
        names = set()
        for node in ast.parse(text).body:
            if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
                names.add(node.name)
            elif isinstance(node, (ast.Import, ast.ImportFrom)):
                names.update(a.asname or a.name for a in node.names)
            elif isinstance(node, ast.Assign):
                names.update(t.id for t in node.targets
                             if isinstance(t, ast.Name))
        return names

    @staticmethod
    def _sources(ctx: RepoContext) -> List[str]:
        where = ctx.repo_root / KERNELS_DIR / "csrc"
        return sorted(p.stem for p in where.glob("*.cu"))

    # -- (d) target ---------------------------------------------------------

    def _check_target(self, ctx, build: Module, add) -> None:
        flags = ctx.literal(BUILD, "NVCC_FLAGS")
        if not (isinstance(flags, (tuple, list)) and any(
                isinstance(f, str) and "sm_90a" in f for f in flags)):
            add(build, 1, "_build.NVCC_FLAGS does not compile for sm_90a "
                          "(-gencode arch=compute_90a,code=sm_90a)")

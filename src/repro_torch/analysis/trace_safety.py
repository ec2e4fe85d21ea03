"""trace-safety: no host<->device sync inside the port's round loop.

A round of the port (expand, steal, replay, the open-work count) is
eager PyTorch dispatched from one host thread.  The host reads back ONE
vector a round, at the boundary between the round's plan and its replay
chunks: the open work and the deepest task received, in
``core.round_graph.read_back``, its one copy marked as the round's
readback (the collector adds one stacked ``.cpu()`` when telemetry is
on).  Anything inside the round
that waits for the card (``.item()``, ``int(tensor)``, a Python ``if`` on
a tensor, ``torch.nonzero``, a boolean-mask index, a blocking copy)
stalls the dispatch every step, and makes the round impossible to
capture as a CUDA graph.  ``chip_smoke.py`` phase 25 holds the same
claim on the card under ``torch.cuda.set_sync_debug_mode("error")``.
The LM serving steps (``serve.engine``'s prefill and decode step
functions) are held to the same rule: the driver reads the host once a
tick, outside them (phase 26 audits a decode step on the card).  So are
the steps the dry run traces on ``meta`` (``launch.dryrun``), where a
host read has no value to read and raises.

The pass is static, in three stages:

1. **Scope.**  Eager PyTorch has no tracing primitive to mark the round,
   so its roots are named in :data:`ROUND_LOOP_ROOTS` (``module:qualname``;
   closures by their enclosing function's name).  A root that no longer
   resolves is a finding, so a rename cannot empty the scope.  From the
   roots the scope grows through calls by name (module functions,
   ``from x import y`` symbols, ``mod.f`` through module aliases, a
   class's ``__init__`` for a constructor call) and through attribute
   calls on objects: on a receiver declared as an analysed class
   (``problem: BinaryProblem``, ``self``) to that class's method or to
   the functions passed to its constructor under that keyword
   (``BinaryProblem(evaluate_batch=evaluate_batch)``), on any other
   receiver to every method and closure of the package of that name.
   Functions and lambdas nested in a scanned function are scanned, as
   are analysed functions passed as arguments.
   A branch guarded by ``<x>.device.type == "cpu"`` (or the else of
   ``!= "cpu"``) is the CPU path, not the card's round, and is skipped.
2. **Taint.**  Tensor-typed parameters (annotations naming ``Tensor``,
   ``Lanes``, a ``*State`` or ``*Tables`` tuple, ``PyTree``,
   ``NodeEval``), unannotated parameters of nested functions and lambdas
   (they map the closure's tensors), results of ``torch.*`` calls and of
   tensor methods are device values; taint flows through assignments,
   unpacking, ``for`` and comprehension targets.  Static metadata does
   not taint: ``.shape``, ``.dtype``, ``.device``, ``.ndim``,
   ``.requires_grad``, ``.numel()``, ``.dim()``, ``.size()``, ``.is_contiguous()``,
   ``.data_ptr()``, ``len()``; ``is None`` and ``isinstance`` tests are
   host-side.
3. **Hazards** (one finding each): ``.item()``, ``.tolist()``,
   ``.cpu()``, ``.numpy()`` on any receiver (tainted or not: an
   unannotated helper's parameters carry no taint), ``.to("cpu")`` of a
   device value; ``int()`` / ``float()`` /
   ``bool()`` of a device value; ``if`` / ``while`` / ``assert`` / a
   ternary / ``and`` / ``or`` on one; ``torch.nonzero`` and
   ``.nonzero()``; ``torch.unique``; ``torch.masked_select``; one-argument
   ``torch.where``; ``repeat_interleave`` without ``output_size``; an
   index by a boolean tensor; ``synchronize()``; ``print`` of a device
   value; ``torch.tensor`` / ``torch.as_tensor`` and an index by a
   Python list (a host-to-device copy on the card, which a CUDA graph's
   capture refuses).
"""

from __future__ import annotations

import ast
import re
from typing import Dict, Iterator, List, Optional, Set, Tuple

from repro_torch.analysis.core import (Finding, Module, RepoContext, Rule,
                                       register)

#: The round loop's entry points and the LM serving steps,
#: ``module:qualname``.  Everything they reach on the card must run
#: without a host sync.
ROUND_LOOP_ROOTS: Tuple[str, ...] = (
    "repro_torch.core.engine:make_step.step",
    "repro_torch.core.engine:make_expand.expand",
    "repro_torch.core.engine:replay_path",
    "repro_torch.core.steal:balance_device",
    "repro_torch.core.distributed:make_round.plan",
    "repro_torch.core.distributed:make_round.chunk",
    # The single-device round's CUDA graph: warm-up, capture and replay.
    "repro_torch.core.round_graph:GraphedRound.__call__",
    "repro_torch.core.round_graph:eager.counted",
    "repro_torch.core.distributed:make_distributed_round.round_fn",
    "repro_torch.core.distributed:cross_device_assign",
    "repro_torch.core.distributed:replay_per_device",
    # The round's spans: ``with spans.span(...)`` reaches these implicitly.
    "repro_torch.obs.spans:_Opened.__enter__",
    "repro_torch.obs.spans:_Opened.__exit__",
    "repro_torch.problems.vertex_cover:make_vertex_cover.evaluate_batch",
    "repro_torch.problems.dominating_set:make_dominating_set.evaluate_batch",
    "repro_torch.problems.subset_sum:make_subset_sum.evaluate_batch",
    "repro_torch.service.batch_problem:StackedSpec.bind.evaluate_batch",
    "repro_torch.serve.engine:make_prefill_step.step",
    "repro_torch.serve.engine:make_decode_step.step",
    "repro_torch.train.step:make_train_step.step",
    "repro_torch.launch.dryrun:input_specs.train_step",
    "repro_torch.launch.dryrun:input_specs.prefill_step",
    "repro_torch.launch.dryrun:input_specs.decode_step",
)

#: The package whose methods and closures attribute calls resolve to.
PACKAGE = "repro_torch"

#: Annotations that declare a parameter a device value.
_TENSOR_TYPES = re.compile(r"Tensor|Lanes|State\b|Tables\b|PyTree|NodeEval")

#: Attribute reads and method calls that are static metadata.
_STATIC_ATTRS = {"shape", "dtype", "device", "ndim", "is_cuda", "layout",
                 "type", "index", "requires_grad"}
_STATIC_METHODS = {"numel", "dim", "size", "is_contiguous", "data_ptr",
                   "element_size", "stride", "get_device", "ndimension",
                   "nelement", "is_floating_point"}

#: ``torch.*`` names whose results live on the host.
_HOST_TORCH = {"device", "Size", "iinfo", "finfo", "is_tensor",
               "get_default_dtype", "is_grad_enabled", "Generator"}

#: Builtins whose results are host values (the conversions among them
#: are hazards of their own).
_HOST_BUILTINS = {"int", "float", "bool", "len", "isinstance", "range",
                  "type", "str", "hasattr", "repr", "id"}

_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
_BOOL_METHODS = {"any", "all", "eq", "ne", "lt", "le", "gt", "ge",
                 "isnan", "isinf", "isfinite", "logical_and",
                 "logical_or", "logical_not", "logical_xor"}
#: Fields of the engine's tuples that hold boolean tensors.
_BOOL_FIELDS = {"active", "is_solution"}

_SYNC_HINT = ("forces a host sync inside the round loop; keep it on the "
              "device or move it to the round boundary")


class _Func:
    __slots__ = ("node", "mod", "parent", "qualname", "kind", "cls",
                 "local")

    def __init__(self, node, mod: Module, parent: Optional["_Func"],
                 qualname: str, kind: str, cls: Optional[str]):
        self.node = node        # FunctionDef | AsyncFunctionDef | Lambda
        self.mod = mod
        self.parent = parent    # the enclosing function, if any
        self.qualname = qualname
        self.kind = kind        # "module" | "method" | "nested"
        self.cls = cls          # a method's class
        self.local: Dict[str, "_Func"] = {}

    def params(self) -> List[ast.arg]:
        args = self.node.args
        return (list(args.posonlyargs) + list(args.args)
                + list(args.kwonlyargs)
                + [a for a in (args.vararg, args.kwarg) if a is not None])

    def label(self, ctx: RepoContext) -> str:
        return f"{self.mod.dotted(ctx.src_root) or self.mod.rel}:" \
               f"{self.qualname}"


class _Index:
    """Per-module functions and imports."""

    def __init__(self, mod: Module):
        self.mod = mod
        self.funcs: Dict[str, _Func] = {}          # module-level defs
        self.by_qualname: Dict[str, _Func] = {}
        self.modules: Dict[str, str] = {}          # alias -> dotted module
        self.symbols: Dict[str, Tuple[str, str]] = {}  # alias -> (mod, name)
        #: Module-level names bound to a literal dict, list, set or tuple.
        self.containers: Set[str] = set()
        self.classes: Set[str] = set()             # module-level classes


def _is_cpu_test(test) -> Optional[bool]:
    """True for ``<...>.type == "cpu"``, False for ``!= "cpu"``, None
    for any other test."""
    if not (isinstance(test, ast.Compare) and len(test.ops) == 1):
        return None
    sides = (test.left, test.comparators[0])
    if not any(isinstance(s, ast.Constant) and s.value == "cpu"
               for s in sides):
        return None
    if not any(isinstance(s, ast.Attribute) and s.attr == "type"
               for s in sides):
        return None
    if isinstance(test.ops[0], ast.Eq):
        return True
    return False if isinstance(test.ops[0], ast.NotEq) else None


def own_statements(func_node) -> Iterator[ast.stmt]:
    """A function's statements, through control flow but not into nested
    functions or classes, nor into the CPU branch of a device test."""
    todo = list(func_node.body)
    while todo:
        stmt = todo.pop(0)
        yield stmt
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            continue
        if isinstance(stmt, ast.If):
            cpu = _is_cpu_test(stmt.test)
            if cpu is not True:
                todo.extend(stmt.body)
            if cpu is not False:
                todo.extend(stmt.orelse)
            continue
        for field in ("body", "orelse", "finalbody"):
            todo.extend(getattr(stmt, field, []) or [])
        for handler in getattr(stmt, "handlers", []) or []:
            todo.extend(handler.body)


def own_expressions(stmt: ast.stmt) -> Iterator[ast.AST]:
    """Every node of a statement's own expressions (a ``with``'s context
    expressions among them): not those of the statements nested in it,
    nor the bodies of its lambdas."""
    todo = [c for c in ast.iter_child_nodes(stmt) if isinstance(c, ast.expr)]
    if isinstance(stmt, (ast.With, ast.AsyncWith)):
        todo.extend(item.context_expr for item in stmt.items)
    while todo:
        node = todo.pop()
        yield node
        if isinstance(node, ast.Lambda):
            continue
        todo.extend(ast.iter_child_nodes(node))


class _Project:
    """Every function of the analysed modules, with the imports and the
    classes that resolve calls between them."""

    def __init__(self, ctx: RepoContext):
        self.ctx = ctx
        self.indexes: Dict[str, _Index] = {}
        self.funcs: List[_Func] = []
        self.by_node: Dict[int, _Func] = {}
        self.by_name: Dict[str, List[_Func]] = {}   # methods and closures
        self.methods: Dict[str, Dict[str, _Func]] = {}   # class -> methods
        self._calls: List[Tuple[ast.Call, Optional[_Func], Module]] = []
        for mod in ctx.modules:
            self._index(mod)
        # Fields: functions passed by keyword to a class's constructor
        # (``BinaryProblem(root=root, evaluate_batch=evaluate_batch)``).
        self.fields: Dict[Tuple[str, str], List[_Func]] = {}
        for call, scope, mod in self._calls:
            cls = _callee_name(call.func)
            if cls not in self.methods:
                continue
            for kw in call.keywords:
                target = self._function_value(kw.value, scope, mod)
                if kw.arg is not None and target is not None:
                    self.fields.setdefault((cls, kw.arg), []).append(target)

    def _index(self, mod: Module) -> None:
        idx = _Index(mod)
        self.indexes[mod.rel] = idx
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    name = alias.asname or alias.name.split(".")[0]
                    idx.modules[name] = (alias.name if alias.asname
                                         else alias.name.split(".")[0])
            elif isinstance(node, ast.ImportFrom) and node.module \
                    and not node.level:
                for alias in node.names:
                    name = alias.asname or alias.name
                    idx.modules.setdefault(name,
                                           f"{node.module}.{alias.name}")
                    idx.symbols[name] = (node.module, alias.name)
        for node in mod.tree.body:
            value = getattr(node, "value", None)
            if isinstance(node, (ast.Assign, ast.AnnAssign)) and isinstance(
                    value, (ast.Dict, ast.List, ast.Set, ast.Tuple)):
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                for tgt in targets:
                    if isinstance(tgt, ast.Name):
                        idx.containers.add(tgt.id)
        in_package = (mod.dotted(self.ctx.src_root) or "").split(".")[0] \
            == PACKAGE

        def visit(node, parent: Optional[_Func], prefix: str,
                  cls: Optional[str]) -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef, ast.Lambda)):
                    lam = isinstance(child, ast.Lambda)
                    name = f"<lambda@{child.lineno}>" if lam else child.name
                    kind = ("nested" if parent is not None else
                            "method" if cls else "module")
                    info = _Func(child, mod, parent, prefix + name, kind,
                                 cls if kind == "method" else None)
                    self.funcs.append(info)
                    self.by_node[id(child)] = info
                    idx.by_qualname[info.qualname] = info
                    if not lam:
                        if parent is not None:
                            parent.local[child.name] = info
                        elif cls:
                            self.methods.setdefault(cls, {})[
                                child.name] = info
                        else:
                            idx.funcs.setdefault(child.name, info)
                        if kind != "module" and in_package:
                            self.by_name.setdefault(child.name, []).append(
                                info)
                    visit(child, info, info.qualname + ".", None)
                elif isinstance(child, ast.ClassDef):
                    self.methods.setdefault(child.name, {})
                    if parent is None and not prefix:
                        idx.classes.add(child.name)
                    visit(child, parent, prefix + child.name + ".",
                          child.name)
                else:
                    if isinstance(child, ast.Call):
                        self._calls.append((child, parent, mod))
                    visit(child, parent, prefix, cls)

        visit(mod.tree, None, "", None)

    def _function_value(self, value, scope: Optional[_Func],
                        mod: Module) -> Optional[_Func]:
        if isinstance(value, ast.Lambda):
            return self.by_node.get(id(value))
        if isinstance(value, ast.Name):
            return self.resolve_name(value.id, scope, mod)
        return None

    def _module_funcs(self, dotted: str) -> Optional[_Index]:
        target = self.ctx.by_dotted.get(dotted)
        return self.indexes.get(target.rel) if target is not None else None

    def resolve_name(self, name: str, scope: Optional[_Func],
                     mod: Module) -> Optional[_Func]:
        s = scope
        while s is not None:
            if name in s.local:
                return s.local[name]
            s = s.parent
        idx = self.indexes[mod.rel]
        if name in idx.funcs:
            return idx.funcs[name]
        sym = idx.symbols.get(name)
        if sym is not None:
            tindex = self._module_funcs(sym[0])
            if tindex is not None:
                return tindex.funcs.get(sym[1])
        return None

    def _constructor(self, tindex: Optional[_Index],
                     name: str) -> List[_Func]:
        """A class's own ``__init__`` / ``__post_init__``, for a call of the
        class ``name`` defined in the module of ``tindex``."""
        if tindex is None or name not in tindex.classes:
            return []
        methods = self.methods.get(name, {})
        return [methods[m] for m in ("__init__", "__post_init__")
                if m in methods]

    def receiver_class(self, name: str, scope: _Func) -> Optional[str]:
        """The analysed class a receiver name is declared as: ``self`` of
        a method, or a parameter (of the function or an enclosing one)
        annotated with the class."""
        s: Optional[_Func] = scope
        while s is not None:
            if name in ("self", "cls") and s.cls is not None:
                return s.cls
            for a in s.params():
                if a.arg == name:
                    if a.annotation is None:
                        return None
                    return next((n.id if isinstance(n, ast.Name) else n.attr
                                 for n in ast.walk(a.annotation)
                                 if isinstance(n, (ast.Name, ast.Attribute))
                                 and _callee_name(n) in self.methods), None)
            s = s.parent
        return None

    def resolve_call(self, func, scope: _Func) -> List[_Func]:
        """The analysed functions a call's callee may be."""
        idx = self.indexes[scope.mod.rel]
        if isinstance(func, ast.Name):
            target = self.resolve_name(func.id, scope, scope.mod)
            if target is not None:
                return [target]
            sym = idx.symbols.get(func.id)
            tindex = self._module_funcs(sym[0]) if sym else idx
            return self._constructor(tindex, sym[1] if sym else func.id)
        if not isinstance(func, ast.Attribute):
            return []
        root = func.value
        while isinstance(root, ast.Attribute):
            root = root.value
        if isinstance(root, ast.Name) and root.id in idx.modules \
                and self.resolve_name(root.id, scope, scope.mod) is None:
            # ``mod.f`` / ``mod.C(...)``: resolve through the module alias.
            if isinstance(func.value, ast.Name):
                tindex = self._module_funcs(idx.modules[root.id])
                if tindex is not None and func.attr in tindex.funcs:
                    return [tindex.funcs[func.attr]]
                return self._constructor(tindex, func.attr)
            return []
        if isinstance(func.value, ast.Name):
            if func.value.id in idx.containers:
                return []         # a module's dict or list: no method
            cls = self.receiver_class(func.value.id, scope)
            if cls is not None:
                method = self.methods[cls].get(func.attr)
                return ([method] if method is not None else []) + \
                    self.fields.get((cls, func.attr), [])
        if func.attr.startswith("__"):
            return []           # super().__init__(...) and the like
        return list(self.by_name.get(func.attr, []))


def _callee_name(func) -> Optional[str]:
    if isinstance(func, ast.Name):
        return func.id
    if isinstance(func, ast.Attribute):
        return func.attr
    return None


def _annotation_taints(ann) -> bool:
    return ann is not None and _TENSOR_TYPES.search(ast.unparse(ann)) \
        is not None


class _Taint:
    """Device values of one function, and its hazards."""

    def __init__(self, project: _Project, info: _Func):
        self.info = info
        self.mod = info.mod
        self.torch = {a for a, m in project.indexes[info.mod.rel]
                      .modules.items() if m == "torch"}
        self.tainted: Set[str] = set()
        self.boolish: Set[str] = set()
        args = info.node.args
        positional = list(args.posonlyargs) + list(args.args)
        defaulted = {a.arg for a in positional[len(positional)
                                               - len(args.defaults):]}
        defaulted.update(a.arg for a, d in zip(args.kwonlyargs,
                                               args.kw_defaults)
                         if d is not None)
        for a in info.params():
            if a.arg in ("self", "cls"):
                continue
            if a.annotation is not None:
                if _annotation_taints(a.annotation):
                    self.tainted.add(a.arg)
            elif info.kind == "nested" and a.arg not in defaulted:
                self.tainted.add(a.arg)
        self._propagate()

    # -- taint ---------------------------------------------------------

    def _torch_call(self, func) -> Optional[str]:
        """``"cuda.synchronize"``-style path of a ``torch.*`` callee, or
        None when the callee is not under the torch module."""
        parts = []
        node = func
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if isinstance(node, ast.Name) and node.id in self.torch and parts:
            return ".".join(reversed(parts))
        return None

    def tainted_expr(self, expr) -> bool:
        if isinstance(expr, ast.Name):
            return expr.id in self.tainted
        if isinstance(expr, ast.Attribute):
            return expr.attr not in _STATIC_ATTRS and \
                self.tainted_expr(expr.value)
        if isinstance(expr, ast.Subscript):
            return self.tainted_expr(expr.value)
        if isinstance(expr, ast.Call):
            func = expr.func
            if isinstance(func, ast.Name) and func.id in _HOST_BUILTINS:
                return False
            path = self._torch_call(func)
            if path is not None:
                return not (path.startswith("cuda.")
                            or path in _HOST_TORCH)
            if isinstance(func, ast.Attribute) and \
                    self.tainted_expr(func.value):
                return func.attr not in _STATIC_METHODS
            return any(self.tainted_expr(a) for a in expr.args) or \
                any(self.tainted_expr(k.value) for k in expr.keywords)
        if isinstance(expr, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot)) for op in expr.ops):
                return False
            return any(self.tainted_expr(x)
                       for x in [expr.left, *expr.comparators])
        if isinstance(expr, (ast.Constant, ast.Lambda)):
            return False
        return any(self.tainted_expr(c) for c in ast.iter_child_nodes(expr)
                   if isinstance(c, ast.expr))

    def boolish_expr(self, expr) -> bool:
        """A device value of dtype bool, as far as the text shows."""
        if isinstance(expr, ast.Name):
            return expr.id in self.boolish
        if isinstance(expr, ast.Compare):
            return self.tainted_expr(expr)
        if isinstance(expr, ast.UnaryOp) and isinstance(expr.op, ast.Invert):
            return self.boolish_expr(expr.operand)
        if isinstance(expr, ast.BinOp) and isinstance(
                expr.op, (ast.BitAnd, ast.BitOr, ast.BitXor)):
            return self.boolish_expr(expr.left) or \
                self.boolish_expr(expr.right)
        if isinstance(expr, ast.Attribute):
            return expr.attr in _BOOL_FIELDS and self.tainted_expr(expr)
        if isinstance(expr, ast.Call) and isinstance(expr.func,
                                                     ast.Attribute):
            return expr.func.attr in _BOOL_METHODS and \
                self.tainted_expr(expr)
        return False

    def _bind(self, target, value) -> bool:
        if isinstance(target, (ast.Subscript, ast.Attribute)):
            return False
        changed = False
        taint = self.tainted_expr(value)
        boolish = self.boolish_expr(value)
        for node in ast.walk(target):
            if not isinstance(node, ast.Name):
                continue
            if taint and node.id not in self.tainted:
                self.tainted.add(node.id)
                changed = True
            if boolish and isinstance(target, ast.Name) and \
                    node.id not in self.boolish:
                self.boolish.add(node.id)
                changed = True
        return changed

    def _propagate(self) -> None:
        node = self.info.node
        if isinstance(node, ast.Lambda):
            return
        stmts = list(own_statements(node))
        for _ in range(20):
            changed = False
            for stmt in stmts:
                if isinstance(stmt, ast.Assign):
                    for tgt in stmt.targets:
                        changed |= self._bind(tgt, stmt.value)
                elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)) \
                        and stmt.value is not None:
                    changed |= self._bind(stmt.target, stmt.value)
                elif isinstance(stmt, (ast.For, ast.AsyncFor)):
                    changed |= self._bind(stmt.target, stmt.iter)
                elif isinstance(stmt, (ast.With, ast.AsyncWith)):
                    for item in stmt.items:
                        if item.optional_vars is not None:
                            changed |= self._bind(item.optional_vars,
                                                  item.context_expr)
                for expr in own_expressions(stmt):
                    if isinstance(expr, ast.comprehension):
                        changed |= self._bind(expr.target, expr.iter)
            if not changed:
                break

    # -- hazards -------------------------------------------------------

    @staticmethod
    def _host_safe(test) -> bool:
        if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
            return _Taint._host_safe(test.operand)
        if isinstance(test, ast.Call) and isinstance(test.func, ast.Name) \
                and test.func.id in ("isinstance", "hasattr", "callable"):
            return True
        return False

    def _branch(self, test) -> bool:
        return self.tainted_expr(test) and not self._host_safe(test)

    def _call_hazard(self, call: ast.Call) -> Optional[str]:
        func = call.func
        path = self._torch_call(func)
        if isinstance(func, ast.Name):
            if func.id in ("int", "float", "bool") and call.args and \
                    self.tainted_expr(call.args[0]):
                return f"`{func.id}()` of a device tensor {_SYNC_HINT}"
            if func.id == "print" and any(self.tainted_expr(a)
                                          for a in call.args):
                return f"`print` of a device tensor {_SYNC_HINT}"
            return None
        if not isinstance(func, ast.Attribute):
            return None
        name = func.attr
        if path is not None:
            if path in ("nonzero", "unique", "masked_select"):
                return (f"`torch.{path}` has a data-dependent output size: "
                        f"it {_SYNC_HINT}")
            if path == "where" and len(call.args) == 1 and not call.keywords:
                return ("one-argument `torch.where` is `nonzero`: it "
                        f"{_SYNC_HINT}")
            if path == "repeat_interleave" and self._unsized_repeat(
                    call, first=1):
                return ("`repeat_interleave` with tensor repeats and no "
                        f"`output_size` {_SYNC_HINT}")
            if path in ("tensor", "as_tensor"):
                return (f"`torch.{path}` builds a tensor from host values: "
                        "on the card a blocking host-to-device copy each "
                        "call; make it once, outside the round")
            if path.endswith("synchronize"):
                return f"`torch.{path}()` {_SYNC_HINT}"
            return None
        if name == "synchronize":
            return f"`.synchronize()` {_SYNC_HINT}"
        if name in _SYNC_METHODS:
            # Whatever the receiver: no host object of the round loop has
            # these, and an unannotated helper's parameters carry no taint.
            return f"`.{name}()` on a device tensor {_SYNC_HINT}"
        if not self.tainted_expr(func.value):
            return None
        if name == "to" and self._to_cpu(call):
            return f"`.to(\"cpu\")` of a device tensor {_SYNC_HINT}"
        if name in ("nonzero", "unique", "masked_select"):
            return (f"`.{name}()` has a data-dependent output size: it "
                    f"{_SYNC_HINT}")
        if name == "repeat_interleave" and self._unsized_repeat(call,
                                                                first=0):
            return ("`repeat_interleave` with tensor repeats and no "
                    f"`output_size` {_SYNC_HINT}")
        return None

    def _unsized_repeat(self, call: ast.Call, first: int) -> bool:
        if any(k.arg == "output_size" for k in call.keywords):
            return False
        repeats = [k.value for k in call.keywords if k.arg == "repeats"]
        repeats += call.args[first:first + 1]
        if not repeats:
            return first == 1       # torch.repeat_interleave(counts)
        return self.tainted_expr(repeats[0])

    def _to_cpu(self, call: ast.Call) -> bool:
        args = list(call.args) + [k.value for k in call.keywords
                                  if k.arg == "device"]
        for a in args:
            if isinstance(a, ast.Constant) and a.value == "cpu":
                return True
            if isinstance(a, ast.Call) and self._torch_call(a.func) == \
                    "device" and a.args and isinstance(a.args[0],
                                                       ast.Constant) \
                    and a.args[0].value == "cpu":
                return True
        return False

    def _index_by(self, sub: ast.Subscript, test) -> bool:
        """Does a part of the index of device value ``sub`` pass ``test``?"""
        index = sub.slice
        parts = index.elts if isinstance(index, ast.Tuple) else [index]
        return self.tainted_expr(sub.value) and any(test(p) for p in parts)

    def hazards(self) -> List[Tuple[ast.AST, str]]:
        node = self.info.node
        out: List[Tuple[ast.AST, str]] = []
        reported_tests: Set[int] = set()

        def branch(stmt_or_expr, test, what):
            if self._branch(test):
                out.append((stmt_or_expr, f"Python `{what}` on a device "
                                          f"tensor {_SYNC_HINT}"))
                reported_tests.update(id(n) for n in ast.walk(test))

        if isinstance(node, ast.Lambda):
            exprs: List[ast.AST] = []
            todo = [node.body]
            while todo:
                n = todo.pop()
                exprs.append(n)
                if not isinstance(n, ast.Lambda):
                    todo.extend(ast.iter_child_nodes(n))
        else:
            exprs = []
            for stmt in own_statements(node):
                if isinstance(stmt, ast.If):
                    branch(stmt, stmt.test, "if")
                elif isinstance(stmt, ast.While):
                    branch(stmt, stmt.test, "while")
                elif isinstance(stmt, ast.Assert):
                    branch(stmt, stmt.test, "assert")
                exprs.extend(own_expressions(stmt))
        for expr in exprs:
            if isinstance(expr, ast.IfExp):
                branch(expr, expr.test, "... if ... else")
        for expr in exprs:
            if isinstance(expr, ast.BoolOp) and id(expr) not in \
                    reported_tests and any(self.tainted_expr(v)
                                           for v in expr.values[:-1]):
                what = "and" if isinstance(expr.op, ast.And) else "or"
                out.append((expr, f"Python `{what}` on a device tensor "
                                  f"{_SYNC_HINT}"))
                reported_tests.update(id(n) for n in ast.walk(expr))
            elif isinstance(expr, ast.Call):
                msg = self._call_hazard(expr)
                if msg is not None:
                    out.append((expr, msg))
            elif isinstance(expr, ast.Subscript) and self._index_by(
                    expr, self.boolish_expr):
                out.append((expr, "indexing by a boolean tensor is a "
                                  f"`nonzero`: it {_SYNC_HINT}"))
            elif isinstance(expr, ast.Subscript) and self._index_by(
                    expr, lambda p: isinstance(p, (ast.List, ast.ListComp))):
                out.append((expr, "indexing by a Python list builds a "
                                  "host tensor: on the card a host-to-"
                                  "device copy each call, which a CUDA "
                                  "graph's capture refuses; slice, or "
                                  "stack the picked parts"))
        return out


@register
class TraceSafetyRule(Rule):
    name = "trace-safety"
    description = ("host-sync constructs inside functions reachable from "
                   "the round loop's roots (ROUND_LOOP_ROOTS)")
    severity = "error"

    def run(self, ctx: RepoContext) -> List[Finding]:
        project = _Project(ctx)
        findings: List[Finding] = []
        worklist = self._roots(ctx, project, findings)

        scope: Dict[int, _Func] = {}
        while worklist:
            info = worklist.pop()
            if id(info) in scope:
                continue
            scope[id(info)] = info
            worklist.extend(self._reached(project, info))

        seen = set()
        for info in sorted(scope.values(),
                           key=lambda f: (f.mod.rel, f.node.lineno)):
            ctx.scanned.append(info.label(ctx))
            for node, msg in _Taint(project, info).hazards():
                f = self.finding(info.mod, node, msg)
                if f is not None and (f.path, f.line, f.message) not in seen:
                    seen.add((f.path, f.line, f.message))
                    findings.append(f)
        return findings

    def _roots(self, ctx: RepoContext, project: _Project,
               findings: List[Finding]) -> List[_Func]:
        """The roots' functions; a root whose module is analysed (or, for
        a run over the whole package, any root) that does not resolve is
        a finding."""
        whole = ctx.by_dotted.get(PACKAGE)
        roots = []
        for root in ROUND_LOOP_ROOTS:
            dotted, qualname = root.split(":")
            mod = ctx.by_dotted.get(dotted)
            info = (project.indexes[mod.rel].by_qualname.get(qualname)
                    if mod is not None else None)
            if info is not None:
                roots.append(info)
            elif mod is not None or whole is not None:
                f = self.finding(
                    mod or whole, 1,
                    f"round-loop root {root} does not resolve: update "
                    "ROUND_LOOP_ROOTS in repro_torch/analysis/"
                    "trace_safety.py with the new name")
                if f is not None:
                    findings.append(f)
        return roots

    @staticmethod
    def _reached(project: _Project, info: _Func) -> List[_Func]:
        """Functions a scanned function reaches: its nested functions
        and lambdas, its callees, and analysed functions it passes on."""
        out = [f for f in project.funcs if f.parent is info]
        node = info.node
        if isinstance(node, ast.Lambda):
            nodes = [n for n in ast.walk(node.body)]
        else:
            nodes = [n for stmt in own_statements(node)
                     for n in own_expressions(stmt)]
        for n in nodes:
            if not isinstance(n, ast.Call):
                continue
            out.extend(project.resolve_call(n.func, info))
            for arg in list(n.args) + [k.value for k in n.keywords]:
                if isinstance(arg, ast.Name):
                    target = project.resolve_name(arg.id, info, info.mod)
                    if target is not None:
                        out.append(target)
        return out

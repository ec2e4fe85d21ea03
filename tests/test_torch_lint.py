"""The port's static checks (``repro_torch.analysis``): every rule fires
on a bad snippet and stays silent on a good one, each hazard class gives
exactly one finding, suppressions behave and do not collide with the
reference's, planted faults in copies of real files are caught, the
whole port is clean, and the CLI, the API snapshot and the binding guard
of ``kernels/_build.py`` work.  Snippets are miniature ``src/repro_torch``
trees under ``tmp_path``."""
import ctypes
import json
import os
import pathlib
import re
import shutil
import subprocess
import sys
import textwrap
import types

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.analysis import all_rules, lint_paths  # noqa: E402
from repro_torch.analysis.api_hygiene import parse_snapshot  # noqa: E402
from repro_torch.analysis.kernel_contract import c_signature  # noqa: E402
from repro_torch.analysis.trace_safety import ROUND_LOOP_ROOTS  # noqa: E402

ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"))


#: What the rules read from the linted checkout besides the files they
#: analyse: the kernel table, the CUDA sources, the wrappers and plain
#: versions, the telemetry tables, the snapshot, the parity tests and the
#: smoke.  The lint reads no other checkout, so every miniature tree
#: carries a copy of them.
TRUTH = ("src/repro_torch/kernels/_build.py",
         "src/repro_torch/kernels/ops.py", "src/repro_torch/kernels/ref.py",
         "src/repro_torch/solver.py", "src/repro_torch/obs/trace.py",
         "src/repro_torch/analysis/api_surface.py",
         "src/repro_torch/analysis/api_surface.txt", "chip_smoke.py")
TRUTH_GLOBS = ("src/repro_torch/kernels/csrc/*", "tests/test_torch_*.py")


def _copy(root: pathlib.Path, rels) -> None:
    for rel in rels:
        (root / rel).parent.mkdir(parents=True, exist_ok=True)
        shutil.copyfile(ROOT / rel, root / rel)


def _tree(root: pathlib.Path, files: dict) -> pathlib.Path:
    """A miniature checkout at ``root``: the ground truth, then
    ``files`` (repo-relative path -> text) over it."""
    if not (root / "chip_smoke.py").exists():
        _copy(root, TRUTH)
        _copy(root, [str(p.relative_to(ROOT)) for g in TRUTH_GLOBS
                     for p in sorted(ROOT.glob(g))])
    for rel, text in files.items():
        path = root / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(textwrap.dedent(text))
    return root


def _written(root: pathlib.Path) -> list:
    """The ``.py`` files under ``root/src`` that are not plain copies of
    the checkout's: those the test wrote."""
    out = []
    for path in sorted((root / "src").rglob("*.py")):
        rel = str(path.relative_to(root))
        twin = ROOT / rel
        if not (twin.is_file() and twin.read_bytes() == path.read_bytes()):
            out.append(rel)
    return out


def _lint(root, *paths, rules=None):
    return lint_paths(list(paths) or _written(root), root=root, rules=rules)


def _only(result, rule):
    assert [f.rule for f in result.findings] == [rule], \
        [f.format() for f in result.findings]
    return result.findings[0]


# ---------------------------------------------------------------------------
# trace-safety
# ---------------------------------------------------------------------------

STEAL = "src/repro_torch/core/steal.py"
ROOT_MODULE = """\
import torch
from typing import NamedTuple

from repro_torch.core import helpers


class Lanes(NamedTuple):
    idx: torch.Tensor
    depth: torch.Tensor
    inst: torch.Tensor
    active: torch.Tensor
    nodes: torch.Tensor
    best: torch.Tensor


def balance_device(problem, lanes: Lanes) -> Lanes:
    {body}
    return lanes
"""

#: One snippet per hazard class, each a line of ``balance_device``.
HAZARDS = {
    "item": "n = lanes.best.min().item()",
    "tolist": "n = lanes.best.tolist()",
    "cpu": "n = lanes.best.cpu()",
    "numpy": "n = lanes.best.numpy()",
    "to-cpu": 'n = lanes.best.to("cpu")',
    "int": "n = int(lanes.nodes.sum())",
    "float": "n = float(lanes.nodes.sum())",
    "bool": "n = bool(lanes.active.any())",
    "if": "if lanes.active.any():\n        n = 1",
    "while": "while lanes.active.any():\n        break",
    "assert": "assert lanes.active.any()",
    "ternary": "n = 1 if lanes.active.any() else 0",
    "and": "n = lanes.active.any() and problem",
    "or": "n = lanes.active.any() or problem",
    "torch.nonzero": "n = torch.nonzero(lanes.active)",
    "nonzero-method": "n = lanes.active.nonzero()",
    "unique": "n = torch.unique(lanes.inst)",
    "masked_select": "n = torch.masked_select(lanes.inst, lanes.active)",
    "one-argument-where": "n = torch.where(lanes.active)",
    "repeat_interleave": "n = torch.repeat_interleave(lanes.inst, "
                         "lanes.nodes)",
    "bool-index": "n = lanes.inst[lanes.active]",
    "bool-index-compare": "n = lanes.inst[lanes.depth > 0]",
    "bool-index-store": "ok = lanes.depth >= 0\n    lanes.nodes[ok] = 0",
    "synchronize": "torch.cuda.synchronize()",
    "print": "print(lanes.best)",
    "host-copy": "n = torch.tensor(0, device=lanes.idx.device)",
    "list-index": "n = lanes.inst[[0, 1]]",
    "list-index-columns": "n = lanes.idx[:, [0, 1]]",
    "with-item": "with helpers.count(int(lanes.nodes.sum())):\n        n = 1",
}

#: The same operations written without a sync.
CLEAN = """\
n = lanes.nodes.sum()
    first = torch.where(lanes.active, lanes.inst, -1)
    m = torch.repeat_interleave(lanes.inst, lanes.nodes, output_size=8)
    k = lanes.inst.repeat_interleave(2)
    w, il = lanes.idx.shape
    if lanes.idx.shape[0] > 0 and lanes.idx.dim() == 2:
        n = n + lanes.idx.numel()
    if lanes.best is None or isinstance(lanes.best, tuple):
        n = n + 1
    if lanes.idx.device.type == "cpu":
        n = int(lanes.nodes.sum())
    else:
        n = lanes.nodes.max()
    sel = lanes.inst[first, lanes.depth.clamp(0, il - 1)]
    cols = torch.stack((lanes.idx[:, 0], lanes.idx[:, 1]), dim=1)
    n = helpers.count(lanes)"""

HELPERS = {"src/repro_torch/core/helpers.py": """\
    def count(lanes):
        return lanes
    """}

#: A helper with no annotation on its parameter: the sync methods are
#: hazards whatever their receiver.
UNANNOTATED = {
    method: {"src/repro_torch/core/helpers.py": f"""\
    def count(lanes):
        return lanes.best.{method}()
    """} for method in ("item", "tolist", "cpu", "numpy")}


@pytest.mark.parametrize("hazard", sorted(HAZARDS))
def test_each_hazard_class_gives_one_finding(tmp_path, hazard):
    _tree(tmp_path, {STEAL: ROOT_MODULE.format(body=HAZARDS[hazard]),
                     **HELPERS})
    result = _lint(tmp_path, rules=["trace-safety"])
    f = _only(result, "trace-safety")
    assert f.path == STEAL
    assert "sync" in f.message or "copy" in f.message


@pytest.mark.parametrize("method", sorted(UNANNOTATED))
def test_a_sync_method_in_an_unannotated_helper_is_a_finding(tmp_path,
                                                             method):
    _tree(tmp_path, {STEAL: ROOT_MODULE.format(body="n = helpers.count("
                                                   "lanes)"),
                     **UNANNOTATED[method]})
    f = _only(_lint(tmp_path, rules=["trace-safety"]), "trace-safety")
    assert f.path == "src/repro_torch/core/helpers.py"
    assert f"`.{method}()`" in f.message


def test_clean_round_code_is_silent(tmp_path):
    _tree(tmp_path, {STEAL: ROOT_MODULE.format(body=CLEAN), **HELPERS})
    result = _lint(tmp_path)
    assert result.findings == [], [f.format() for f in result.findings]
    assert "repro_torch.core.steal:balance_device" in result.scanned
    assert "repro_torch.core.helpers:count" in result.scanned


def test_scope_follows_calls_into_other_modules(tmp_path):
    """The hazard sits in a helper reached by ``helpers.count`` and in a
    problem's ``evaluate_batch`` reached by ``problem.evaluate_batch``
    (a field of ``BinaryProblem``); the scalar mirror's ``evaluate`` of
    another class is not reached."""
    _tree(tmp_path, {
        STEAL: ROOT_MODULE.format(
            body="n = helpers.count(lanes)\n    "
                 "ev = helpers.run(problem, lanes)"),
        "src/repro_torch/core/helpers.py": """\
        import torch
        from repro_torch.core.api import BinaryProblem


        def count(lanes):
            return run(None, lanes)


        def run(problem: BinaryProblem, lanes):
            return problem.evaluate_batch(lanes, lanes)
        """,
        "src/repro_torch/core/api.py": """\
        class BinaryProblem:
            def __init__(self, evaluate_batch):
                self.evaluate_batch = evaluate_batch


        class PyProblem:
            def __init__(self, evaluate):
                self.evaluate = evaluate
        """,
        "src/repro_torch/problems/p.py": """\
        import torch
        from repro_torch.core.api import BinaryProblem, PyProblem


        def make(device):
            def evaluate_batch(states: torch.Tensor, best: torch.Tensor):
                return states.sum().item()

            return BinaryProblem(evaluate_batch=evaluate_batch)


        def make_py():
            def evaluate(state, best):
                return int(state.sum())

            return PyProblem(evaluate=evaluate)
        """})
    result = _lint(tmp_path, rules=["trace-safety"])
    f = _only(result, "trace-safety")
    assert f.path == "src/repro_torch/problems/p.py"
    assert "`.item()`" in f.message
    assert "repro_torch.problems.p:make.evaluate_batch" in result.scanned
    assert "repro_torch.problems.p:make_py.evaluate" not in result.scanned


def test_a_constructor_reaches_its_init_and_no_other(tmp_path):
    """``Box(lanes)`` scans ``Box.__init__``; its ``super().__init__()``
    does not pull in every ``__init__`` of the package."""
    _tree(tmp_path, {
        STEAL: ROOT_MODULE.format(body="box = helpers.Box(lanes)"),
        "src/repro_torch/core/helpers.py": """\
        import torch


        class Base:
            def __init__(self):
                self.ready = True


        class Box(Base):
            def __init__(self, lanes: torch.Tensor):
                super().__init__()
                self.best = lanes.best.tolist()


        class Other:
            def __init__(self, lanes: torch.Tensor):
                self.n = int(lanes.sum())
        """})
    result = _lint(tmp_path, rules=["trace-safety"])
    f = _only(result, "trace-safety")
    assert "`.tolist()`" in f.message
    assert "repro_torch.core.helpers:Box.__init__" in result.scanned
    assert "repro_torch.core.helpers:Other.__init__" not in result.scanned


def test_a_root_that_no_longer_resolves_is_a_finding(tmp_path):
    _tree(tmp_path, {STEAL: ROOT_MODULE.format(body="n = 1").replace(
        "def balance_device", "def balance_lanes"), **HELPERS})
    f = _only(_lint(tmp_path, rules=["trace-safety"]), "trace-safety")
    assert "repro_torch.core.steal:balance_device does not resolve" \
        in f.message


def test_a_missing_root_module_is_a_finding_for_the_whole_package(tmp_path):
    """Linting the package (its ``__init__`` analysed) requires every
    root, so a moved module cannot drop out of scope silently."""
    _tree(tmp_path, {"src/repro_torch/__init__.py": "",
                     STEAL: ROOT_MODULE.format(body="n = 1"), **HELPERS})
    result = _lint(tmp_path, rules=["trace-safety"])
    assert len(result.findings) == len(ROUND_LOOP_ROOTS) - 1
    assert all("does not resolve" in f.message for f in result.findings)


# ---------------------------------------------------------------------------
# kernel-contract
# ---------------------------------------------------------------------------

KMOD = "src/repro_torch/kernels/k.py"
KERNEL_HEAD = """\
import ctypes

from repro_torch.kernels import _build

_PTR, _INT = ctypes.c_void_p, ctypes.c_int


def run(rows, out, dev):
"""

KERNEL_CASES = {
    "argument-count": "    _build.launch('popcount_reduce', [_PTR] * 2 + "
                      "[_INT] * 2, [rows, out, 4], dev)\n",
    "argument-type": "    _build.launch('popcount_reduce', [_PTR] * 3 + "
                     "[_INT], [rows, out, 1, 4], dev)\n",
    "arity": "    _build.launch('popcount_reduce', [_PTR] * 2 + [_INT], "
             "[rows, out, 1], dev)\n",
    "unknown-kernel": "    _build.launch('nope', [_PTR], [rows], dev)\n",
    "unreadable-argtypes": "    _build.launch('popcount_reduce', "
                           "make_types(), [rows, out, 1, 4], dev)\n",
    "uncounted-launch": "    fn = _build.load('popcount_reduce')"
                        ".popcount_reduce_floor_launch\n"
                        "    fn.argtypes = [ctypes.c_int, ctypes.c_int, "
                        "ctypes.c_void_p]\n",
}


@pytest.mark.parametrize("case", sorted(KERNEL_CASES))
def test_kernel_contract_cases_give_one_finding(tmp_path, case):
    _tree(tmp_path, {KMOD: KERNEL_HEAD + KERNEL_CASES[case]})
    _only(_lint(tmp_path), "kernel-contract")


def test_kernel_contract_good_bindings_are_silent(tmp_path):
    _tree(tmp_path, {KMOD: KERNEL_HEAD + (
        "    _build.launch('popcount_reduce', [_PTR] * 2 + [_INT] * 2, "
        "[rows, out, 1, 4], dev)\n"
        "    # torch-lint: disable=kernel-contract -- timed, not counted\n"
        "    fn = _build.load('popcount_reduce').popcount_reduce_floor_launch"
        "\n    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]\n"
    )})
    result = _lint(tmp_path)
    assert result.findings == [], [f.format() for f in result.findings]


def test_a_wrong_direct_binding_is_caught_through_its_suppression(tmp_path):
    """The suppression on the fetch covers the uncounted launch only; a
    wrong ``argtypes`` on the next line is still a finding."""
    _tree(tmp_path, {KMOD: KERNEL_HEAD + (
        "    # torch-lint: disable=kernel-contract -- timed, not counted\n"
        "    fn = _build.load('popcount_reduce').popcount_reduce_floor_launch"
        "\n    fn.argtypes = [ctypes.c_int, ctypes.c_void_p]\n")})
    f = _only(_lint(tmp_path), "kernel-contract")
    assert "popcount_reduce_floor_launch" in f.message


BUILD = "src/repro_torch/kernels/_build.py"


def _build_copy(tmp_path, old, new):
    text = (ROOT / BUILD).read_text()
    assert old in text
    _tree(tmp_path, {BUILD: text.replace(old, new)})
    return _lint(tmp_path, rules=["kernel-contract"])


def test_a_kernel_without_its_parts_is_a_finding(tmp_path):
    name = "orph" + "aned"      # spelt apart: no test file may name it
    f = _only(_build_copy(tmp_path, '"ssd_scan")',
                          f'"ssd_scan", "{name}")'), "kernel-contract")
    for part in (f"{name}.cu", f"def {name}", f"{name}_ref", "parity test",
                 f'kernel_entry("{name}"'):
        assert part in f.message, f.message


def test_a_source_outside_kernels_is_a_finding(tmp_path):
    f = _only(_build_copy(tmp_path, ', "ssd_scan")', ")"), "kernel-contract")
    assert "ssd_scan.cu is not in _build.KERNELS" in f.message


def test_ground_truth_comes_from_the_linted_checkout_alone(tmp_path):
    """A tree that lacks a kernel's source and the parity tests is not
    filled in from the checkout this package lives in."""
    _tree(tmp_path, {})
    (tmp_path / "src/repro_torch/kernels/csrc/ssd_scan.cu").unlink()
    for test in (tmp_path / "tests").glob("test_torch_*.py"):
        test.unlink()
    result = _lint(tmp_path, BUILD)
    kernels = re.findall(r"kernel '(\w+)' lacks",
                         " ".join(f.message for f in result.findings))
    assert [f.rule for f in result.findings] == ["kernel-contract"] * 6
    assert sorted(kernels) == sorted(
        p.stem for p in (ROOT / "src/repro_torch/kernels/csrc").glob("*.cu"))
    assert all("parity test" in f.message for f in result.findings)
    assert [f for f in result.findings
            if "kernels/csrc/ssd_scan.cu" in f.message] != []


def test_the_build_must_target_sm_90a(tmp_path):
    f = _only(_build_copy(tmp_path, "compute_90a,code=sm_90a",
                          "compute_80,code=sm_80"), "kernel-contract")
    assert "sm_90a" in f.message


def test_a_blocking_call_in_a_launcher_is_a_finding(tmp_path):
    rel = "src/repro_torch/kernels/csrc/popcount_reduce.cu"
    text = (ROOT / rel).read_text()
    old = "  const Grid g = grid_of(lanes, w);\n"
    assert text.count(old) == 2
    _tree(tmp_path, {rel: text.replace(
        old, old + "  cudaDeviceSynchronize();\n", 1)})
    f = _only(_lint(tmp_path, BUILD), "kernel-contract")
    assert "popcount_reduce.cu:" in f.message
    assert "cudaDeviceSynchronize" in f.message


def test_c_signature_reads_each_launcher():
    src = (ROOT / "src/repro_torch/kernels/csrc/flash_attention.cu")
    assert c_signature(src.read_text(), "flash_attention_launch") == (
        ["c_void_p"] * 4 + ["c_int"] * 7 + ["c_float"] * 2 + ["c_void_p"])
    assert c_signature("int f(int);", "f") is None


# ---------------------------------------------------------------------------
# planted faults in copies of real files
# ---------------------------------------------------------------------------

PLANTED = {
    "item-in-step": ("src/repro_torch/core/engine.py",
                     "        w, il = lanes.idx.shape\n",
                     "        w, il = lanes.idx.shape\n"
                     "        lanes.steps.item()\n",
                     "trace-safety"),
    "c_int-for-softcap": ("src/repro_torch/kernels/flash_attention.py",
                          "[ctypes.c_int] * 7\n"
                          "             + [ctypes.c_float] * 2)",
                          "[ctypes.c_int] * 8\n"
                          "             + [ctypes.c_float] * 1)",
                          "kernel-contract"),
}


def _plant(tmp_path, case):
    rel, old, new, rule = PLANTED[case]
    text = (ROOT / rel).read_text()
    assert text.count(old) == 1, case
    _tree(tmp_path, {rel: text.replace(old, new)})
    return rel, rule


@pytest.mark.parametrize("case", sorted(PLANTED))
def test_planted_fault_gives_one_finding(tmp_path, case):
    rel, rule = _plant(tmp_path, case)
    f = _only(_lint(tmp_path, rel), rule)
    if case == "c_int-for-softcap":
        assert "argument 12 is c_int in Python but c_float" in f.message


@pytest.mark.parametrize("case", sorted(PLANTED))
def test_unplanted_copy_is_clean(tmp_path, case):
    rel, old, _, _ = PLANTED[case]
    _tree(tmp_path, {rel: (ROOT / rel).read_text()})
    result = _lint(tmp_path, rel)
    assert result.findings == [], [f.format() for f in result.findings]


# ---------------------------------------------------------------------------
# telemetry-schema and api-hygiene
# ---------------------------------------------------------------------------

TELEMETRY = {
    "emit": 'emit(cb, "warp", round=1)',
    "_emit": 'self._emit("finished", rid=1)',
    "ProgressEvent": 'ProgressEvent(kind="bogus", round=0)',
    "trace-kind": 'self.trace.write("nope", round=1)',
    "trace-fields": 'trace.write("incumbent", round=1, inst=0)',
    "lifecycle": 'col.lifecycle("gone", round_no=1, rid=0)',
    "_note_lifecycle": 'self._note_lifecycle("gone", 3)',
}
TELEMETRY_GOOD = """\
def f(self, cb, col, trace, kind):
    emit(cb, "round", round=1)
    self._emit("retire", rid=1)
    ProgressEvent(kind="done", round=0)
    trace.write("incumbent", round=1, inst=0, best=3)
    trace.write("round", **fields)
    trace.write(kind, round=1)
    col.lifecycle("admit", round_no=1, rid=0)
    self._note_lifecycle("expire", 3)
    open("x").write("anything")
"""


@pytest.mark.parametrize("shape", sorted(TELEMETRY))
def test_telemetry_shapes_give_one_finding(tmp_path, shape):
    _tree(tmp_path, {"src/repro_torch/t.py":
                     f"def f(self, cb, col, trace):\n    {TELEMETRY[shape]}\n"})
    f = _only(_lint(tmp_path), "telemetry-schema")
    assert "unknown" in f.message or "missing required" in f.message


def test_telemetry_good_calls_are_silent(tmp_path):
    _tree(tmp_path, {"src/repro_torch/t.py": TELEMETRY_GOOD})
    assert _lint(tmp_path).findings == []


DEPRECATIONS = {
    "stacklevel": 'warnings.warn("x is deprecated", DeprecationWarning)',
    "message": 'warnings.warn("use y", DeprecationWarning, stacklevel=2)',
}


@pytest.mark.parametrize("case", sorted(DEPRECATIONS))
def test_deprecation_clauses_give_one_finding(tmp_path, case):
    _tree(tmp_path, {"src/repro_torch/d.py":
                     f"import warnings\n{DEPRECATIONS[case]}\n"})
    _only(_lint(tmp_path), "api-hygiene")


def test_well_formed_deprecation_is_silent(tmp_path):
    _tree(tmp_path, {"src/repro_torch/d.py": (
        "import warnings\nwarnings.warn('x is deprecated; use y', "
        "DeprecationWarning, stacklevel=2)\n")})
    assert _lint(tmp_path).findings == []


def _surface_repo(tmp_path, snapshot):
    return _tree(tmp_path, {
        "src/repro_torch/obs/__init__.py": '__all__ = ["Ghost"]\nGhost = 1\n',
        "src/repro_torch/analysis/api_surface.py":
            'MODULES = ("repro_torch.obs",)\n',
        "src/repro_torch/analysis/api_surface.txt": snapshot})


@pytest.mark.parametrize("snapshot,expect", [
    ("module repro_torch.obs\n  const Real = 1\n", "missing from"),
    ("module repro_torch.other\n", "no section"),
    ("module repro_torch.obs\n  const Ghost = 1\n", None),
], ids=["export-missing", "section-missing", "synced"])
def test_snapshot_clause(tmp_path, snapshot, expect):
    root = _surface_repo(tmp_path, snapshot)
    result = _lint(root, rules=["api-hygiene"])
    if expect is None:
        assert result.findings == []
    else:
        assert expect in _only(result, "api-hygiene").message


# ---------------------------------------------------------------------------
# suppressions and the two markers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("line,expect", [
    ("n = int(lanes.nodes.sum())  # torch-lint: disable=trace-safety -- "
     "the test's own sync", None),
    ("n = int(lanes.nodes.sum())  # torch-lint: disable=trace-safety",
     "missing its reason"),
    ("n = 1  # torch-lint: disable=no-such-rule -- because",
     "unknown rule"),
], ids=["with-reason", "without-reason", "unknown-rule"])
def test_suppressions(tmp_path, line, expect):
    _tree(tmp_path, {STEAL: ROOT_MODULE.format(body=line), **HELPERS})
    result = _lint(tmp_path)
    if expect is None:
        assert result.findings == []
    else:
        assert expect in _only(result, "suppression").message


def test_the_reference_marker_does_not_silence_the_port(tmp_path):
    _tree(tmp_path, {STEAL: ROOT_MODULE.format(
        body="n = int(lanes.nodes.sum())  # repro-lint: disable="
             "trace-safety -- the reference's marker"), **HELPERS})
    _only(_lint(tmp_path), "trace-safety")


def test_the_port_marker_is_invisible_to_the_reference(tmp_path):
    from repro.analysis import lint_paths as reference_lint
    src = tmp_path / "mod.py"
    src.write_text("x = 1  # torch-lint: disable=trace-safety -- a reason\n"
                   "y = 2  # torch-lint: disable=kernel-contract\n")
    assert reference_lint([str(src)], root=tmp_path).findings == []


# ---------------------------------------------------------------------------
# the whole port, the CLI, the import
# ---------------------------------------------------------------------------

def test_the_whole_port_is_clean():
    result = lint_paths()
    assert result.errors == [], [f.format() for f in result.errors]
    files = sorted((ROOT / "src/repro_torch").rglob("*.py"))
    assert result.files == len(files) + 1          # and chip_smoke.py
    assert set(ROUND_LOOP_ROOTS) <= set(result.scanned)
    for reached in ("repro_torch.kernels.bitset_ops:count_stats",
                    "repro_torch.kernels.bitset_ops:stacked_count_stats",
                    "repro_torch.kernels._build:launch",
                    "repro_torch.core.api:BinaryProblem.apply",
                    "repro_torch.service.batch_problem:"
                    "StackedSpec.stats_inputs"):
        assert reached in result.scanned, reached


def _cli(*args, root=ROOT):
    """The CLI of the analysis package under ``root/src``: it lints, and
    reads its ground truth from, the checkout it lives in."""
    return subprocess.run([sys.executable, "-m", "repro_torch.analysis",
                           *args], cwd=root,
                          env=dict(ENV, PYTHONPATH=str(root / "src")),
                          capture_output=True, text=True, timeout=120)


def test_cli_clean_tree_exits_zero():
    proc = _cli()
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert re.search(r"lint: \d+ files, 0 error\(s\)", proc.stdout)


@pytest.mark.parametrize("case", sorted(PLANTED))
def test_cli_planted_fault_exits_one_with_json(tmp_path, case):
    tree = tmp_path / "tree"
    rel, rule = _plant(tree, case)
    package = "src/repro_torch/analysis"
    (tree / package).mkdir(parents=True, exist_ok=True)
    (tree / "src/repro_torch/__init__.py").write_text("")
    _copy(tree, [str(p.relative_to(ROOT))
                 for p in sorted((ROOT / package).glob("*.py"))])
    out = tmp_path / "findings.json"
    proc = _cli(rel, "--json", str(out), root=tree)
    assert proc.returncode == 1, proc.stdout + proc.stderr
    payload = json.loads(out.read_text())
    assert payload["errors"] == 1
    assert [f["rule"] for f in payload["findings"]] == [rule]
    if rule == "trace-safety":
        assert "repro_torch.core.engine:make_step.step" in payload["scanned"]


def test_cli_list_rules_and_unknown_rule():
    proc = _cli("--list-rules")
    assert proc.returncode == 0
    for rule in ("trace-safety", "kernel-contract", "telemetry-schema",
                 "api-hygiene"):
        assert rule in proc.stdout
    assert _cli("--rule", "no-such-rule").returncode == 2


def test_registry_has_the_four_packs():
    assert {"trace-safety", "kernel-contract", "telemetry-schema",
            "api-hygiene"} == set(all_rules())


def test_analysis_imports_and_runs_without_torch():
    code = ("import sys\n"
            "for name in ('torch', 'numpy', 'jax', 'repro'):\n"
            "    sys.modules[name] = None\n"
            "from repro_torch.analysis import lint_paths\n"
            "result = lint_paths()\n"
            "assert result.errors == [], result.errors\n"
            "assert not any(m.split('.')[0] in ('torch', 'numpy') for m in "
            "sys.modules if sys.modules[m] is not None)\n"
            "print(result.files)\n")
    proc = subprocess.run([sys.executable, "-c", code], env=ENV,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout) > 40


# ---------------------------------------------------------------------------
# the API snapshot
# ---------------------------------------------------------------------------

SNAPSHOT = ROOT / "src/repro_torch/analysis/api_surface.txt"


def _surface(*args):
    return subprocess.run([sys.executable, "-m",
                           "repro_torch.analysis.api_surface", *args],
                          env=ENV, capture_output=True, text=True,
                          timeout=300)


def test_snapshot_matches_and_drift_is_caught(tmp_path):
    proc = _surface()
    assert proc.returncode == 0, proc.stderr
    drifted = tmp_path / "api_surface.txt"
    drifted.write_text(SNAPSHOT.read_text().replace(
        "def emit(", "def emitted("))
    proc = _surface("--snapshot", str(drifted))
    assert proc.returncode == 1
    assert "PUBLIC API CHANGED" in proc.stderr and "+  def emit(" in \
        proc.stderr
    fresh = tmp_path / "fresh.txt"
    assert _surface("--update", "--snapshot", str(fresh)).returncode == 0
    assert fresh.read_text() == SNAPSHOT.read_text()


def _members(text):
    """{module suffix: {exported name: {fields, methods()}}} of a
    snapshot; the module prefix (repro / repro_torch) dropped."""
    out, cur = {}, None
    for line in text.splitlines():
        if line.startswith("module "):
            mod = line[len("module "):].split(".", 1)[1]
            out[mod] = {}
            continue
        m = re.match(r"^  (def|const|dataclass|namedtuple|class)\s+(\w+)(.*)",
                     line)
        if m:
            kind, name, rest = m.groups()
            cur = out[mod].setdefault(name, set())
            if kind in ("dataclass", "namedtuple"):
                body = re.sub(r"\[[^\[\]]*\]", "", rest)
                while "[" in body:
                    body = re.sub(r"\[[^\[\]]*\]", "", body)
                cur.update(f.split(":")[0].strip() for f in
                           body[body.index("(") + 1:body.rindex(")")]
                           .split(",") if f.strip())
            continue
        m = re.match(r"^    (?:def|property|classmethod|staticmethod)\s+"
                     r"(\w+)", line)
        if m and cur is not None:
            cur.add(m.group(1) + "()")
    return out


#: Where the port's surface differs from the reference's, and why:
#: (module, name, member or None for the whole name) -> reason.
SURFACE_DIFFERENCES = {
    ("registry", "ProblemSpec", "backends"):
        "the tensors' device picks kernel or plain version: no backends",
    ("registry", "problem_backends", None):
        "the tensors' device picks kernel or plain version: no backends",
    ("solver", "SolverConfig", "backend"): "backend became device",
    ("solver", "SolverConfig", "device"): "backend became device",
    ("service", "STACKED_BACKENDS", None): "backend became device",
    ("service", "StackedSpec", "stats_inputs()"):
        "the stacked pass's operands, shared by evaluate_batch and the "
        "smoke's timing of the kernel on the service's live inputs",
    ("analysis", "LintResult", "skipped"):
        "the port's lint has no file allowlist",
    ("analysis", "LintResult", "scanned"):
        "the round loop's scanned functions, so a test can see the scope",
    ("analysis", "RepoContext", "corpus()"):
        "kernel-contract reads tests/ for each kernel's parity test",
    ("obs", "Span", None):
        "host-time spans of the port's round and service loops, beside the "
        "reference's trace schema",
    ("obs", "SpanRecorder", None):
        "host-time spans of the port's round and service loops, beside the "
        "reference's trace schema",
}


#: Front-door modules of the port that the reference's snapshot lacks.
PORT_ONLY_MODULES = {
    "serve": "the LM serving entry points (Request, BatchedServer, the step "
             "factories); the reference snapshots its solver front door "
             "only",
    "train": "the LM training entry points (AdamW, the step factory); the "
             "reference snapshots its solver front door only",
    "roofline": "the dry run's counter (analyze, the roofline and memory "
                "counts); the reference snapshots its solver front door "
                "only",
}


def test_the_port_surface_equals_the_reference_but_named_differences():
    ref = _members((ROOT / "tools/api_surface.txt").read_text())
    port = _members(SNAPSHOT.read_text())
    assert set(port) - set(ref) == set(PORT_ONLY_MODULES)
    assert set(ref) <= set(port)
    found = set()
    for mod in ref:
        for name in set(ref[mod]) | set(port[mod]):
            if name not in ref[mod] or name not in port[mod]:
                found.add((mod, name, None))
                continue
            found.update((mod, name, m) for m in ref[mod][name]
                         ^ port[mod][name])
    assert found == set(SURFACE_DIFFERENCES), sorted(
        found ^ set(SURFACE_DIFFERENCES), key=str)


def test_every_export_is_in_the_snapshot():
    sections = parse_snapshot(SNAPSHOT.read_text())
    import repro_torch.analysis as analysis
    import repro_torch.obs as obs
    import repro_torch.serve as serve
    import repro_torch.train as train
    for mod in (analysis, obs, serve, train):
        assert set(mod.__all__) == sections[mod.__name__]


# ---------------------------------------------------------------------------
# kernels/_build.py: one binding per kernel
# ---------------------------------------------------------------------------

def test_a_second_binding_with_other_argtypes_raises(monkeypatch):
    from repro_torch.kernels import _build
    bound = (ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p)
    stub = types.SimpleNamespace(argtypes=bound)
    monkeypatch.setitem(_build._ENTRY, "popcount_reduce", stub)
    assert _build._entry("popcount_reduce",
                         [ctypes.c_void_p, ctypes.c_int]) is stub
    with pytest.raises(ValueError, match="popcount_reduce_launch is bound"):
        _build._entry("popcount_reduce", [ctypes.c_void_p, ctypes.c_float])

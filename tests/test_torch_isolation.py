"""The PyTorch port stands alone: ``repro_torch`` and ``chip_smoke.py``
import neither ``jax`` nor the JAX package ``repro``."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, (node.module or "").split(".")[0]


def test_port_sources_import_no_jax_or_reference():
    files = _port_files()
    assert len(files) > 15, files
    for new in ("core/checkpoint.py", "service/__init__.py",
                "service/batch_problem.py", "service/driver.py",
                "service/scheduler.py", "service/ticket.py",
                "launch/serve_solver.py"):
        assert PORT / new in files, new
    bad = [f"{p.relative_to(ROOT)}:{line} imports {root}"
           for p in files for line, root in _imported_roots(p)
           if root in FORBIDDEN]
    assert not bad, bad


@pytest.mark.parametrize("module", [
    "repro_torch.solver",
    "repro_torch.launch.solve",
    "repro_torch.kernels.bitset_degree",
    "repro_torch.core.checkpoint",
    "repro_torch.service",
    "repro_torch.launch.serve_solver",
])
def test_port_imports_with_jax_blocked(module):
    """A fresh interpreter with ``jax`` and ``repro`` made unimportable
    still imports the port and registers its problem families."""
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[name] = None\n"
        f"import {module}\n"
        "from repro_torch import registry\n"
        "assert registry.names() == ('ds', 'vc'), registry.names()\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.'))\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """Without CUDA the smoke exits non-zero and prints no result line."""
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          cwd=tmp_path, capture_output=True, text=True,
                          timeout=120,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout

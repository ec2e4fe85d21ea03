"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C entry point.  At first use it is
compiled with ``nvcc`` for ``sm_90a`` into ``kernels/build/`` (listed in
``.gitignore``), under a file name keyed by a hash of the source and the
flags, and loaded with ``ctypes``.  Nothing here runs at import time:
the CPU-only tests import every module of the port.

Every wrapper launches its kernel through ``launch``, which counts the
launch in ``LAUNCHES``: a run can show that its path went through the
kernels.  A launch of a kernel with two routes counts once more, under
``<kernel>.<route>``; ``LAUNCHES`` also holds ``stack_push_bytes``, the
bytes the engine steps' stack clones allocate and write
(``core/engine.py``).  So only the names in ``KERNELS`` are launches.
On ``meta`` tensors (a dry run) a wrapper takes the same route and
allocates the same outputs, but calls ``abstract`` in place of
``launch``: nothing runs, nothing is counted in ``LAUNCHES``, and the
kernel's cost goes to ``roofline.analyze``'s counter.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
from typing import Callable, Dict, Optional, Sequence

import torch

from repro_torch import roofline
from repro_torch.kernels import autotune

#: The port's CUDA kernels, one ``csrc/<name>.cu`` each.
KERNELS = ("count_stats", "stacked_count_stats", "popcount_reduce",
           "masked_row_reduce", "flash_attention", "ssd_scan")

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: Dict[str, ctypes.CDLL] = {}
_ENTRY: Dict[str, Callable] = {}

#: The kernels with two routes (``autotune.ROUTES``), the route a
#: wrapper passes to :func:`launch`.
ROUTED = ("count_stats", "stacked_count_stats")

#: Launches of each kernel, and of each routed kernel by route
#: (``count_stats.wide``), since the last ``reset_launches()``; and
#: ``stack_push_bytes``, which is no launch.
LAUNCHES: Dict[str, int] = dict.fromkeys(
    KERNELS + tuple(f"{k}.{r}" for k in ROUTED for r in autotune.ROUTES)
    + ("stack_push_bytes",), 0)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                       "machine with the card (PATH or /usr/local/cuda/bin)")


def library_path(name: str) -> pathlib.Path:
    """Where ``csrc/<name>.cu`` is built, keyed by source and flags."""
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(name: str) -> pathlib.Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built.

    The compiler's report (``-Xptxas -v``: registers, spills) is kept
    beside the library as ``<lib>.log``.  The library is written to a
    temporary file and renamed, so concurrent builders never load a
    half-written file.
    """
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")],
            capture_output=True, text=True, check=False)
        pathlib.Path(str(out) + ".log").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}.cu:\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        _LOADED[name] = lib
    return lib


def _entry(name: str, argtypes: Sequence) -> Callable:
    """``<name>_launch`` of ``csrc/<name>.cu``, built and bound at first
    use: ``argtypes`` (``c_void_p`` for each device pointer, ``c_int``,
    ``c_float``), then the stream; it returns the CUDA error code.  A
    later call with other ``argtypes`` raises ``ValueError``: ctypes
    would pass its arguments through the first binding."""
    want = (*argtypes, ctypes.c_void_p)
    fn = _ENTRY.get(name)
    if fn is None:
        fn = getattr(load(name), f"{name}_launch")
        fn.argtypes = want
        fn.restype = ctypes.c_int
        _ENTRY[name] = fn
    elif tuple(fn.argtypes) != want:
        raise ValueError(f"{name}_launch is bound to argtypes "
                         f"{list(fn.argtypes)}, called with {list(want)}")
    return fn


class LaunchError(RuntimeError):
    """A kernel's launcher returned CUDA error ``code``."""

    def __init__(self, name: str, code: int):
        super().__init__(f"{name} launch failed: CUDA error {code}")
        self.code = code


def launch(name: str, argtypes: Sequence, args: Sequence, device,
           route: Optional[str] = None) -> None:
    """Launch the kernel of ``csrc/<name>.cu`` on the current stream of
    ``device`` (a CUDA device), raise ``LaunchError`` if it returns a CUDA
    error, and count the launch, under ``<name>.<route>`` too when the
    wrapper names the ``route`` it took.  The launcher runs with
    ``device`` as the current card, so shards of a mesh on other cards
    launch there."""
    device = torch.device(device)
    stream = torch.cuda.current_stream(device).cuda_stream
    fn = _entry(name, argtypes)
    if (device.index is not None
            and device.index != torch.cuda.current_device()):
        with torch.cuda.device(device):
            err = fn(*args, stream)
    else:
        err = fn(*args, stream)
    if err != 0:
        raise LaunchError(name, err)
    LAUNCHES[name] += 1
    if route is not None:
        LAUNCHES[f"{name}.{route}"] += 1


def abstract(name: str, cost) -> None:
    """The abstract form of a launch of ``csrc/<name>.cu`` on ``meta``
    tensors (the counterpart of a Pallas call's ``out_shape``): the
    wrapper has allocated the outputs; this records ``cost`` (an
    ``autotune.KernelCost``) with the dry run's counter, if one is
    active.  ``LAUNCHES`` is unchanged."""
    roofline.record_kernel(name, cost)

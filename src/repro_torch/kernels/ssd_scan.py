"""The Mamba-2 SSD chunk scan (counterpart of ``repro.kernels.ssd_scan``).

``ssd_scan`` dispatches by the device of its tensors: on CUDA tensors it
launches the hand-written Hopper kernel ``csrc/ssd_scan.cu`` (or raises),
on CPU tensors it runs the plain version, ``models.ssm.ssd_chunked``.
There is no fallback from one to the other.  The kernel takes any S (a
ragged last chunk is zero-padded, which is exact), chunks up to 128 whose
working set fits the card's shared memory, and the configs' head widths,
P up to 64.  Its three passes (each chunk's own state, the carry from
chunk to chunk, the output) go through one C entry point, one launch;
the wrapper allocates the chunks' states between the passes.

On ``meta`` tensors (a dry run, ``roofline.analyze``) the wrapper takes
the card's route with the launch replaced by its abstract form: y, the
state and the chunks' f32 states are allocated, ``cost`` is recorded,
and nothing runs.

On the card the kernel's outputs are made differentiable by
``plain_grad.PlainGrad`` when grad mode is on and an input requires grad
(training): the forward is the kernel, the backward PyTorch's gradient of
the plain version recomputed from the saved inputs (only through the
outputs that receive a gradient: train mode uses y, not the state).  The
plain version never gives a forward value on the card; it enters there
only inside that backward.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import _build, autotune, ref
from repro_torch.kernels.plain_grad import PlainGrad

#: Largest chunk and head width (P) the CUDA kernel takes.
MAX_CHUNK = 128
MAX_P = 64
#: ``cudaErrorInvalidValue``: what the launcher returns for a chunk whose
#: working set does not fit.
CUDA_ERROR_INVALID_VALUE = 1

_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8


def _check(x, dt, a, b, c, d) -> None:
    if x.dim() != 4 or dt.dim() != 3 or b.dim() != 4 or b.shape != c.shape \
            or a.dim() != 1 or d.dim() != 1:
        raise ValueError("ssd_scan wants x [B, S, H, P], dt [B, S, H], a and "
                         "d [H], b and c [B, S, G, N]")
    bsz, s, h, _ = x.shape
    g = b.shape[2]
    if tuple(dt.shape) != (bsz, s, h) or tuple(b.shape[:2]) != (bsz, s) \
            or a.shape[0] != h or d.shape[0] != h or g < 1 or h % g:
        raise ValueError(f"ssd_scan: shapes do not match: x {tuple(x.shape)}"
                         f", dt {tuple(dt.shape)}, a {tuple(a.shape)}, b/c "
                         f"{tuple(b.shape)}, d {tuple(d.shape)} (H must be a "
                         f"multiple of G)")
    if x.dtype not in (torch.float32, torch.bfloat16) or \
            b.dtype != x.dtype or c.dtype != x.dtype:
        raise TypeError(f"ssd_scan takes float32 or bfloat16 x, b, c of one "
                        f"type, got {x.dtype}, {b.dtype}, {c.dtype}")
    for name, t in (("dt", dt), ("a", a), ("d", d)):
        if t.dtype != torch.float32:
            raise TypeError(f"ssd_scan: {name} must be float32, got "
                            f"{t.dtype}")
    if any(t.device != x.device for t in (dt, a, b, c, d)):
        raise ValueError("ssd_scan: operands on more than one device")


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, d: torch.Tensor,
             chunk: int = 64) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, H, P]; dt: [B, S, H] (f32, post-softplus); a, d: [H] f32;
    b, c: [B, S, G, N].  Returns (y [B, S, H, P] in x's dtype, final
    state [B, H, N, P] f32).  Head h reads B/C group h // (H / G)."""
    _check(x, dt, a, b, c, d)
    plain = functools.partial(ref.ssd_scan_ref, chunk=chunk)
    if x.device.type == "cpu":
        return plain(x, dt, a, b, c, d)
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"ssd_scan has no kernel for {x.device}")
    kernel = functools.partial(_kernel, chunk=chunk)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, a, b, c, d)):
        return PlainGrad.apply(kernel, plain, x, dt, a, b, c, d)
    return kernel(x, dt, a, b, c, d)


def cost(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
         b: torch.Tensor, c: torch.Tensor, d: torch.Tensor,
         chunk: int = 64) -> autotune.KernelCost:
    """The work of one launch: per chunk and head, the lower triangle of
    C B^T and of its product with x, C S and the state update, at the
    tensor cores' rate for x's dtype (the CUDA cores' for float32); each
    input read once, y and the final state written once."""
    bsz, s, h, p = x.shape
    n = b.shape[3]
    tri = chunk * (chunk + 1) // 2
    chunks = -(-s // chunk)
    flops = bsz * h * chunks * (2 * tri * n + 2 * tri * p + 4 * chunk * n * p)
    nbytes = sum(t.numel() * t.element_size() for t in (x, dt, a, b, c, d))
    nbytes += x.numel() * x.element_size() + 4 * bsz * h * n * p
    return autotune.KernelCost(flops, flops / autotune.PEAK_FLOPS[x.dtype],
                               nbytes)


def _kernel(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
            b: torch.Tensor, c: torch.Tensor, d: torch.Tensor,
            chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The CUDA kernel's launch on CUDA tensors (its abstract form on
    ``meta`` tensors)."""
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    if not 1 <= chunk <= MAX_CHUNK or p > MAX_P:
        raise ValueError(f"ssd_scan kernel takes chunk <= {MAX_CHUNK} and "
                         f"P <= {MAX_P}, got chunk={chunk}, P={p}")
    x, dt, a, b, c, d = (t.contiguous() for t in (x, dt, a, b, c, d))
    y = torch.empty_like(x)
    state = torch.empty((bsz, h, n, p), dtype=torch.float32,
                        device=x.device)
    # Each chunk's state [N, P] and its total decay, per (batch, head).
    chunks = -(-s // chunk)
    scratch = torch.empty((bsz * h * chunks * (n * p + 1),),
                          dtype=torch.float32, device=x.device)
    if x.device.type == "meta":
        _build.abstract("ssd_scan", cost(x, dt, a, b, c, d, chunk))
        return y, state
    try:
        _build.launch("ssd_scan", _ARGTYPES,
                      [x.data_ptr(), dt.data_ptr(), a.data_ptr(),
                       b.data_ptr(), c.data_ptr(), d.data_ptr(),
                       y.data_ptr(), state.data_ptr(), scratch.data_ptr(),
                       bsz, s, h, p, g, n, chunk,
                       int(x.dtype == torch.bfloat16)], x.device)
    except _build.LaunchError as exc:
        # The launcher opts each pass into the shared memory that chunk,
        # N and P need; the card refuses more than its limit per block.
        if exc.code != CUDA_ERROR_INVALID_VALUE:
            raise
        raise ValueError(f"ssd_scan kernel: chunk={chunk}, N={n}, P={p} "
                         f"needs more shared memory than the card gives a "
                         f"block") from exc
    return y, state

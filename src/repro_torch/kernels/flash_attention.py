"""Causal flash attention (counterpart of ``repro.kernels.flash_attention``).

``flash_attention`` dispatches by the device of its tensors: on CUDA
tensors it launches a hand-written Hopper kernel of
``csrc/flash_attention.cu`` (or raises), on CPU tensors it runs the plain
version, ``models.attention.blocked_attention``.  There is no fallback
from one to the other.  On the card the dtype picks the kernel: bfloat16
runs the ``wgmma`` + TMA kernel, float32 the CUDA-core kernel.  Both take
any S (a ragged last tile is masked) and are built for the head dims of
``HEAD_DIMS``; the wrapper takes every head dim up to the largest of them
by zero-padding q, k and v along hd to the next built one (zero columns
change neither q . k nor the kept columns of p . v) and slicing the
output back, the scale still 1/sqrt of the true hd.

On ``meta`` tensors (a dry run, ``roofline.analyze``) the wrapper takes
the card's route with the launch replaced by its abstract form: the
padded copies and the output are allocated, ``cost`` is recorded, and
nothing runs.

On the card the kernel's output is made differentiable by
``plain_grad.PlainGrad`` when grad mode is on and an input requires grad
(training): the forward is the kernel, the backward PyTorch's gradient of
the plain version recomputed from the saved inputs.  The plain version
never gives a forward value on the card; it enters there only inside that
backward.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from repro_torch.kernels import _build, autotune, ref
from repro_torch.kernels.plain_grad import PlainGrad

#: Head dims the CUDA kernel is built for: those of the repo's model
#: configurations (src/repro/configs).  Smaller head dims are padded up to
#: the next one; more than the last is refused.
HEAD_DIMS = (64, 80, 128)

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
             + [ctypes.c_float] * 2)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention wants q [B, S, H, hd] and k, v "
                         f"[B, S, G, hd], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, s, h, hd = q.shape
    g = k.shape[2]
    if (k.shape[0], k.shape[1], k.shape[3]) != (b, s, hd) or g < 1 \
            or h % g:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not "
                         f"match k/v {tuple(k.shape)} (H must be a multiple "
                         f"of G)")
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16 q, k, v "
                        f"of one type, got {q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention: q on {q.device}, k on "
                         f"{k.device}, v on {v.device}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: Optional[int] = None, softcap: float = 0.0,
                    query_scale: Optional[float] = None,
                    block_q: int = 128, block_k: int = 128) -> torch.Tensor:
    """q: [B, S, H, hd]; k, v: [B, S, G, hd] -> [B, S, H, hd] in q's dtype:
    causal attention, head h reading KV head h // (H / G), with an
    optional sliding ``window`` and tanh ``softcap``; ``query_scale``
    replaces 1/sqrt(hd).  ``block_q`` / ``block_k`` are the plain
    version's blocks (the CPU, and the card's backward): the CUDA kernels
    have their own tiles and ignore them."""
    _check(q, k, v)
    plain = functools.partial(ref.flash_attention_ref, window=window,
                              softcap=softcap, query_scale=query_scale,
                              block_q=block_q, block_k=block_k)
    if q.device.type == "cpu":
        return plain(q, k, v)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"flash_attention has no kernel for {q.device}")
    kernel = functools.partial(_kernel, window=window, softcap=softcap,
                               query_scale=query_scale)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v)):
        return PlainGrad.apply(kernel, plain, q, k, v)
    return kernel(q, k, v)


def causal_pairs(s: int, window: Optional[int] = None) -> int:
    """Visible (query, key) pairs of causal attention over ``s``
    positions, with an optional sliding ``window``."""
    if window is None or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def cost(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
         window: Optional[int] = None, softcap: float = 0.0,
         sms: int = autotune.SMS,
         clock_hz: float = autotune.SM_CLOCK_HZ) -> autotune.KernelCost:
    """The work of one launch on (q, k, v): two products of hd per
    visible pair (q k^T and p v, 4 hd FLOPs) at the tensor cores' rate
    for q's dtype (the CUDA cores' for float32), an exp per pair on the
    SFU (and a tanh with a softcap); q, k and v read once and the output
    written once.  ``sms`` and ``clock_hz`` set the SFU's rate (the
    data sheet's by default)."""
    b, s, h, hd = q.shape
    pairs = b * h * causal_pairs(s, window)
    flops = 4 * hd * pairs
    sfu = autotune.issue_s(pairs * (2 if softcap else 1),
                           autotune.SFU_PER_CLOCK_PER_SM, sms, clock_hz)
    op_s = max(flops / autotune.PEAK_FLOPS[q.dtype], sfu)
    return autotune.KernelCost(
        flops, op_s, q.element_size() * (2 * q.numel() + k.numel()
                                         + v.numel()))


def _kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            window: Optional[int], softcap: float,
            query_scale: Optional[float]) -> torch.Tensor:
    """The CUDA kernel's launch on CUDA tensors (its abstract form on
    ``meta`` tensors)."""
    work = cost(q, k, v, window=window, softcap=softcap)
    b, s, h, hd = q.shape
    if hd > HEAD_DIMS[-1]:
        raise ValueError(f"flash_attention kernel takes hd <= "
                         f"{HEAD_DIMS[-1]} (built for {HEAD_DIMS}), got {hd}")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention kernel takes window >= 1 or "
                         f"None, got {window}")
    scale = query_scale if query_scale is not None else 1.0 / math.sqrt(hd)
    built = next(d for d in HEAD_DIMS if d >= hd)
    if built != hd:
        q, k, v = (torch.nn.functional.pad(t, (0, built - hd))
                   for t in (q, k, v))
    q, k, v = (t.contiguous() for t in (q, k, v))
    out = torch.empty_like(q)
    if q.device.type == "meta":
        _build.abstract("flash_attention", work)
    else:
        _build.launch("flash_attention", _ARGTYPES,
                      [q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       out.data_ptr(), b, s, h, k.shape[2], built,
                       window or 0, int(q.dtype == torch.bfloat16),
                       float(softcap), float(scale)], q.device)
    return out if built == hd else out[..., :hd]

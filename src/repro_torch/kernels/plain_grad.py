"""Gradients through the card's LM kernels.

A CUDA kernel writes its output through ``data_ptr()`` into a fresh
tensor, which autograd cannot follow: without help, a loss computed on
the card gives no gradient to anything reached only through the kernel.
``PlainGrad`` makes such a call differentiable.  Its forward is the
kernel, exactly as without it; its backward recomputes the kernel's plain
version (``kernels/ref.py``) from the saved inputs under
``torch.enable_grad()`` and returns PyTorch's gradient of that function.
The reference has no backward kernel either: it differentiates its jnp
path, and under ``remat="full"`` a group's forward is recomputed anyway.

The plain version enters the card's path only here, inside the backward:
it never gives a forward value there.  The wrappers use ``PlainGrad`` only
for CUDA tensors while grad mode is on and an input requires grad;
inference and prefill run the kernel alone.
"""

from __future__ import annotations

from typing import Callable, List, Tuple

import torch

#: Depth of ``PlainGrad`` backwards in progress (``recomputing``).
_RECOMPUTING: List[int] = [0]


def recomputing() -> bool:
    """Is a ``PlainGrad`` backward running (its plain recompute and the
    gradient of it)?  ``roofline.analyze`` charges what runs there to
    the score bytes."""
    return _RECOMPUTING[0] > 0


class PlainGrad(torch.autograd.Function):
    """``PlainGrad.apply(forward, plain, *inputs)``: the value of
    ``forward(*inputs)`` (a tensor or a tuple of tensors), the gradient of
    ``plain(*inputs)``, the same function.  An output whose gradient is
    not wanted (``ssd_scan``'s state in train mode) gets none: the
    backward differentiates only the outputs that received one."""

    @staticmethod
    def forward(ctx, forward: Callable, plain: Callable,
                *inputs: torch.Tensor):
        ctx.plain = plain
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(*inputs)
        return forward(*inputs)

    @staticmethod
    def backward(ctx, *grads) -> Tuple:
        needs = ctx.needs_input_grad[2:]
        _RECOMPUTING[0] += 1
        try:
            with torch.enable_grad():
                inputs = [x.detach().requires_grad_(need)
                          for x, need in zip(ctx.saved_tensors, needs)]
                outs = ctx.plain(*inputs)
            outs = outs if isinstance(outs, tuple) else (outs,)
            used = [(out, g) for out, g in zip(outs, grads) if g is not None]
            wanted = [x for x, need in zip(inputs, needs) if need]
            got = iter(torch.autograd.grad([out for out, _ in used], wanted,
                                           [g for _, g in used],
                                           allow_unused=True))
            return (None, None) + tuple(next(got) if need else None
                                        for need in needs)
        finally:
            _RECOMPUTING[0] -= 1

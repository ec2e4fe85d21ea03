"""Training step factory (counterpart of ``repro.train.step``):
microbatched gradient accumulation and AdamW.

``make_train_step(cfg, ...)`` returns ``step(params, opt, batch, stepno)
-> (params, opt, {"loss", "lr", "grad_norm"})``, everything on the
parameters' device:

* ``params`` are float32 masters, cast once a step to their declared
  compute dtypes (``cast_to_compute``); the gradient with respect to the
  cast is taken as the master's (the cast is linear: d loss / d master =
  f32(d loss / d cast));
* the batch is split into at most ``microbatches`` microbatches (the
  reference's cap: as many as divide the batch), their gradients summed
  in float32 and averaged;
* each microbatch's forward runs every group under the configuration's
  remat policy (``models.model.run_layers``);
* the update is ``train.optim.adamw_update`` at the cosine schedule's
  rate, written into ``params`` and ``opt`` in place.

The step reads nothing back from the device.  Its forward, backward and
optimizer run inside profiler ranges (``train.forward``,
``train.backward``, ``train.optimizer``).  The reference's
``shardings_for_step`` has no counterpart: the port's LM trains on one
device.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.profiler import record_function

from repro_torch.core.api import tree_leaves, tree_map
from repro_torch.models import model as M
from repro_torch.models.config import ArchConfig
from repro_torch.train.optim import (AdamState, Step, adamw_update,
                                     cosine_lr, global_norm)

PyTree = Any


def cast_to_compute(cfg: ArchConfig, params: PyTree) -> PyTree:
    """The float32 masters cast to their declared (compute) dtypes, cut
    from the masters' graph."""
    return tree_map(lambda p, d: p.detach().to(d.dtype), params,
                    M.param_decls(cfg))


def master_params(cfg: ArchConfig, params: PyTree) -> PyTree:
    """Float32 copies of the floating-point leaves (training storage)."""
    return tree_map(lambda p: p.to(torch.float32, copy=True)
                    if p.is_floating_point() else p, params)


def make_loss(cfg: ArchConfig, block_q: int = 256, block_k: int = 256
              ) -> Callable[[PyTree, Dict[str, torch.Tensor]], torch.Tensor]:
    """``loss(cparams, batch)`` over compute-dtype parameters: train
    mode; ``block_q`` / ``block_k`` are attention's plain-version blocks
    (the CPU, and the card's backward)."""
    def loss(cparams: PyTree, batch: Dict[str, torch.Tensor]):
        ctx = M.make_ctx(cfg, "train", block_q=block_q, block_k=block_k)
        return M.loss_fn(cfg, cparams, batch, ctx)
    return loss


def loss_and_grads(loss: Callable, cparams: PyTree,
                   batch: Dict[str, torch.Tensor]
                   ) -> Tuple[torch.Tensor, PyTree]:
    """The loss of ``batch`` and its gradient with respect to every leaf
    of ``cparams`` (the tree of gradients; ``None`` where a leaf does not
    reach the loss).  Marks ``cparams``' leaves as requiring grad."""
    leaves = [p.requires_grad_() for p in tree_leaves(cparams)]
    with record_function("train.forward"):
        value = loss(cparams, batch)
    with record_function("train.backward"):
        grads = iter(torch.autograd.grad(value, leaves, allow_unused=True))
    return value.detach(), tree_map(lambda _: next(grads), cparams)


def make_train_step(cfg: ArchConfig, lr: float = 3e-4, warmup: int = 100,
                    total_steps: int = 10000,
                    microbatches: Optional[int] = None,
                    block_q: int = 256, block_k: int = 256,
                    device=None):
    """The training step of ``cfg``.  ``microbatches`` caps the
    microbatches (default: the configuration's); ``device`` is where a
    Python int ``stepno`` becomes a tensor (default: the parameters')."""
    nmb_cfg = microbatches if microbatches is not None else cfg.microbatches
    loss = make_loss(cfg, block_q, block_k)

    def grads_of(cparams: PyTree, batch: Dict[str, torch.Tensor]):
        value, grads = loss_and_grads(loss, cparams, batch)
        if any(g is None for g in tree_leaves(grads)):
            missing = [i for i, g in enumerate(tree_leaves(grads))
                       if g is None]
            raise RuntimeError(f"{cfg.name}: parameter leaves {missing} got "
                               f"no gradient")
        return value, grads

    def step(params: PyTree, opt: AdamState,
             batch: Dict[str, torch.Tensor], stepno: Step
             ) -> Tuple[PyTree, AdamState, Dict[str, torch.Tensor]]:
        gb = batch["tokens"].shape[0]
        nmb = max(1, min(nmb_cfg, gb))
        while gb % nmb:
            nmb -= 1
        # One cast of the masters a step, outside the microbatch loop.
        cparams = cast_to_compute(cfg, params)
        if nmb == 1:
            value, grads = grads_of(cparams, batch)
        else:
            mb = gb // nmb
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            value = 0.0
            for i in range(nmb):
                part = {k: x[i * mb:(i + 1) * mb] for k, x in batch.items()}
                v, g = grads_of(cparams, part)
                for acc, gi in zip(tree_leaves(grads), tree_leaves(g)):
                    acc.add_(gi.float())
                value = value + v
            grads = tree_map(lambda g: g / nmb, grads)
            value = value / nmb
        dev = device if device is not None else tree_leaves(params)[0].device
        lr_t = cosine_lr(stepno, lr, warmup, total_steps, device=dev)
        gnorm = global_norm(grads)
        with record_function("train.optimizer"):
            params, opt = adamw_update(params, grads, opt, stepno, lr_t)
        return params, opt, {"loss": value, "lr": lr_t, "grad_norm": gnorm}

    return step

"""The port's training path against the reference's, on the CPU: the
cross entropy, the loss of every family's smoke configuration, its
gradients leaf by leaf, the remat policies, and the whole step (AdamW
after one and four microbatches).

Parameters are drawn with numpy by the reference's laws
(``test_torch_lm.numpy_params``) and carried across with
``repro_torch.convert.lm_params``; batches come from the port's pipeline
and cross as numpy arrays.  The reference runs jitted, as its own tests
run it (``tests/test_train_substrate.py``).  Tolerances: float32 within
1e-4 relative to the largest value (the loss, each gradient leaf);
bfloat16 within the LM tolerance of ``tests/test_torch_lm.py`` (rtol =
atol = 0.08); the whole step in float32 (the compute dtype made float32 in
both packages): loss and gradient norm within 1e-5 relative, parameters
within 2 lr (a gradient near zero may flip the sign of Adam's first
update) and at least 99% of them within 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.models import model as rmodel
from repro.models.params import is_decl
from repro.train import optim as roptim
from repro.train import step as rstep

from repro_torch import configs
from repro_torch.convert import lm_params
from repro_torch.core.api import tree_leaves, tree_map
from repro_torch.data import pipeline
from repro_torch.models import model
from repro_torch.train import optim, step as tstep
from test_torch_lm import (ARCHS, F32_TOL, a32, assert_close, numpy_params,
                           rel_err)

#: One smoke configuration of each kind whose gradients are compared.
GRAD_ARCHS = ("qwen2-7b", "mamba2-130m", "zamba2-2.7b", "mixtral-8x22b")
STEP_TOL = 1e-5
B, S = 2, 16


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """PyTorch on one thread here: the suite runs several workers at once,
    and small operations on threads that wait for busy cores slow down
    tenfold."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def batch_pair(cfg, b=B, s=S, step=0):
    """A batch of the port's pipeline, as tensors and as jnp arrays."""
    batch = pipeline.synthetic_batch(cfg, b, s, seed=3, step=step)
    return batch, {k: jnp.asarray(a32(v) if v.dtype == torch.bfloat16
                                  else v.numpy(),
                                  jnp.bfloat16 if v.dtype == torch.bfloat16
                                  else None)
                   for k, v in batch.items()}


def rctx(cfg):
    return rmodel.make_ctx(cfg, "train", rmodel.Shardings(), block_q=8,
                           block_k=8)


def f32_decls(monkeypatch):
    """Both packages' declarations in float32, so the step's cast to the
    compute dtype keeps float32."""
    rdecls, mdecls = rmodel.param_decls, model.param_decls
    monkeypatch.setattr(rmodel, "param_decls", lambda cfg: jax.tree_util.
                        tree_map(lambda d: dataclasses.replace(
                            d, dtype=jnp.float32), rdecls(cfg),
                            is_leaf=is_decl))
    monkeypatch.setattr(model, "param_decls", lambda cfg: tree_map(
        lambda d: dataclasses.replace(d, dtype=torch.float32), mdecls(cfg)))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(2, 9, 50), (2, 5, 4, 30)])
def test_xent_is_the_reference_s(shape, dtype):
    """Value and gradient of the cross entropy (audio's [B, S, CB, V]
    logits too), f32 and bf16 logits."""
    rng = np.random.RandomState(1)
    logits = (rng.standard_normal(shape) * 3).astype(np.float32)
    labels = rng.randint(0, shape[-1], shape[:-1]).astype(np.int32)
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    want, gwant = jax.value_and_grad(rmodel.xent)(
        jnp.asarray(logits, jdt), jnp.asarray(labels), shape[-1])
    lt = torch.from_numpy(logits).to(tdt).requires_grad_()
    got = model.xent(lt, torch.from_numpy(labels), shape[-1])
    (ggot,) = torch.autograd.grad(got, lt)
    got = got.detach()
    assert got.dtype == torch.float32
    assert abs(float(got) - float(want)) <= F32_TOL * abs(float(want))
    assert ggot.dtype == tdt
    assert_close(ggot, gwant, dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_is_the_reference_s(arch, dtype):
    """``loss_fn`` of every family's smoke configuration (audio's codes,
    vlm's vision embeddings in the batch)."""
    rcfg, cfg = rconfigs.smoke(arch), configs.smoke(arch)
    rp = numpy_params(rcfg, 0, dtype)
    batch, rbatch = batch_pair(cfg)
    want = jax.jit(lambda p, b: rmodel.loss_fn(rcfg, p, b, rctx(rcfg)))(
        rp, rbatch)
    ctx = model.make_ctx(cfg, "train", block_q=8, block_k=8)
    got = model.loss_fn(cfg, lm_params(rp), batch, ctx)
    assert got.dtype == torch.float32 and bool(torch.isfinite(got))
    if dtype == "f32":
        assert abs(float(got) - float(want)) <= F32_TOL * abs(float(want))
    else:
        assert_close(got, want, dtype)


def port_grads(cfg, params, batch, block=8):
    loss = tstep.make_loss(cfg, block, block)
    return tstep.loss_and_grads(loss, params, batch)


@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_gradients_are_the_reference_s(arch):
    """``jax.grad`` of the reference's loss against the port's backward,
    leaf by leaf, in float32: every leaf within 1e-4 of its largest
    value, none missing."""
    rcfg, cfg = rconfigs.smoke(arch), configs.smoke(arch)
    rp = numpy_params(rcfg, 2, "f32")
    batch, rbatch = batch_pair(cfg)
    rloss, rgrads = jax.jit(jax.value_and_grad(
        lambda p, b: rmodel.loss_fn(rcfg, p, b, rctx(rcfg))))(rp, rbatch)
    loss, grads = port_grads(cfg, lm_params(rp), batch)
    assert abs(float(loss) - float(rloss)) <= F32_TOL * abs(float(rloss))
    want = lm_params(jax.tree_util.tree_map(np.asarray, rgrads))
    errs = tree_leaves(tree_map(lambda g, w: rel_err(g, w), grads, want))
    assert len(errs) == len(tree_leaves(want))
    print(f"{arch}: {len(errs)} gradient leaves, worst relative error "
          f"{max(errs):.2e}")
    assert max(errs) <= F32_TOL


@pytest.mark.parametrize("remat", ["full", "dots"])
@pytest.mark.parametrize("arch", ["zamba2-2.7b", "qwen2-7b"])
def test_remat_gives_the_same_gradients(arch, remat):
    """``remat="full"`` and ``"dots"`` recompute what ``"none"`` keeps:
    the same loss and gradients, bitwise."""
    base = configs.smoke(arch)
    params = tree_map(lambda x: x.float(), model.init(
        base, torch.Generator().manual_seed(5), "cpu"))
    batch, _ = batch_pair(base)
    plain_loss, plain = port_grads(dataclasses.replace(base, remat="none"),
                                   tree_map(torch.clone, params), batch)
    loss, grads = port_grads(dataclasses.replace(base, remat=remat),
                             tree_map(torch.clone, params), batch)
    assert torch.equal(loss, plain_loss)
    flags = tree_leaves(tree_map(lambda a, b: bool(torch.equal(a, b)),
                                 grads, plain))
    assert flags and all(flags)


def test_unknown_remat_policy_raises():
    cfg = dataclasses.replace(configs.smoke("qwen2-7b"), remat="some")
    params = model.init(cfg, torch.Generator().manual_seed(0), "cpu")
    batch, _ = batch_pair(cfg)
    with pytest.raises(ValueError, match="remat"):
        port_grads(cfg, params, batch)


def abs_diffs(got, want):
    """|got - want| of every element, the reference's tree ``want``
    carried across and matched to the port's ``got`` leaf by leaf."""
    want = lm_params(jax.tree_util.tree_map(np.asarray, want))
    return np.concatenate(tree_leaves(tree_map(
        lambda g, w: np.abs(a32(g) - a32(w)).ravel(), got, want)))


@pytest.mark.parametrize("nmb", [1, 4])
@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_train_step_is_the_reference_s(arch, nmb, monkeypatch):
    """One step of ``make_train_step`` in float32 from the same masters,
    moments and batch (8 sequences, ``nmb`` microbatches): the loss and
    gradient norm within 1e-5 relative, the learning rate equal, every
    parameter and moment within 2 lr of the reference's and at least 99%
    of the parameters within 1e-6."""
    f32_decls(monkeypatch)
    rcfg, cfg = rconfigs.smoke(arch), configs.smoke(arch)
    rp = numpy_params(rcfg, 6, "f32")
    batch, rbatch = batch_pair(cfg, b=8)
    lr, warmup, total = 1e-3, 2, 50
    rfn = jax.jit(rstep.make_train_step(rcfg, None, lr=lr, warmup=warmup,
                                        total_steps=total, microbatches=nmb,
                                        block_q=8, block_k=8))
    rnew, ropt, rm = rfn(rp, roptim.adamw_init(rp), rbatch, jnp.int32(3))
    fn = tstep.make_train_step(cfg, lr=lr, warmup=warmup, total_steps=total,
                               microbatches=nmb, block_q=8, block_k=8)
    params = lm_params(rp)
    new, opt, m = fn(params, optim.adamw_init(params), batch, 3)
    for key in ("loss", "grad_norm"):
        assert abs(float(m[key]) - float(rm[key])) <= \
            STEP_TOL * abs(float(rm[key])), key
    assert float(m["lr"]) == pytest.approx(float(rm["lr"]), rel=1e-6)
    lr_t = float(rm["lr"])
    for got, want in ((new, rnew), (opt.m, ropt.m), (opt.v, ropt.v)):
        assert abs_diffs(got, want).max() <= 2 * lr_t
    diffs = abs_diffs(new, rnew)
    share = float((diffs <= 1e-6).mean())
    print(f"{arch}, {nmb} microbatch(es): {share:.5f} of "
          f"{diffs.size} parameters within 1e-6, the largest difference "
          f"{diffs.max():.3g} (2 lr = {2 * lr_t:.3g})")
    assert share >= 0.99


@pytest.mark.parametrize("arch", ["qwen2-7b", "zamba2-2.7b"])
def test_bf16_train_step_is_the_reference_s(arch):
    """The step as it runs (bf16 compute, f32 masters): loss and
    gradient norm within the LM tolerance, the same structure back."""
    rcfg, cfg = rconfigs.smoke(arch), configs.smoke(arch)
    rp = numpy_params(rcfg, 7, "f32")
    batch, rbatch = batch_pair(cfg, b=4)
    rfn = jax.jit(rstep.make_train_step(rcfg, None, microbatches=2,
                                        block_q=8, block_k=8))
    _, _, rm = rfn(rp, roptim.adamw_init(rp), rbatch, jnp.int32(1))
    params = lm_params(rp)
    fn = tstep.make_train_step(cfg, microbatches=2, block_q=8, block_k=8)
    new, opt, m = fn(params, optim.adamw_init(params), batch, 1)
    assert_close(m["loss"], rm["loss"], "bf16")
    assert_close(m["grad_norm"], rm["grad_norm"], "bf16")
    assert all(x.dtype == torch.float32 for x in tree_leaves(new))
    assert all(bool(torch.isfinite(x).all()) for x in tree_leaves(new))

"""The port's training substrate against the reference's, on the CPU:
the kernels' gradient Function (``kernels/plain_grad.py``), AdamW and the
cosine schedule, the synthetic data pipeline, the training checkpoint
files and the launcher.

The same numpy-seeded inputs go through ``repro`` and ``repro_torch``.
Tolerances: AdamW and the schedule within 1e-6 (float32, relative to
each leaf's largest value); the gradient Function, the data pipeline's
rules, checkpoints and a resumed run bitwise.
"""

import argparse
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.data import pipeline as rpipeline
from repro.train import checkpoint as rckpt
from repro.train import optim as roptim

from repro_torch import configs
from repro_torch.convert import lm_params, lm_tree
from repro_torch.core.api import tree_leaves, tree_map
from repro_torch.data import pipeline
from repro_torch.kernels import ref
from repro_torch.kernels.plain_grad import PlainGrad
from repro_torch.launch import train as launch_train
from repro_torch.models import model
from repro_torch.train import checkpoint, optim
from repro_torch.train.step import master_params
from test_torch_lm import ARCHS, a32, numpy_params

OPT_TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """PyTorch on one thread here: the suite runs several workers at once,
    and small operations on threads that wait for busy cores slow down
    tenfold."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(got, want):
    got, want = a32(got), a32(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# -- the gradient Function of the card's kernels -------------------------------

def _leaves(gen, shapes, scale=1.0):
    return [(torch.randn(s, generator=gen) * scale).requires_grad_()
            for s in shapes]


@pytest.mark.parametrize("case", [
    dict(h=4, g=4, window=None, softcap=0.0, qs=None),
    dict(h=8, g=2, window=None, softcap=0.0, qs=None),      # GQA
    dict(h=4, g=1, window=7, softcap=0.0, qs=0.3),          # window, scale
    dict(h=6, g=3, window=None, softcap=5.0, qs=None),      # softcap
])
def test_plain_grad_flash_attention_is_autograd_of_the_plain(case):
    """``PlainGrad`` with the plain version as its forward: the value and
    every input's gradient bitwise those of autograd through the plain
    version."""
    gen = torch.Generator().manual_seed(11)
    b, s, hd = 2, 37, 16
    q, k, v = _leaves(gen, [(b, s, case["h"], hd), (b, s, case["g"], hd),
                            (b, s, case["g"], hd)])
    plain = functools.partial(ref.flash_attention_ref,
                              window=case["window"], softcap=case["softcap"],
                              query_scale=case["qs"], block_q=8, block_k=16)
    gout = torch.randn(b, s, case["h"], hd, generator=gen)
    out = PlainGrad.apply(plain, plain, q, k, v)
    want = plain(q, k, v)
    assert torch.equal(out, want)
    got = torch.autograd.grad(out, (q, k, v), gout)
    direct = torch.autograd.grad(want, (q, k, v), gout)
    for a, b_ in zip(got, direct):
        assert torch.equal(a, b_)


@pytest.mark.parametrize("use_state", [False, True])
@pytest.mark.parametrize("groups", [1, 2])
def test_plain_grad_ssd_scan_is_autograd_of_the_plain(use_state, groups):
    """The same for the SSD, with the state output unused (train mode)
    and used; an input that needs no gradient gets none."""
    gen = torch.Generator().manual_seed(12)
    b, s, h, p, n = 2, 50, 4, 8, 8
    x, bm, cm = _leaves(gen, [(b, s, h, p), (b, s, groups, n),
                              (b, s, groups, n)])
    dt = (torch.rand(b, s, h, generator=gen) * 0.2).requires_grad_()
    a = (-torch.rand(h, generator=gen) - 0.5).requires_grad_()
    d = torch.rand(h, generator=gen)                    # no gradient wanted
    inputs = (x, dt, a, bm, cm, d)
    plain = functools.partial(ref.ssd_scan_ref, chunk=16)
    y, state = PlainGrad.apply(plain, plain, *inputs)
    y_want, state_want = plain(*inputs)
    assert torch.equal(y, y_want) and torch.equal(state, state_want)
    gy = torch.randn(y.shape, generator=gen)
    gs = torch.randn(state.shape, generator=gen)
    wanted = (x, dt, a, bm, cm)
    if use_state:
        got = torch.autograd.grad((y, state), wanted, (gy, gs))
        direct = torch.autograd.grad((y_want, state_want), wanted, (gy, gs))
    else:
        got = torch.autograd.grad(y, wanted, gy)
        direct = torch.autograd.grad(y_want, wanted, gy)
    for g1, g2 in zip(got, direct):
        assert torch.equal(g1, g2)


def test_kernel_wrappers_on_cpu_tensors_run_the_plain_version():
    """On CPU tensors the wrappers are the plain versions, gradients
    included (no Function in the way)."""
    from repro_torch.kernels import flash_attention, ssd_scan
    gen = torch.Generator().manual_seed(13)
    q, k, v = _leaves(gen, [(1, 20, 2, 8), (1, 20, 1, 8), (1, 20, 1, 8)])
    out = flash_attention.flash_attention(q, k, v, block_q=4, block_k=4)
    assert out.grad_fn is not None
    assert type(out.grad_fn).__name__ != "PlainGradBackward"
    x = torch.randn(1, 20, 2, 4, generator=gen, requires_grad=True)
    y, _ = ssd_scan.ssd_scan(x, torch.rand(1, 20, 2), -torch.ones(2),
                             torch.randn(1, 20, 1, 4),
                             torch.randn(1, 20, 1, 4), torch.ones(2),
                             chunk=8)
    assert y.grad_fn is not None
    assert type(y.grad_fn).__name__ != "PlainGradBackward"


# -- AdamW and the schedule ------------------------------------------------------

@pytest.mark.parametrize("step", [0, 1, 50, 99, 100, 101, 5000, 10000,
                                  20000])
def test_cosine_lr_is_the_reference_s(step):
    want = float(roptim.cosine_lr(jnp.int32(step), 3e-4, 100, 10000))
    got = optim.cosine_lr(step, 3e-4, 100, 10000)
    assert got.dtype == torch.float32
    assert abs(float(got) - want) <= OPT_TOL * 3e-4
    t = torch.full((), step, dtype=torch.int32)
    assert float(optim.cosine_lr(t, 3e-4, 100, 10000)) == float(got)


def _opt_tree(rng, scale):
    shapes = {"w": (16, 24), "b": (24,), "e": (3, 5, 7)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    grads = {k: (rng.standard_normal(s) * scale).astype(np.float32)
             for k, s in shapes.items()}
    m = {k: (rng.standard_normal(s) * 0.01).astype(np.float32)
         for k, s in shapes.items()}
    v = {k: np.abs(rng.standard_normal(s) * 1e-4).astype(np.float32)
         for k, s in shapes.items()}
    return params, grads, m, v


@pytest.mark.parametrize("clip", ["active", "inactive"])
@pytest.mark.parametrize("step", [1, 7, 300])
def test_adamw_update_is_the_reference_s(step, clip):
    """Given the same gradients, parameters and moments: the reference's
    update within 1e-6 of each leaf's largest value, with the global-norm
    clip active (norm about 40) and inactive (about 0.04); weight decay on
    the 2-D and 3-D leaves only."""
    rng = np.random.RandomState(step)
    params, grads, m, v = _opt_tree(rng, 5.0 if clip == "active" else 5e-3)
    j = lambda t: jax.tree_util.tree_map(jnp.asarray, t)  # noqa: E731
    t = lambda d: {k: torch.from_numpy(x.copy()) for k, x in d.items()}  # noqa: E731
    lr = 1e-2
    rp, rs = roptim.adamw_update(j(params), j(grads),
                                 roptim.AdamState(m=j(m), v=j(v)),
                                 jnp.int32(step), lr)
    gnorm = float(optim.global_norm(t(grads)))
    assert (gnorm > 1.0) == (clip == "active")
    mp, ms = optim.adamw_update(t(params), t(grads),
                                optim.AdamState(m=t(m), v=t(v)), step, lr)
    for name in params:
        assert _rel(mp[name], rp[name]) <= OPT_TOL, name
        assert _rel(ms.m[name], rs.m[name]) <= OPT_TOL, name
        assert _rel(ms.v[name], rs.v[name]) <= OPT_TOL, name


def test_adamw_writes_in_place_and_moves_toward_the_minimum():
    p = {"w": torch.tensor([5.0, -3.0])}
    opt = optim.adamw_init(p)
    w = p["w"]
    for s in range(200):
        p, opt = optim.adamw_update(p, {"w": 2 * p["w"]}, opt, s + 1,
                                    lr=5e-2, weight_decay=0.0)
    assert p["w"] is w
    assert float(p["w"].abs().max()) < 0.5


# -- the data pipeline ---------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_pipeline_rules_are_the_reference_s(arch, monkeypatch):
    """The port's transform and the reference's ``synthetic_batch`` on
    the same uniforms (and normals, vlm): bitwise the same batch."""
    cfg, rcfg = configs.smoke(arch), rconfigs.smoke(arch)
    b, s = 3, 33
    rng = np.random.RandomState(5)
    shape = (b, s + 1) + ((cfg.n_codebooks,) if cfg.n_codebooks else ())
    u = rng.uniform(size=shape).astype(np.float32)
    u[0, :4] = [0.0, 0.999999, 0.5, 0.95]
    z = (rng.standard_normal((b, cfg.vision_tokens, cfg.d_model))
         .astype(np.float32) if cfg.vision_tokens else None)
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shp: jnp.asarray(u))
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shp, dtype: jnp.asarray(z, dtype))
    want = rpipeline.synthetic_batch(rcfg, b, s, seed=1, step=jnp.int32(0))
    got = pipeline.batch_from_draws(
        cfg, torch.from_numpy(u), None if z is None else torch.from_numpy(z))
    assert set(got) == set(want)
    for name in want:
        w = np.asarray(want[name])
        if w.dtype.name == "bfloat16":
            assert got[name].dtype == torch.bfloat16
            w = w.astype(np.float32)
        else:
            assert got[name].dtype == torch.int32
        np.testing.assert_array_equal(a32(got[name]), w.astype(np.float32))


@pytest.mark.parametrize("arch", ARCHS)
def test_pipeline_shapes_and_determinism(arch):
    cfg = configs.smoke(arch)
    b, s = 2, 16
    one = pipeline.synthetic_batch(cfg, b, s, seed=7, step=13)
    again = pipeline.synthetic_batch(cfg, b, s, seed=7, step=13)
    other = pipeline.synthetic_batch(cfg, b, s, seed=7, step=14)
    lead = (b, s) + ((cfg.n_codebooks,) if cfg.n_codebooks else ())
    assert tuple(one["tokens"].shape) == tuple(one["labels"].shape) == lead
    assert one["tokens"].dtype == one["labels"].dtype == torch.int32
    assert torch.equal(one["tokens"][:, 1:], one["labels"][:, :-1])
    assert int(one["tokens"].min()) >= 2
    assert int(one["tokens"].max()) < cfg.vocab - 1
    for name in one:
        assert torch.equal(one[name], again[name])
    assert not torch.equal(one["tokens"], other["tokens"])
    if cfg.vision_tokens:
        assert one["vision"].shape == (b, cfg.vision_tokens, cfg.d_model)
        assert one["vision"].dtype == torch.bfloat16
    else:
        assert "vision" not in one


# -- training checkpoints ------------------------------------------------------

def _port_state(cfg, seed):
    """Float32 masters and an AdamW state with non-zero moments."""
    params = master_params(cfg, model.init(
        cfg, torch.Generator().manual_seed(seed), "cpu"))
    gen = torch.Generator().manual_seed(seed + 1)
    opt = optim.AdamState(
        m=tree_map(lambda p: torch.randn(p.shape, generator=gen), params),
        v=tree_map(lambda p: torch.rand(p.shape, generator=gen), params))
    return params, opt


def _equal_trees(got, want):
    flags = tree_leaves(tree_map(lambda a, b: bool(torch.equal(a, b)),
                                 got, want))
    assert flags and all(flags)


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "mamba2-130m", "qwen2-7b",
                                  "gemma2-27b", "mixtral-8x22b"])
def test_port_checkpoint_restores_in_the_reference(arch, tmp_path):
    cfg = configs.smoke(arch)
    params, opt = _port_state(cfg, 3)
    path = str(tmp_path / "port.ckpt")
    checkpoint.save(path, params, opt, 17)
    like = jax.tree_util.tree_map(jnp.zeros_like, lm_tree(params))
    rp, ro, step = rckpt.restore(path, like, roptim.adamw_init(like))
    assert step == 17
    for got, want in ((rp, params), (ro.m, opt.m), (ro.v, opt.v)):
        want = lm_tree(want)
        jax.tree_util.tree_map(
            lambda g, w: np.testing.assert_array_equal(np.asarray(g), w),
            got, want)
        assert jax.tree_util.tree_structure(got) == \
            jax.tree_util.tree_structure(want)
        for g, w in zip(jax.tree_util.tree_leaves(got),
                        jax.tree_util.tree_leaves(want)):
            assert np.asarray(g).dtype == w.dtype


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "mamba2-130m",
                                  "llama4-scout-17b-a16e"])
def test_reference_checkpoint_restores_in_the_port(arch, tmp_path):
    rcfg = rconfigs.smoke(arch)
    rp = numpy_params(rcfg, 4, "f32")
    rng = np.random.RandomState(4)
    ropt = roptim.AdamState(
        m=jax.tree_util.tree_map(lambda x: jnp.asarray(
            rng.standard_normal(x.shape).astype(np.float32)), rp),
        v=jax.tree_util.tree_map(lambda x: jnp.asarray(
            rng.uniform(size=x.shape).astype(np.float32)), rp))
    path = str(tmp_path / "ref.ckpt")
    rckpt.save(path, rp, ropt, 23)
    like, like_opt = _port_state(configs.smoke(arch), 0)
    params, opt, step = checkpoint.restore(path, like, like_opt)
    assert step == 23
    for got, want in ((params, rp), (opt.m, ropt.m), (opt.v, ropt.v)):
        _equal_trees(got, lm_params(jax.tree_util.tree_map(np.asarray,
                                                           want)))
    flags = tree_leaves(tree_map(lambda a, b: a.shape == b.shape
                                 and a.dtype == b.dtype, params, like))
    assert all(flags)


def test_restore_refuses_another_model(tmp_path):
    params, opt = _port_state(configs.smoke("mamba2-130m"), 0)
    path = str(tmp_path / "t.ckpt")
    checkpoint.save(path, params, opt, 1)
    other, other_opt = _port_state(configs.smoke("qwen2-7b"), 0)
    with pytest.raises(ValueError):
        checkpoint.restore(path, other, other_opt)


# -- the launcher ----------------------------------------------------------------

def _args(**kw):
    args = launch_train.parser().parse_args(
        ["--arch", "mamba2-130m", "--smoke", "--device", "cpu", "--batch",
         "2", "--seq", "16"])
    return argparse.Namespace(**{**vars(args), **kw})


@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-2.7b"])
def test_resumed_run_equals_an_unbroken_one(arch, tmp_path):
    """2 steps, a checkpoint, 2 more resumed: bitwise the losses and the
    final parameters and moments of 4 unbroken steps."""
    path = str(tmp_path / "run.ckpt")
    first = launch_train.train(_args(arch=arch, steps=2, ckpt=path))
    resumed = launch_train.train(_args(arch=arch, steps=4, ckpt=path,
                                       resume=True))
    whole = launch_train.train(_args(arch=arch, steps=4))
    assert resumed["start"] == 2 and len(resumed["metrics"]) == 2
    losses = [float(m["loss"]) for m in first["metrics"]
              + resumed["metrics"]]
    assert losses == [float(m["loss"]) for m in whole["metrics"]]
    _equal_trees(resumed["params"], whole["params"])
    _equal_trees(resumed["opt"].m, whole["opt"].m)
    _equal_trees(resumed["opt"].v, whole["opt"].v)
    assert all(np.isfinite(losses))


def test_launcher_prints_the_reference_s_lines(capsys):
    launch_train.main(["--arch", "mamba2-130m", "--smoke", "--device", "cpu",
                       "--steps", "12", "--batch", "2", "--seq", "16"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("arch=mamba2-130m-smoke params=")
    steps = [line for line in out if line.startswith("step ")]
    assert [int(line.split()[1]) for line in steps] == [0, 10, 11]
    assert all(" loss " in line and " gnorm " in line for line in steps)


def test_launcher_without_a_card_exits_2(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        launch_train.main(["--arch", "mamba2-130m", "--smoke"])
    assert exc.value.code == 2
    assert not os.path.exists("run.ckpt")


def test_training_example_lowers_the_loss(tmp_path, capsys):
    """``examples/torch_train_lm.py`` on the CPU, cut to 30 short steps:
    the loss falls, and the checkpoint it writes resumes."""
    import importlib.util
    path = os.path.join(os.path.dirname(__file__), "..", "examples",
                        "torch_train_lm.py")
    spec = importlib.util.spec_from_file_location("torch_train_lm", path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    ckpt = str(tmp_path / "tiny.ckpt")
    flags = ["--device", "cpu", "--batch", "2", "--seq", "64", "--ckpt",
             ckpt]
    losses = example.main(flags + ["--steps", "30"])
    assert len(losses) == 30 and np.mean(losses[-10:]) < np.mean(losses[:10])
    more = example.main(flags + ["--steps", "50", "--resume"])
    assert len(more) == 20
    assert "resumed at step 30" in capsys.readouterr().out

"""Card-only tests of the port's LM serving path: narrow models (head_dim
64, two groups each) and the moe, vlm and audio smoke configurations
(head_dim 16, which the flash kernel takes zero-padded to 64), on the
card against the same parameters on the CPU (bf16, within the reference's
serving check, rtol = atol = 0.08), with the kernels' launches counted per
prefill.  A MoE model's routing is compared first, at every MoE call:
expert ids equal except on near-ties (``models.moe.near_ties``), which are
counted and printed; where there is one, the end-to-end check gives way to
a layer-by-layer one (each layer on the card fed the CPU's input to it).
And ``flash_attention`` at head dims 16 to 96 through the kernel against
its plain version.  Training: the kernels' gradient Function
(``kernels/plain_grad.py``) on the card, its value within the kernels'
tolerances and every input's gradient bitwise that of autograd through
the plain version; one training step of the zamba2 smoke configuration on
the card against the CPU, every parameter leaf given a non-zero gradient
on the card (the gradients the kernels' outputs once dropped).  This file
imports neither ``jax`` nor ``repro``:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_lm_gpu.py

Each test decides inside itself whether a card is present and skips
without one.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.kernels import _build, ref
from repro_torch.kernels import flash_attention as flash
from repro_torch.models import blocks, model, moe
from repro_torch.core.api import tree_leaves, tree_map
from repro_torch.serve import (BatchedServer, Request, make_decode_step,
                               make_prefill_step)
from repro_torch.data import pipeline
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.train import step as tstep
from repro_torch.train.optim import adamw_init

TOL = 0.08
S, STEPS = 40, 3
FLASH_TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}
#: The smoke configurations taken as they are (head_dim 16, two layers).
SMOKE = ("mixtral-8x22b", "llama4-scout-17b-a16e", "internvl2-76b",
         "musicgen-large")


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")


def narrow(arch):
    """``arch``'s smoke configuration with head_dim 64 and two groups
    (those of ``SMOKE`` as they are)."""
    if arch in SMOKE:
        return configs.smoke(arch)
    cfg = dataclasses.replace(configs.smoke(arch), head_dim=64)
    if cfg.family == "hybrid":
        cfg = dataclasses.replace(cfg, n_layers=2 * cfg.hybrid_period)
    elif cfg.local_global_period == 2:
        cfg = dataclasses.replace(cfg, n_layers=4)
    else:
        cfg = dataclasses.replace(cfg, n_layers=2)
    assert model.n_groups(cfg) == 2
    return cfg


class Recorder:
    """The MoE calls (router input, router) and the transformer layers'
    calls (parameters, input, context, window) of a run, on the host, in
    call order; ``take`` returns and clears them."""

    def __init__(self, monkeypatch):
        self.moe, self.layers = [], []
        self.moe_ffn = blocks.moe_ffn
        self.layer = blocks.apply_transformer_layer

        def moe_ffn(x, prm, cfg):
            self.moe.append((x.to("cpu", copy=True), prm["router"].cpu()))
            return self.moe_ffn(x, prm, cfg)

        def layer(p, h, ctx, window, cache=None):
            self.layers.append((p, h.to("cpu", copy=True), ctx, window))
            return self.layer(p, h, ctx, window, cache)
        monkeypatch.setattr(blocks, "moe_ffn", moe_ffn)
        monkeypatch.setattr(blocks, "apply_transformer_layer", layer)

    def take(self):
        out = (self.moe, self.layers)
        self.moe, self.layers = [], []
        return out


def routing_ties(cfg, cpu_calls, card_calls, label):
    """Expert ids of the card's MoE calls equal the CPU's on every token
    that is no near-tie on the CPU side; the near-tie masks."""
    assert len(cpu_calls) == len(card_calls) > 0
    masks = []
    for i, ((x, r), (y, _)) in enumerate(zip(cpu_calls, card_calls)):
        tied = moe.near_ties(x, r, cfg.moe, bf16=x.dtype == torch.bfloat16)
        want, _ = moe.route(x, r, cfg.moe)
        got, _ = moe.route(y, r, cfg.moe)
        bad = (want != got).any(dim=-1) & ~tied
        assert not bool(bad.any()), (label, i, torch.nonzero(bad))
        masks.append(tied)
    print(f"{label}: routing equal; {sum(int(m.sum()) for m in masks)} "
          f"near-tie(s) in {len(masks)} MoE calls")
    return masks


def layer_by_layer(cfg, card_params, cpu_layers, rec):
    """The CPU prefill's layers again, each on the CPU and on the card
    from the CPU's input to it: outputs within TOL on the tokens whose
    routing in that layer is no near-tie."""
    prefill = [c for c in cpu_layers if c[2].mode == "prefill"]
    assert len(prefill) == cfg.n_layers
    for i, (p, h, ctx, window) in enumerate(prefill):
        want, _ = rec.layer(p, h, ctx, window)
        got, _ = rec.layer(card_params["layers"][i]["blk"], h.cuda(), ctx,
                           window)
        calls, _ = rec.take()                    # the CPU's, the card's
        (tied,) = routing_ties(cfg, calls[:1], calls[1:], f"layer {i}")
        keep = ~tied.reshape(h.shape[:2])
        torch.testing.assert_close(got.float().cpu()[keep],
                                   want.float()[keep], rtol=TOL, atol=TOL)


def run(cfg, params, toks, vision=None):
    """Prefill, then teacher-forced decode steps: the logits, the caches
    (in f32 on the CPU) and the prefill's launches."""
    dev = params["embed"].device
    toks = toks.to(dev)
    before = dict(_build.LAUNCHES)
    logits, cache = make_prefill_step(cfg, 16, 16)(
        params, toks[:, :S], None if vision is None else vision.to(dev))
    launched = {k: _build.LAUNCHES[k] - before[k]
                for k in ("flash_attention", "ssd_scan")}
    # A copy, always: on the CPU ``.float().cpu()`` of an f32 leaf is the
    # leaf itself, which the decode steps then write in place.
    host = lambda tree: [x.to("cpu", torch.float32, copy=True)  # noqa: E731
                         for x in tree_leaves(tree)]
    logits_all, caches = [logits.float().cpu()], host(cache)
    cache = model.pad_cache(cfg, cache, S + STEPS)
    decode = make_decode_step(cfg)
    for i in range(STEPS):
        logits, cache = decode(params, cache, toks[:, S + i:S + i + 1], S + i)
        logits_all.append(logits.float().cpu())
    return logits_all, caches + host(cache), launched


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["zamba2-2.7b", "qwen2-7b", "gemma2-27b",
                                  "mamba2-130m", *SMOKE])
def test_card_equals_cpu(arch, monkeypatch):
    need_card()
    cfg = narrow(arch)
    params = model.init(cfg, torch.Generator().manual_seed(0), "cpu")
    shape = (2, S + STEPS) + ((cfg.n_codebooks,) if cfg.n_codebooks
                              else ())
    toks = torch.from_numpy(np.random.RandomState(1).randint(
        0, cfg.vocab, shape).astype(np.int32))
    vision = (torch.randn((2, cfg.vision_tokens, cfg.d_model),
                          generator=torch.Generator().manual_seed(2)) * 0.02
              if cfg.vision_tokens else None)
    rec = Recorder(monkeypatch)
    cpu_logits, cpu_caches, _ = run(cfg, params, toks, vision)
    cpu_moe, cpu_layers = rec.take()
    card_params = tree_map(lambda x: x.cuda(), params)
    card_logits, card_caches, launched = run(cfg, card_params, toks, vision)
    card_moe, _ = rec.take()
    if cfg.moe is not None:
        ties = routing_ties(cfg, cpu_moe, card_moe, arch)
        if any(bool(m.any()) for m in ties):
            print(f"{arch}: near-ties: layer by layer")
            layer_by_layer(cfg, card_params, cpu_layers, rec)
            return
    attention_sites = (0 if cfg.family == "ssm" else
                       model.n_groups(cfg) if cfg.family == "hybrid"
                       else cfg.n_layers)
    mamba_layers = cfg.n_layers if cfg.family in ("ssm", "hybrid") else 0
    assert launched == {"flash_attention": attention_sites,
                        "ssd_scan": mamba_layers}
    for got, want in zip(card_logits, cpu_logits):
        torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)
    assert len(card_caches) == len(cpu_caches)
    for got, want in zip(card_caches, cpu_caches):
        torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)


@pytest.mark.gpu
def test_batched_server_on_the_card():
    """The narrow hybrid served on the card: 2 + 4 launches per
    admission's prefill, none in the decode steps, every request its
    tokens."""
    need_card()
    cfg = narrow("zamba2-2.7b")
    params = model.init(cfg, torch.Generator(device="cuda").manual_seed(0),
                        "cuda")
    rng = np.random.RandomState(2)
    reqs = [Request(rid=i, prompt=rng.randint(0, cfg.vocab, 24).astype(
        np.int32), max_new=5) for i in range(3)]
    server = BatchedServer(cfg, params, 2, 32)
    _build.reset_launches()
    server.run(reqs)
    assert all(r.done and len(r.out) == 5 for r in reqs)
    assert _build.LAUNCHES["flash_attention"] == 2 * len(reqs)
    assert _build.LAUNCHES["ssd_scan"] == 4 * len(reqs)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hd", [16, 32, 48, 96])
def test_flash_attention_takes_every_head_dim_up_to_128(hd, dtype):
    """A head dim the kernel is not built for runs through it, zero-padded
    to the next built one (one launch), within FLASH_TOL of the plain
    version; the scale is the true hd's.  Past 128 it is refused."""
    need_card()
    gen = torch.Generator().manual_seed(hd)
    q, k, v = (torch.randn((2, 150, n, hd), generator=gen).to(dtype).cuda()
               * 1.5 for n in (8, 2, 2))
    before = _build.LAUNCHES["flash_attention"]
    got = flash.flash_attention(q, k, v, window=100)
    assert _build.LAUNCHES["flash_attention"] == before + 1
    assert got.shape == q.shape and got.dtype == dtype
    want = ref.flash_attention_ref(q, k, v, window=100)
    torch.testing.assert_close(got.float(), want.float(),
                               rtol=FLASH_TOL[dtype], atol=FLASH_TOL[dtype])
    wide = torch.zeros((1, 8, 2, 160), dtype=dtype, device="cuda")
    with pytest.raises(ValueError, match=r"hd <= 128"):
        flash.flash_attention(wide, wide, wide)


SSD_TOL = {torch.bfloat16: 5e-2, torch.float32: 1e-4}
#: One training step card against CPU (bf16 compute): the loss within 1e-2
#: relative, the gradient norm and the whole gradient within 5e-2
#: normalised error, the parameters after the step within 2 lr + 1e-6;
#: the gradients in float32 compute: the loss and every leaf within 1e-2
#: (bf16's rounding, summed with cancellation into a small leaf, can move
#: such a leaf by more than the whole: the per-leaf check is made in
#: float32).
TRAIN_LOSS_TOL, TRAIN_GRAD_TOL, TRAIN_F32_TOL = 1e-2, 5e-2, 1e-2


def _grads_equal(out, want, ins, gen):
    g = torch.randn(out.shape, generator=gen, device="cuda").to(out.dtype)
    mine = torch.autograd.grad(out, ins, g)
    theirs = torch.autograd.grad(want, ins, g)
    return [bool(torch.equal(a, b)) for a, b in zip(mine, theirs)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("h, g, window, softcap", [(8, 8, None, 0.0),
                                                   (8, 2, 40, 0.0),
                                                   (4, 1, None, 30.0)])
def test_flash_attention_gradients_on_the_card(h, g, window, softcap,
                                               dtype):
    """The kernel's value, autograd's gradient of the plain version: on
    CUDA tensors that require grad the wrapper runs the Function."""
    need_card()
    gen = torch.Generator(device="cuda").manual_seed(0)
    b, s, hd = 2, 200, 80
    ins = [torch.randn((b, s, n, hd), generator=gen, device="cuda")
           .to(dtype).requires_grad_() for n in (h, g, g)]
    kw = dict(window=window, softcap=softcap, block_q=64, block_k=64)
    before = _build.LAUNCHES["flash_attention"]
    out = flash.flash_attention(*ins, **kw)
    assert _build.LAUNCHES["flash_attention"] == before + 1
    assert type(out.grad_fn).__name__ == "PlainGradBackward"
    want = ref.flash_attention_ref(*ins, **kw)
    tol = FLASH_TOL[dtype]
    assert torch.allclose(out.float(), want.float(), rtol=tol, atol=tol)
    assert all(_grads_equal(out, want, ins, gen))
    assert _build.LAUNCHES["flash_attention"] == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ssd_scan_gradients_on_the_card(dtype):
    need_card()
    gen = torch.Generator(device="cuda").manual_seed(1)
    b, s, h, p, g, n = 2, 300, 8, 64, 2, 64
    x = torch.randn((b, s, h, p), generator=gen, device="cuda").to(dtype)
    dt = torch.nn.functional.softplus(torch.randn(
        (b, s, h), generator=gen, device="cuda") - 4.0)
    a = -torch.rand(h, generator=gen, device="cuda") - 0.5
    bm, cm = (torch.randn((b, s, g, n), generator=gen, device="cuda")
              .to(dtype) for _ in range(2))
    d = torch.rand(h, generator=gen, device="cuda")
    ins = [t.requires_grad_() for t in (x, dt, a, bm, cm, d)]
    y, state = ssd.ssd_scan(*ins, chunk=64)
    assert type(y.grad_fn).__name__ == "PlainGradBackward"
    y_want, state_want = ref.ssd_scan_ref(*ins, chunk=64)
    tol = SSD_TOL[dtype]
    assert torch.allclose(y.float(), y_want.float(), rtol=tol, atol=tol)
    assert torch.allclose(state, state_want, rtol=1e-4, atol=1e-4)
    assert all(_grads_equal(y, y_want, ins, gen))


def _train_step(cfg, params, batch, dev):
    """One step on ``dev``: (metrics, gradient leaves, new parameters),
    all on the host in float32."""
    p = tree_map(lambda x: x.to(dev, copy=True), params)
    grads = []
    orig = tstep.loss_and_grads

    def keep(loss, cparams, b):
        value, g = orig(loss, cparams, b)
        grads.append(g)
        return value, g
    tstep.loss_and_grads = keep
    try:
        step = tstep.make_train_step(cfg, microbatches=1, block_q=16,
                                     block_k=16)
        new, _, m = step(p, adamw_init(p), {k: v.to(dev) for k, v in
                                            batch.items()}, 1)
    finally:
        tstep.loss_and_grads = orig
    host = lambda t: t.to("cpu", torch.float32)  # noqa: E731
    loss32, grads32 = tstep.loss_and_grads(
        tstep.make_loss(cfg, 16, 16),
        tree_map(lambda x: x.to(dev, copy=True), params),
        {k: v.to(dev) for k, v in batch.items()})
    return ({k: float(v) for k, v in m.items()},
            [None if g is None else host(g) for g in tree_leaves(grads[0])],
            [host(x) for x in tree_leaves(new)], float(loss32),
            [host(g) for g in tree_leaves(grads32)])


@pytest.mark.gpu
def test_train_step_on_the_card_equals_cpu():
    """zamba2's smoke configuration, one step of ``make_train_step`` from
    the same masters and batch: every leaf's gradient present and not
    all zero on the card, one launch of each kernel a site (remat
    "none") in the step and one in the float32 gradient, and the card
    within the stated tolerances of the CPU."""
    need_card()
    cfg = configs.smoke("zamba2-2.7b")
    params = tstep.master_params(cfg, model.init(
        cfg, torch.Generator().manual_seed(0), "cpu"))
    batch = pipeline.synthetic_batch(cfg, 2, S, seed=1, step=0)
    before = dict(_build.LAUNCHES)
    card = _train_step(cfg, params, batch, "cuda")
    launched = {k: _build.LAUNCHES[k] - before[k]
                for k in ("flash_attention", "ssd_scan")}
    assert launched == {"flash_attention": 2 * model.n_groups(cfg),
                        "ssd_scan": 2 * cfg.n_layers}
    cpu = _train_step(cfg, params, batch, "cpu")
    assert len(card[1]) == len(tree_leaves(params))
    assert all(g is not None and bool(g.abs().max() > 0) for g in card[1])
    (cm, cg, cp, cl32, cg32), (pm, pg, pp, pl32, pg32) = card, cpu
    assert abs(cm["loss"] - pm["loss"]) <= TRAIN_LOSS_TOL * abs(pm["loss"])
    assert abs(cm["grad_norm"] - pm["grad_norm"]) <= \
        TRAIN_GRAD_TOL * pm["grad_norm"]
    whole = [torch.cat([g.ravel() for g in gs]) for gs in (cg, pg)]
    assert float((whole[0] - whole[1]).norm() / whole[1].norm()) <= \
        TRAIN_GRAD_TOL
    bound = 2 * pm["lr"] + 1e-6
    assert max(float((x - y).abs().max()) for x, y in zip(cp, pp)) <= bound
    assert abs(cl32 - pl32) <= TRAIN_F32_TOL * abs(pl32)
    for x, y in zip(cg32, pg32):
        assert float((x - y).norm() / y.norm()) <= TRAIN_F32_TOL

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
its plain version.  This file imports neither ``jax`` nor ``repro``:

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

"""Card-only tests of the port's LM serving path: narrow models whose
attention the card's kernel takes (head_dim 64), two groups each, on the
card against the same parameters on the CPU (bf16, within the reference's
serving check, rtol = atol = 0.08), with the kernels' launches counted
per prefill; and a smoke configuration (head_dim 16) on the card, which
raises the kernel's head-dim error (no fallback to the plain version).
This file imports neither ``jax`` nor ``repro``:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_lm_gpu.py

Each test decides inside itself whether a card is present and skips
without one.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.kernels import _build
from repro_torch.models import model
from repro_torch.core.api import tree_leaves, tree_map
from repro_torch.serve import (BatchedServer, Request, make_decode_step,
                               make_prefill_step)

TOL = 0.08
S, STEPS = 40, 3


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")


def narrow(arch):
    """``arch``'s smoke configuration with head_dim 64 and two groups."""
    cfg = dataclasses.replace(configs.smoke(arch), head_dim=64)
    if cfg.family == "hybrid":
        cfg = dataclasses.replace(cfg, n_layers=2 * cfg.hybrid_period)
    elif cfg.local_global_period == 2:
        cfg = dataclasses.replace(cfg, n_layers=4)
    else:
        cfg = dataclasses.replace(cfg, n_layers=2)
    assert model.n_groups(cfg) == 2
    return cfg


def run(cfg, params, toks):
    """Prefill, then teacher-forced decode steps: the logits, the caches
    (in f32 on the CPU) and the prefill's launches."""
    dev = params["embed"].device
    toks = toks.to(dev)
    before = dict(_build.LAUNCHES)
    logits, cache = make_prefill_step(cfg, 16, 16)(params, toks[:, :S])
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
                                  "mamba2-130m"])
def test_card_equals_cpu(arch):
    need_card()
    cfg = narrow(arch)
    params = model.init(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(np.random.RandomState(1).randint(
        0, cfg.vocab, (2, S + STEPS)).astype(np.int32))
    cpu_logits, cpu_caches, _ = run(cfg, params, toks)
    card_logits, card_caches, launched = run(
        cfg, tree_map(lambda x: x.cuda(), params), toks)
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
def test_a_smoke_config_raises_the_kernel_s_head_dim_error():
    need_card()
    cfg = configs.smoke("qwen2-7b")                  # head_dim 16
    params = model.init(cfg, torch.Generator(device="cuda").manual_seed(0),
                        "cuda")
    toks = torch.zeros((1, 8), dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match=r"takes hd in \(64, 80, 128\)"):
        make_prefill_step(cfg)(params, toks)

"""The port's LM as a whole against the reference's, on the CPU: the
smoke configurations of all ten architectures (dense, moe, vlm, audio,
ssm, hybrid), with the reference's parameters carried across by
``repro_torch.convert``.  Prefill logits, the prefill cache (k, v, state,
conv) and three teacher-forced decode steps' logits, in float32 within
1e-4 of the largest logit and in bfloat16 within the reference's serving
check (rtol = atol = 0.08, ``tests/test_arch_smoke.py``).  The vlm model's
prefill takes the same vision embeddings on both sides.

A MoE model's routing is compared first, at every MoE call of the run
(``MoERecorder``; ``test_torch_moe.route_agreement``): expert ids equal
wherever the reference's margin exceeds the threshold, near-ties counted
and printed.  Where a near-tie falls in a bfloat16 run, the end-to-end
check gives way to the layer-by-layer one (``compare_layer_by_layer``):
each layer of both packages fed the reference's input to it, its output
compared on the tokens whose routing is no near-tie.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.models import blocks as rblocks
from repro.models import model as rmodel
from repro.models import moe as rmoe
from repro.serve import engine as rengine

from repro_torch import configs
from repro_torch.convert import lm_params, tensor
from repro_torch.models import blocks, model
from repro_torch.core.api import tree_map
from repro_torch.serve import engine
from test_torch_lm import (ARCHS, F32_TOL, TDT, a32, assert_close,
                           numpy_params, rel_err, tokens, vision)
from test_torch_moe import route_agreement

MOE_ARCHS = ("mixtral-8x22b", "llama4-scout-17b-a16e")


class MoERecorder:
    """Each MoE call's router input and router, in call order: the port's
    (``blocks.moe_ffn`` patched) and the reference's (``ref_hook``, its
    ``Ctx.moe_shard_map``, recording through an ordered debug callback so
    it works under ``jit`` and inside the layer scan)."""

    def __init__(self, monkeypatch, cfg):
        self.cfg, self.ref, self.port = cfg, [], []
        orig = blocks.moe_ffn

        def port(x, prm, mcfg):
            self.port.append((x.detach().clone(), prm["router"]))
            return orig(x, prm, mcfg)
        monkeypatch.setattr(blocks, "moe_ffn", port)

    def patch_reference(self, monkeypatch):
        """Record the reference's MoE calls wherever its blocks make them
        (a ``BatchedServer`` builds its own contexts)."""
        monkeypatch.setattr(rblocks, "moe_ffn",
                            lambda x, prm, mcfg, **kw: self.ref_hook(x, prm))

    def ref_hook(self, x, prm):
        jax.debug.callback(
            lambda a, r: self.ref.append((np.asarray(a), np.asarray(r))),
            x, prm["router"], ordered=True)
        return rmoe.moe_ffn(x, prm, self.cfg.moe)

    def ties(self, dtype, label):
        """Hold the recorded calls' routing to each other; the near-tie
        mask of each call, and the records cleared."""
        assert len(self.ref) == len(self.port) > 0
        masks = [route_agreement(rx, rr, tx, tr, self.cfg.moe, dtype,
                                 f"{label} call {i}")
                 for i, ((rx, rr), (tx, tr)) in enumerate(zip(self.ref,
                                                              self.port))]
        self.ref.clear()
        self.port.clear()
        return masks


def compare_layer_by_layer(cfg, mcfg, rp, mp, toks, vis, dtype, rec):
    """Prefill, layer by layer: each layer of both packages (the
    reference's op by op) fed the reference's input to it; each output
    held to the reference's on the tokens whose routing in that layer is
    no near-tie.  Returns the near-tie count."""
    rctx = rblocks.Ctx(cfg=cfg, mode="prefill", block_q=8, block_k=8,
                       moe_shard_map=rec.ref_hook)
    mctx = blocks.Ctx(cfg=mcfg, mode="prefill", block_q=8, block_k=8)
    batch = {"tokens": jnp.asarray(toks)}
    if vis is not None:
        batch["vision"] = jnp.asarray(vis)
    h = rmodel._embed(cfg, rp, batch, rctx)
    b, s = toks.shape[:2]
    ties = 0
    for i in range(rmodel.n_groups(cfg)):
        gp = jax.tree_util.tree_map(lambda x: x[i], rp["layers"])["blk"]
        want, _ = rblocks.apply_transformer_layer(gp, h, rctx, cfg.window)
        got, _ = blocks.apply_transformer_layer(
            mp["layers"][i]["blk"], tensor(np.asarray(h)), mctx,
            mcfg.window)
        (tied,) = rec.ties(dtype, f"layer {i}")
        keep = ~tied.reshape(b, s)
        assert_close(a32(got)[keep], a32(want)[keep], dtype)
        ties += int(tied.sum())
        h = want
    return ties


def _cache_leaves(rcache, mcache):
    for site in rcache:
        assert set(mcache[site]) == set(rcache[site])
        for name in rcache[site]:
            yield f"{site}.{name}", mcache[site][name], rcache[site][name]


def _reference_steps(cfg, rec):
    """The reference's jitted prefill and decode steps; for a MoE model
    with ``rec``'s hook as the MoE."""
    if rec is None:
        return (jax.jit(rengine.make_prefill_step(cfg, block_q=8,
                                                  block_k=8)),
                jax.jit(rengine.make_decode_step(cfg)))
    sh = rmodel.Shardings()

    def ctx(mode, **kw):
        return dataclasses.replace(rmodel.make_ctx(cfg, mode, sh, **kw),
                                   moe_shard_map=rec.ref_hook)

    return (jax.jit(lambda p, batch: rmodel.prefill(
                cfg, p, batch, ctx("prefill", block_q=8, block_k=8))),
            jax.jit(lambda p, c, tok, pos: rmodel.decode_step(
                cfg, p, c, tok, pos, ctx("decode", pos=pos))))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_model_matches_reference(arch, dtype, monkeypatch):
    """Prefill logits and cache, then 3 teacher-forced decode steps'
    logits and the cache after them, from the reference's parameters."""
    cfg = rconfigs.smoke(arch)
    mcfg = configs.smoke(arch)
    rp = numpy_params(cfg, 0, dtype)
    mp = lm_params(rp)
    b, s, n = 2, 16, 3
    toks = tokens(cfg, b, s + n)
    vis = vision(cfg, b)
    rec = MoERecorder(monkeypatch, cfg) if cfg.moe else None
    rprefill, rdec = _reference_steps(cfg, rec)
    batch = {"tokens": jnp.asarray(toks[:, :s])}
    if vis is not None:
        batch["vision"] = jnp.asarray(vis, rp["embed"].dtype)
    rl, rc = rprefill(rp, batch)
    ml, mc = engine.make_prefill_step(mcfg, block_q=8, block_k=8)(
        mp, torch.from_numpy(toks[:, :s]),
        None if vis is None else torch.from_numpy(vis).to(TDT[dtype]))
    checks = [("prefill", ml, rl)]
    for name, got, want in _cache_leaves(rc, mc):
        assert got.dtype == (torch.float32 if name.endswith("state")
                             else TDT[dtype]), name
        checks.append((name, got.clone(), want))   # decode writes it
    rc = rmodel.pad_cache(cfg, rc, s + n)
    mc = model.pad_cache(mcfg, mc, s + n)
    mdec = engine.make_decode_step(mcfg)
    for i in range(n):
        tok = toks[:, s + i:s + i + 1]
        rl, rc = rdec(rp, rc, jnp.asarray(tok), jnp.int32(s + i))
        ml, mc = mdec(mp, mc, torch.from_numpy(tok), s + i)
        checks.append((f"decode {i}", ml, rl))
    checks += [(f"{name} after", got, want)
               for name, got, want in _cache_leaves(rc, mc)]
    ties = 0
    if rec is not None:
        jax.effects_barrier()
        ties = sum(int(m.sum()) for m in rec.ties(dtype, arch))
    if ties and dtype == "bf16":
        print(f"{arch} {dtype}: {ties} near-tie(s): layer by layer")
        compare_layer_by_layer(cfg, mcfg, rp, mp, toks[:, :s], vis, dtype,
                               rec)
        return
    for _, got, want in checks:
        assert_close(got, want, dtype)
    errs = {name: rel_err(got, want) for name, got, want in checks
            if name == "prefill" or name.startswith("decode")}
    print(f"{arch} {dtype}: max |logit error| / max |logit| {errs}")


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_model_layer_by_layer(arch, monkeypatch):
    """The layer-by-layer check that stands in for the end-to-end one
    where a bfloat16 run meets a near-tie: run here on its own."""
    cfg, mcfg = rconfigs.smoke(arch), configs.smoke(arch)
    rp = numpy_params(cfg, 0, "bf16")
    rec = MoERecorder(monkeypatch, cfg)
    ties = compare_layer_by_layer(cfg, mcfg, rp, lm_params(rp),
                                  tokens(cfg, 2, 16), None, "bf16", rec)
    print(f"{arch}: {ties} near-tie(s) in {rmodel.n_groups(cfg)} layers")


def test_forward_is_prefill_at_every_position():
    """``forward`` (train mode, no cache) gives the logits prefill gives
    at its last position, for every prefix."""
    cfg = configs.smoke("zamba2-2.7b")
    params = tree_map(lambda x: x.float(), model.init(
        cfg, torch.Generator().manual_seed(0), "cpu"))
    toks = torch.from_numpy(tokens(cfg, 2, 12))
    logits = model.forward(cfg, params, toks,
                           model.make_ctx(cfg, "train", block_q=4,
                                          block_k=4))
    step = engine.make_prefill_step(cfg, block_q=4, block_k=4)
    for s in (1, 5, 12):
        last, _ = step(params, toks[:, :s])
        assert rel_err(last, logits[:, s - 1]) < F32_TOL

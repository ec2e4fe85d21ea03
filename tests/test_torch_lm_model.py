"""The port's LM as a whole against the reference's, on the CPU: the
smoke configurations of the six dense / ssm / hybrid architectures, with
the reference's parameters carried across by ``repro_torch.convert``.
Prefill logits, the prefill cache (k, v, state, conv) and three
teacher-forced decode steps' logits, in float32 within 1e-4 of the
largest logit and in bfloat16 within the reference's serving check
(rtol = atol = 0.08, ``tests/test_arch_smoke.py``).
"""

import jax
import jax.numpy as jnp
import pytest
import torch

from repro import configs as rconfigs
from repro.models import model as rmodel
from repro.serve import engine as rengine

from repro_torch import configs
from repro_torch.convert import lm_params
from repro_torch.models import model
from repro_torch.core.api import tree_map
from repro_torch.serve import engine
from test_torch_lm import (ARCHS, F32_TOL, TDT, assert_close, numpy_params,
                           rel_err, tokens)


def _cache_leaves(rcache, mcache):
    for site in rcache:
        assert set(mcache[site]) == set(rcache[site])
        for name in rcache[site]:
            yield f"{site}.{name}", mcache[site][name], rcache[site][name]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_model_matches_reference(arch, dtype):
    """Prefill logits and cache, then 3 teacher-forced decode steps'
    logits and the cache after them, from the reference's parameters."""
    cfg = rconfigs.smoke(arch)
    mcfg = configs.smoke(arch)
    rp = numpy_params(cfg, 0, dtype)
    mp = lm_params(rp)
    b, s, n = 2, 16, 3
    toks = tokens(cfg, b, s + n)
    rl, rc = jax.jit(rengine.make_prefill_step(cfg, block_q=8, block_k=8))(
        rp, {"tokens": jnp.asarray(toks[:, :s])})
    ml, mc = engine.make_prefill_step(mcfg, block_q=8, block_k=8)(
        mp, torch.from_numpy(toks[:, :s]))
    errs = {"prefill": rel_err(ml, rl)}
    assert_close(ml, rl, dtype)
    for name, got, want in _cache_leaves(rc, mc):
        assert got.dtype == (torch.float32 if name.endswith("state")
                             else TDT[dtype]), name
        assert_close(got, want, dtype)
    rc = rmodel.pad_cache(cfg, rc, s + n)
    mc = model.pad_cache(mcfg, mc, s + n)
    rdec = jax.jit(rengine.make_decode_step(cfg))
    mdec = engine.make_decode_step(mcfg)
    for i in range(n):
        tok = toks[:, s + i:s + i + 1]
        rl, rc = rdec(rp, rc, jnp.asarray(tok), jnp.int32(s + i))
        ml, mc = mdec(mp, mc, torch.from_numpy(tok), s + i)
        errs[f"decode {i}"] = rel_err(ml, rl)
        assert_close(ml, rl, dtype)
    for name, got, want in _cache_leaves(rc, mc):
        assert_close(got, want, dtype)
    print(f"{arch} {dtype}: max |logit error| / max |logit| {errs}")


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

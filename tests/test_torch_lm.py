"""The port's LM modules against the reference's, on the CPU.

Each module of the serving path (RoPE, decode attention on a rolling
cache, the causal convs, RMSNorm, the MLPs, the attention sublayer and
the mamba layer in prefill and decode, and the int8 KV cache's
quantizer and decode attention) gets the same numpy-seeded inputs in
``repro`` and in ``repro_torch``, the blocks' parameters carried across by
``repro_torch.convert``; the configurations and parameter declarations
against the reference's.  The MoE is ``tests/test_torch_moe.py``, the
whole model ``tests/test_torch_lm_model.py``.

Tolerances: float32 within 1e-4 (relative to the largest value); bfloat16
within the kernels' own (flash attention 2e-2, SSD 5e-2) and, for the
whole model, the reference's serving check (rtol = atol = 0.08,
``tests/test_arch_smoke.py``).  Prefill on the CPU runs the kernels'
plain versions, which is what the reference's ``models`` run too.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.models import attention as rattn
from repro.models import blocks as rblocks
from repro.models import layers as rlayers
from repro.models import model as rmodel
from repro.models import ssm as rssm
from repro.models.params import is_decl

from repro_torch import configs
from repro_torch.convert import lm_params
from repro_torch.models import attention, blocks, layers, model, ssm
from repro_torch.core.api import tree_leaves
from repro_torch.serve import engine

#: The smoke configurations of every family.
ARCHS = ("qwen1.5-32b", "qwen2-7b", "gemma2-27b", "glm4-9b", "mamba2-130m",
         "zamba2-2.7b", "mixtral-8x22b", "llama4-scout-17b-a16e",
         "internvl2-76b", "musicgen-large")
F32_TOL = 1e-4
BF16_TOL = 0.08
FLASH_TOL = 2e-2
SSD_TOL = 5e-2
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


def numpy_params(cfg, seed, dtype):
    """The reference's parameter tree for ``cfg``, drawn with numpy: its
    init laws, but norm scales and biases drawn around their init value
    so they are not trivial.  Leaves declared bf16 are ``dtype``."""
    rng = np.random.RandomState(seed)

    def leaf(d):
        if d.init in ("zeros", "ones"):
            v = (d.init == "ones") + 0.1 * rng.standard_normal(d.shape)
        elif d.init == "ssm_a":
            v = np.log(rng.uniform(1.0, 16.0, d.shape))
        elif d.init == "ssm_dt":
            u = rng.uniform(1e-3, 1e-1, d.shape)
            v = u + np.log(-np.expm1(-u))
        else:
            fan = d.fan_in or (d.shape[-2] if len(d.shape) >= 2
                               else d.shape[-1])
            v = rng.standard_normal(d.shape) / np.sqrt(fan)
        dt = jnp.float32 if d.dtype == jnp.float32 else JDT[dtype]
        return jnp.asarray(v.astype(np.float32), dt)

    return jax.tree_util.tree_map(leaf, rmodel.param_decls(cfg),
                                  is_leaf=is_decl)


def tokens(cfg, b, s, seed=1):
    """[b, s] token ids (audio: [b, s, n_codebooks])."""
    shape = (b, s) + ((cfg.n_codebooks,) if cfg.n_codebooks else ())
    return np.random.RandomState(seed).randint(0, cfg.vocab,
                                               shape).astype(np.int32)


def vision(cfg, b, seed=2):
    """A vlm model's [b, vision_tokens, d_model] embeddings (its stub
    frontend's scale, 0.02), or None for the other families."""
    if not cfg.vision_tokens:
        return None
    return (np.random.RandomState(seed).standard_normal(
        (b, cfg.vision_tokens, cfg.d_model)) * 0.02).astype(np.float32)


def t(x, dtype="f32"):
    """A numpy array as a tensor of ``dtype`` (rounded as jnp rounds)."""
    return torch.from_numpy(np.asarray(x, np.float32)).to(TDT[dtype])


def j(x, dtype="f32"):
    return jnp.asarray(np.asarray(x, np.float32), JDT[dtype])


def a32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def rel_err(got, want):
    """max |got - want| over max |want|."""
    got, want = a32(got), a32(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def assert_close(got, want, dtype, tol=None):
    if dtype == "f32":
        assert rel_err(got, want) <= (tol or F32_TOL)
    else:
        tol = tol or BF16_TOL
        np.testing.assert_allclose(a32(got), a32(want), rtol=tol, atol=tol)


# -- configurations and parameters -------------------------------------------

def test_configs_are_the_reference_s():
    assert configs.ARCH_IDS == rconfigs.ARCH_IDS
    assert configs.ALIASES == rconfigs.ALIASES
    for arch in rconfigs.ARCH_IDS:
        for fn in ("get", "smoke"):
            mine = getattr(configs, fn)(arch)
            ref = getattr(rconfigs, fn)(arch)
            assert dataclasses.asdict(mine) == dataclasses.asdict(ref), arch
            assert mine.param_count() == ref.param_count()
            assert mine.quadratic_attention == ref.quadratic_attention


def _decl(d, lead=()):
    return (lead + tuple(d.shape), str(np.dtype(d.dtype)) if not isinstance(
        d.dtype, torch.dtype) else str(d.dtype).replace("torch.", ""),
        d.init)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_decls_are_the_reference_s_unstacked(arch):
    """At full width: the reference's leaves, its stacked group axis
    (and a hybrid group's layer axis) as lists; the count is
    ``param_count()``."""
    cfg = configs.get(arch)
    ref = jax.tree_util.tree_map(_decl, rmodel.param_decls(
        rconfigs.get(arch)), is_leaf=is_decl)
    mine = model.param_decls(cfg)
    is_mine = lambda x: isinstance(x, model.ParamDecl)
    assert set(mine) == set(ref)
    for name in set(mine) - {"layers"}:
        assert jax.tree_util.tree_map(_decl, mine[name],
                                      is_leaf=is_mine) == ref[name], name
    n = model.n_groups(cfg)
    assert len(mine["layers"]) == n
    for gp in mine["layers"]:
        lead = (n,)
        if cfg.family == "hybrid":
            assert len(gp["mamba"]) == cfg.hybrid_period
            gp, lead = {"mamba": gp["mamba"][0]}, (n, cfg.hybrid_period)
        assert jax.tree_util.tree_map(lambda d: _decl(d, lead), gp,
                                      is_leaf=is_mine) == ref["layers"]
    total = sum(int(np.prod(d.shape)) for d in tree_leaves(mine))
    assert total == cfg.param_count()


def test_init_follows_the_reference_s_laws():
    cfg = configs.smoke("zamba2-2.7b")
    gen = torch.Generator().manual_seed(3)
    p = model.init(cfg, gen, "cpu")
    again = model.init(cfg, torch.Generator().manual_seed(3), "cpu")
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(p),
                                                 tree_leaves(again)))
    m = p["layers"][0]["mamba"][0]
    assert m["a_log"].dtype == torch.float32
    a = torch.exp(m["a_log"])
    assert bool(((a >= 1) & (a <= 16)).all())
    dt = torch.nn.functional.softplus(m["dt_bias"])
    assert bool(((dt >= 1e-3 - 1e-6) & (dt <= 1e-1 + 1e-6)).all())
    assert torch.equal(m["d_skip"], torch.ones_like(m["d_skip"]))
    assert torch.equal(m["conv_b"], torch.zeros_like(m["conv_b"]))
    assert m["wz"].dtype == torch.bfloat16
    embed = torch.cat([model.init(cfg, torch.Generator().manual_seed(s),
                                  "cpu")["embed"].float() for s in range(4)])
    assert abs(float(embed.std()) * np.sqrt(cfg.vocab) - 1.0) < 0.05


@pytest.mark.parametrize("arch", rconfigs.ARCH_IDS)
def test_every_configuration_s_family_is_ported(arch):
    """``check_family`` takes every configuration of the repo, full and
    smoke, and a family the port does not know still raises."""
    for cfg in (configs.get(arch), configs.smoke(arch)):
        model.check_family(cfg)
        engine.make_prefill_step(cfg)
        engine.make_decode_step(cfg, kv_quant=True)
    assert model.param_decls(configs.smoke(arch))["layers"]
    with pytest.raises(NotImplementedError, match="not one the port runs"):
        model.check_family(dataclasses.replace(configs.smoke(arch),
                                               family="diffusion"))


# -- modules -----------------------------------------------------------------

@pytest.mark.parametrize("fraction", [1.0, 0.5])
def test_rope(fraction):
    rng = np.random.RandomState(0)
    x = rng.standard_normal((2, 9, 3, 16))
    pos = rng.randint(0, 1000, (2, 9))
    for dtype in ("f32", "bf16"):
        rc, rs, rrot = rattn.rope_tables(jnp.asarray(pos), 16, fraction,
                                         1e4)
        mc, ms, mrot = attention.rope_tables(torch.from_numpy(pos), 16,
                                             fraction, 1e4)
        assert mrot == rrot
        assert rel_err(mc, rc) < 1e-5 and rel_err(ms, rs) < 1e-5
        want = rattn.apply_rope(j(x, dtype), rc, rs, rrot)
        got = attention.apply_rope(t(x, dtype), mc, ms, mrot)
        assert got.dtype == TDT[dtype]
        assert_close(got, want, dtype, 1e-4 if dtype == "f32" else 1e-2)


@pytest.mark.parametrize("case", ["full", "window", "rolling", "softcap"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_decode_attention(case, dtype):
    """One query against a cache; "rolling" is a window-sized cache
    indexed by the rolling slot formula, with unwritten slots marked
    negative."""
    rng = np.random.RandomState(1)
    b, sc, h, g, hd = 2, 12, 4, 2, 16
    q = rng.standard_normal((b, 1, h, hd))
    k = rng.standard_normal((b, sc, g, hd))
    v = rng.standard_normal((b, sc, g, hd))
    kw = {"window": None, "softcap": 0.0, "query_scale": None}
    pos, kpos = 7, None
    if case == "window":
        kw["window"] = 5
    if case == "softcap":
        kw.update(softcap=1.5, query_scale=0.3)
    if case == "rolling":
        kw["window"] = sc
        pos = 30
        kpos = pos - ((pos - np.arange(sc)) % sc)
        kpos[3] = -4                           # a slot not written yet
    want = rattn.decode_attention(
        j(q, dtype), j(k, dtype), j(v, dtype), jnp.int32(pos),
        k_positions=None if kpos is None else jnp.asarray(kpos), **kw)
    got = attention.decode_attention(
        t(q, dtype), t(k, dtype), t(v, dtype), pos,
        k_positions=None if kpos is None else torch.from_numpy(kpos), **kw)
    assert_close(got, want, dtype, None if dtype == "f32" else FLASH_TOL)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_causal_convs(dtype):
    rng = np.random.RandomState(2)
    x = rng.standard_normal((2, 11, 6))
    w = rng.standard_normal((4, 6))
    cache = rng.standard_normal((2, 3, 6))
    assert_close(ssm.causal_conv(t(x, dtype), t(w, dtype)),
                 rssm.causal_conv(j(x, dtype), j(w, dtype)), dtype, 1e-4
                 if dtype == "f32" else 1e-2)
    ry, rc = rssm.causal_conv_step(j(cache, dtype), j(x[:, 0], dtype),
                                   j(w, dtype))
    my, mc = ssm.causal_conv_step(t(cache, dtype), t(x[:, 0], dtype),
                                  t(w, dtype))
    assert_close(my, ry, dtype, 1e-4 if dtype == "f32" else 1e-2)
    assert np.array_equal(a32(mc), a32(rc))


@pytest.mark.parametrize("gemma", [False, True])
def test_rmsnorm(gemma):
    rng = np.random.RandomState(3)
    x = rng.standard_normal((2, 5, 32)) * 3
    w = rng.standard_normal(32)
    for dtype in ("f32", "bf16"):
        got = layers.rmsnorm(t(x, dtype), t(w, dtype), 1e-6, gemma)
        want = rlayers.rmsnorm(j(x, dtype), j(w, dtype), 1e-6, gemma)
        assert got.dtype == TDT[dtype]
        assert_close(got, want, dtype, 1e-4 if dtype == "f32" else 1e-2)


@pytest.mark.parametrize("gated", [True, False])
def test_mlp(gated):
    rng = np.random.RandomState(4)
    d, ff = 16, 40
    p = {"w1": rng.standard_normal((d, ff)) / 4,
         "w2": rng.standard_normal((ff, d)) / 6}
    if gated:
        p["w3"] = rng.standard_normal((d, ff)) / 4
    x = rng.standard_normal((2, 5, d))
    for dtype in ("f32", "bf16"):
        got = layers.apply_mlp({k: t(v, dtype) for k, v in p.items()},
                               t(x, dtype), gated)
        want = rlayers.apply_mlp({k: j(v, dtype) for k, v in p.items()},
                                 j(x, dtype), gated)
        assert_close(got, want, dtype, 1e-4 if dtype == "f32" else 3e-2)


def _site(arch, dtype, name, seed=5):
    """The reference's and the port's parameters of one block of
    ``arch``'s smoke config: the first group's attention / layer."""
    cfg = rconfigs.smoke(arch)
    rp = numpy_params(cfg, seed, dtype)
    mp = lm_params(rp)
    if name == "shared":
        return cfg, rp["shared"], mp["shared"]
    first = jax.tree_util.tree_map(lambda x: x[0], rp["layers"])
    if name == "mamba":
        return (cfg, jax.tree_util.tree_map(lambda x: x[0], first["mamba"]),
                mp["layers"][0]["mamba"][0])
    return cfg, first[name], mp["layers"][0][name]


@pytest.mark.parametrize("arch,window", [("qwen2-7b", None),
                                         ("gemma2-27b", 32),
                                         ("glm4-9b", None)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_attention_sublayer(arch, window, dtype):
    """Prefill (the kernel's site: ``flash_attention`` on the card, its
    plain version here) and the prefill cache; then a decode step on the
    padded cache, the rolling layout where the site has a window."""
    site = "sub0" if window else "blk"
    cfg, rp, mp = _site(arch, dtype, site)
    rng = np.random.RandomState(6)
    s = 40 if window else 16
    h = rng.standard_normal((2, s, cfg.d_model))
    rctx = rblocks.Ctx(cfg=cfg, mode="prefill", block_q=8, block_k=8)
    mctx = blocks.Ctx(cfg=cfg, mode="prefill", block_q=8, block_k=8)
    want, rcache = jax.jit(lambda p, x: rblocks.attention_sublayer(
        p, x, rctx, window))(rp["attn"], j(h, dtype))
    got, mcache = blocks.attention_sublayer(mp["attn"], t(h, dtype), mctx,
                                            window)
    tol = None if dtype == "f32" else FLASH_TOL
    assert_close(got, want, dtype, tol)
    keep = min(s, window or s)
    for kv in ("k", "v"):
        assert mcache[kv].shape[1] == keep
        assert_close(mcache[kv], rcache[kv], dtype, tol)

    # Decode at pos s against a cache of s + 4 slots (the window's, for a
    # windowed site: the rolling layout).
    slots = min(s + 4, window or s + 4)
    pad = lambda x: np.pad(a32(x), ((0, 0), (0, slots - keep), (0, 0),
                                    (0, 0)))
    rcache = {kv: j(pad(rcache[kv]), dtype) for kv in ("k", "v")}
    mcache = {kv: t(pad(mcache[kv]), dtype) for kv in ("k", "v")}
    x = rng.standard_normal((2, 1, cfg.d_model))
    mctx = blocks.Ctx(cfg=cfg, mode="decode", pos=s)
    want, rnew = jax.jit(lambda p, x, c, pos: rblocks.attention_sublayer(
        p, x, rblocks.Ctx(cfg=cfg, mode="decode", pos=pos), window, c))(
            rp["attn"], j(x, dtype), rcache, jnp.int32(s))
    got, mnew = blocks.attention_sublayer(mp["attn"], t(x, dtype), mctx,
                                          window, mcache)
    assert mnew is mcache                      # written in place
    assert_close(got, want, dtype, tol)
    for kv in ("k", "v"):
        assert_close(mnew[kv], rnew[kv], dtype, tol)


@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-2.7b"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_mamba_layer(arch, dtype):
    """Prefill (the kernel's site: ``ssd_scan`` on the card, its plain
    version here) with a ragged last chunk, its state and conv tail;
    then two decode steps writing the cache in place."""
    cfg, rp, mp = _site(arch, dtype, "blk" if arch.startswith("mamba")
                        else "mamba")
    rng = np.random.RandomState(7)
    s = 2 * cfg.ssm.chunk + 5
    h = rng.standard_normal((2, s, cfg.d_model))
    rctx = rblocks.Ctx(cfg=cfg, mode="prefill")
    mctx = blocks.Ctx(cfg=cfg, mode="prefill")
    want, rcache = jax.jit(lambda p, x: rblocks.apply_mamba_layer(
        p, x, rctx))(rp, j(h, dtype))
    got, mcache = blocks.apply_mamba_layer(mp, t(h, dtype), mctx)
    tol = None if dtype == "f32" else SSD_TOL
    assert_close(got, want, dtype, tol)
    assert mcache["state"].dtype == torch.float32
    for name in ("state", "conv"):
        assert_close(mcache[name], rcache[name], dtype, tol)
    mcache = {k: v.clone() for k, v in mcache.items()}
    rdec = jax.jit(lambda p, x, c, pos: rblocks.apply_mamba_layer(
        p, x, rblocks.Ctx(cfg=cfg, mode="decode", pos=pos), c))
    for i in range(2):
        x = rng.standard_normal((2, 1, cfg.d_model))
        mctx = blocks.Ctx(cfg=cfg, mode="decode", pos=s + i)
        want, rcache = rdec(rp, j(x, dtype), rcache, jnp.int32(s + i))
        got, mnew = blocks.apply_mamba_layer(mp, t(x, dtype), mctx, mcache)
        assert mnew is mcache
        assert_close(got, want, dtype, tol)
        for name in ("state", "conv"):
            assert_close(mcache[name], rcache[name], dtype, tol)


# -- the int8 KV cache -------------------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_quantize_kv_is_bitwise_the_reference_s(dtype):
    rng = np.random.RandomState(8)
    x = rng.standard_normal((2, 9, 3, 16)) * 3
    x[0, 0, 0] = 0.0                     # an all-zero row: the 1e-6 floor
    x[1, 2, 1, :4] = [127.5, -127.5, 0.5, 1.5]   # halves round to even
    r8, rs = rattn.quantize_kv(j(x, dtype))
    m8, ms = attention.quantize_kv(t(x, dtype))
    assert m8.dtype == torch.int8 and ms.dtype == torch.float32
    assert np.array_equal(m8.numpy(), np.asarray(r8))
    assert np.array_equal(ms.numpy(), np.asarray(rs))


@pytest.mark.parametrize("case", ["full", "window", "rolling", "softcap"])
@pytest.mark.parametrize("block", [2048, 5])
def test_decode_attention_quant(case, block):
    """One query against an int8 cache, within 1e-5 of the reference's in
    float32; block 5 splits the 12 slots into 3 blocks, the last padded.
    The reference runs op by op (``jax.disable_jit``), the arithmetic its
    code states: compiled, XLA's CPU backend rewrites the scan body's
    bfloat16 steps (k8 * ks, p) and its result moves by about 2e-3."""
    rng = np.random.RandomState(9)
    b, sc, h, g, hd = 2, 12, 4, 2, 16
    q = rng.standard_normal((b, 1, h, hd))
    kv = [attention.quantize_kv(t(rng.standard_normal((b, sc, g, hd))))
          for _ in range(2)]
    (k8, ks), (v8, vs) = kv
    kw = {"window": None, "softcap": 0.0, "query_scale": None,
          "block": block}
    pos, kpos = 7, None
    if case == "window":
        kw["window"] = 5
    if case == "softcap":
        kw.update(softcap=1.5, query_scale=0.3)
    if case == "rolling":
        kw["window"] = sc
        pos = 30
        kpos = pos - ((pos - np.arange(sc)) % sc)
        kpos[3] = -4                           # a slot not written yet
    jx = lambda x: jnp.asarray(x.numpy())      # noqa: E731
    with jax.disable_jit():
        want = rattn.decode_attention_quant(
            j(q), jx(k8), jx(v8), jx(ks), jx(vs), jnp.int32(pos),
            k_positions=None if kpos is None else jnp.asarray(kpos), **kw)
    got = attention.decode_attention_quant(
        t(q), k8, v8, ks, vs, pos,
        k_positions=None if kpos is None else torch.from_numpy(kpos), **kw)
    assert rel_err(got, want) <= 1e-5

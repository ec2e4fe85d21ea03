"""The port's MoE FFN (``repro_torch.models.moe``) against the reference's
(``repro.models.moe``), on the CPU, from the same numpy-seeded tokens and
parameters.

``route`` gives the reference's experts and weights, ``capacity`` its
capacities, and ``moe_ffn`` its outputs within 1e-4 (float32, relative to
the largest value) at capacity factors 0.5 / 1.25 / 4.0, top_k 1 and 2,
with and without the shared expert; the pairs it drops are the ones a
numpy count of the reference's routing drops.  At a lossless capacity
``moe_ffn`` equals the dense oracle ``moe_ffn_dense_reference``.  Equal
router logits pick the lower expert id first, as ``jax.lax.top_k``.

Routing is compared first wherever the two sides' router inputs differ by
rounding (``route_agreement``): expert ids must agree wherever the
reference's margin between consecutive kept ranks (down to the k-th
against the (k+1)-th logit) exceeds the threshold, and the near-ties are
counted and printed.  The threshold is 1e-4 in float32; in bfloat16 it is
the larger of that and the bfloat16 resolution at the router input's
magnitude carried to the logit gap in quadrature, four half-spacings
(2^-8 relative each) of every input element: 2^-6 sqrt(sum_i x_i^2 (r_ia
- r_ib)^2) for the experts a, b on either side of the gap.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as rmoe
from repro.models.config import MoEConfig

from repro_torch.models import moe
from repro_torch.models.config import MoEConfig as TMoEConfig

T, D, E, FF = 40, 32, 4, 24
F32_TOL = 1e-4
F32_MARGIN = 1e-4


def params(cfg, seed=0):
    """numpy parameters of ``moe_decls(D, cfg)`` at the init laws."""
    rng = np.random.RandomState(seed)
    out = {}
    for name, decl in rmoe.moe_decls(D, cfg).items():
        out[name] = (rng.standard_normal(decl.shape)
                     / np.sqrt(decl.shape[-2])).astype(np.float32)
    return out


def both(cfg, p, x):
    """(the reference's, the port's) inputs: jnp and torch float32."""
    return ({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
            {k: torch.from_numpy(v) for k, v in p.items()},
            torch.from_numpy(x))


def tcfg(cfg):
    return TMoEConfig(**{f: getattr(cfg, f) for f in
                         cfg.__dataclass_fields__})


def dropped(experts, num_experts, c):
    """numpy: the (token, choice) pairs past their expert's capacity, in
    token-major order."""
    seen = np.zeros(num_experts, int)
    drop = []
    for e in np.asarray(experts).reshape(-1):
        drop.append(seen[e] >= c)
        seen[e] += 1
    return np.array(drop)


def route_agreement(ref_x, ref_router, port_x, port_router, cfg, dtype,
                    label=""):
    """Compare the reference's routing of ``ref_x`` with the port's of
    ``port_x`` (each side's own router input).  Expert ids must agree on
    every token none of whose reference gaps (rank j against rank j + 1,
    j < k) is within the threshold (the module's docstring).  Prints the
    near-tie count and returns the near-tie mask [T]."""
    x = np.asarray(ref_x, np.float32)
    router = np.asarray(ref_router, np.float32)
    logits = x @ router
    order = np.argsort(-logits, axis=-1, kind="stable")
    rows = np.arange(len(logits))
    tied = np.zeros(len(logits), bool)
    for j in range(cfg.top_k):
        a, b = order[:, j], order[:, j + 1]
        gap = logits[rows, a] - logits[rows, b]
        thr = F32_MARGIN
        if dtype == "bf16":
            thr = np.maximum(thr, 2.0 ** -6 * np.sqrt(np.einsum(
                "td,td->t", x ** 2, (router[:, a] - router[:, b]).T ** 2)))
        tied |= gap <= thr
    r_exp, _ = rmoe.route(jnp.asarray(ref_x), jnp.asarray(ref_router), cfg)
    t_exp, _ = moe.route(port_x, port_router, tcfg(cfg))
    r_exp, t_exp = np.asarray(r_exp), t_exp.numpy()
    bad = (r_exp != t_exp).any(axis=-1) & ~tied
    assert not bad.any(), (label, np.nonzero(bad)[0], r_exp[bad],
                           t_exp[bad])
    print(f"routing {label}: {int(tied.sum())} near-tie(s) of "
          f"{len(tied)} tokens ({dtype})")
    return tied


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_near_ties_is_the_numpy_count(dtype):
    """``moe.near_ties`` (which the card's checks use) marks the tokens
    ``route_agreement``'s numpy threshold marks."""
    cfg = MoEConfig(num_experts=E, top_k=2, d_ff=FF)
    p = params(cfg, 8)
    router = p["router"].copy()
    router[:, 3] = router[:, 0] + 1e-6          # near-ties on 0 and 3
    x = np.random.RandomState(9).standard_normal((T, D)).astype(np.float32)
    if dtype == "bf16":
        x = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    want = route_agreement(x, router, torch.from_numpy(x),
                           torch.from_numpy(router), cfg, dtype)
    got = moe.near_ties(torch.from_numpy(x), torch.from_numpy(router),
                        tcfg(cfg), bf16=dtype == "bf16")
    assert got.dtype == torch.bool
    assert np.array_equal(got.numpy(), want) and want.any()


def rel_err(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("shared", [0, 16])
@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("cf", [0.5, 1.25, 4.0])
def test_moe_ffn_matches_the_reference(cf, top_k, shared):
    cfg = MoEConfig(num_experts=E, top_k=top_k, d_ff=FF, capacity_factor=cf,
                    shared_expert_ff=shared)
    p = params(cfg)
    x = np.random.RandomState(1).standard_normal((T, D)).astype(np.float32)
    rp, rx, tp, tx = both(cfg, p, x)
    assert moe.capacity(T, tcfg(cfg)) == rmoe.capacity(T, cfg)
    assert not route_agreement(x, p["router"], tx, tp["router"], cfg,
                               "f32").any()
    r_exp, r_w = rmoe.route(rx, rp["router"], cfg)
    t_exp, t_w = moe.route(tx, tp["router"], tcfg(cfg))
    assert t_exp.dtype == torch.int32 and t_w.dtype == torch.float32
    assert np.array_equal(t_exp.numpy(), np.asarray(r_exp))
    assert rel_err(t_w, r_w) <= 1e-6
    c = moe.capacity(T, tcfg(cfg))
    _, _, keep = moe.dispatch(t_exp, E, c)
    drop = dropped(r_exp, E, c)
    assert np.array_equal(~keep.numpy(), drop)
    if cf == 0.5:
        assert drop.any()                   # the case drops pairs
    got = moe.moe_ffn(tx, tp, tcfg(cfg))
    want = jax.jit(lambda x, p: rmoe.moe_ffn(x, p, cfg))(rx, rp)
    assert got.dtype == torch.float32
    assert rel_err(got, want) <= F32_TOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("top_k,shared", [(1, 16), (2, 0)])
def test_moe_ffn_equals_the_dense_oracle_at_a_lossless_capacity(
        top_k, shared, dtype):
    cfg = TMoEConfig(num_experts=E, top_k=top_k, d_ff=FF,
                     capacity_factor=float(E), shared_expert_ff=shared)
    p = {k: torch.from_numpy(v) for k, v in params(cfg, 2).items()}
    p = {k: v if k == "router" else v.to(dtype) for k, v in p.items()}
    x = torch.from_numpy(np.random.RandomState(3).standard_normal(
        (T, D)).astype(np.float32)).to(dtype)
    got = moe.moe_ffn(x, p, cfg)
    want = moe.moe_ffn_dense_reference(x, p, cfg)
    assert got.dtype == dtype
    tol = F32_TOL if dtype == torch.float32 else 2e-2
    assert rel_err(got.float(), want.float()) <= tol
    rcfg = MoEConfig(num_experts=E, top_k=top_k, d_ff=FF,
                     capacity_factor=float(E), shared_expert_ff=shared)
    if dtype == torch.float32:
        rwant = rmoe.moe_ffn_dense_reference(
            jnp.asarray(x.numpy()), {k: jnp.asarray(v.numpy())
                                     for k, v in p.items()}, rcfg)
        assert rel_err(want, rwant) <= F32_TOL


def test_equal_logits_pick_the_lower_expert_id_first():
    """Every token ties on experts 1 and 3 (and 0 and 2 below them): the
    reference's ``top_k`` and the port's ``route`` both keep the lower id
    first."""
    cfg = MoEConfig(num_experts=E, top_k=2, d_ff=FF)
    x = np.abs(np.random.RandomState(4).standard_normal(
        (T, D))).astype(np.float32)
    col = np.random.RandomState(5).uniform(0.5, 1.0, D).astype(np.float32)
    router = np.stack([col * 0.5, col, col * 0.5, col], axis=1)
    r_exp, r_w = rmoe.route(jnp.asarray(x), jnp.asarray(router), cfg)
    t_exp, t_w = moe.route(torch.from_numpy(x), torch.from_numpy(router),
                           tcfg(cfg))
    assert (np.asarray(r_exp) == [1, 3]).all()
    assert np.array_equal(t_exp.numpy(), np.asarray(r_exp))
    assert rel_err(t_w, r_w) <= 1e-6
    top1 = MoEConfig(num_experts=E, top_k=1, d_ff=FF)
    t1, _ = moe.route(torch.from_numpy(x), torch.from_numpy(router),
                      tcfg(top1))
    assert (t1.numpy() == 1).all()


def test_route_agreement_counts_near_ties():
    """Routing of two router inputs one bfloat16 rounding apart: the
    tokens whose margin is within the spacing are counted, never failed;
    a token routed differently with a wide margin fails."""
    cfg = MoEConfig(num_experts=E, top_k=2, d_ff=FF)
    p = params(cfg, 6)
    x = np.random.RandomState(7).standard_normal((T, D)).astype(np.float32)
    router = p["router"].copy()
    router[:, 1] = router[:, 2]                 # exact ties on 1 and 2
    tx = torch.from_numpy(x).to(torch.bfloat16).float()
    tied = route_agreement(x, router, tx, torch.from_numpy(router), cfg,
                           "bf16", "tied")
    assert tied.any()
    wrong = router.copy()
    wrong[:, 0] += 10.0                         # expert 0 wins everywhere
    with pytest.raises(AssertionError):
        route_agreement(x, router, torch.from_numpy(x),
                        torch.from_numpy(wrong), cfg, "f32", "wrong")

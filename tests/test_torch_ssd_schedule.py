"""The precision of ``ssd_scan``'s Hopper kernel, modelled on the CPU.

``csrc/ssd_scan.cu`` runs the SSD scan in three passes (each chunk's own
state, the carry from chunk to chunk, the output) and, for bf16 inputs,
its products on the tensor cores: bf16 operands, f32 accumulation.  C, B
and x are bf16 inputs and exact as operands; three operands are f32 values
that bf16 cannot hold (the scaled B of the state update, the masked matrix
W, the carried state S), and the kernel splits each into bf16 hi + lo and
runs its product twice.  ``three_pass`` below is that decomposition in
torch, with every tensor-core operand rounded as the kernel rounds it.

It is held against the port's plain version (``models.ssm.ssd_chunked``)
and the reference's (its Pallas kernel in interpret mode, or its jnp
oracle where S is not a multiple of the chunk, which the Pallas kernel
refuses), for both dtypes, a ragged S, G = 2 and chunk 43, at the card's
own tolerances (``chip_smoke.py``): the f32 state within STATE_TOL, y
within SSD_TOL (allclose) and SSD_REL_TOL (normalised error).  Rounding the
scaled operands to one bf16 each instead fails STATE_TOL: the split is what
the tolerance needs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels.ssd_scan import ssd_scan as j_ssd
from repro.models.ssm import ssd_chunked as j_chunked
from repro_torch.convert import tensor
from repro_torch.models.ssm import ssd_chunked

#: The card's tolerances (chip_smoke.py, tests/test_torch_gpu.py).
STATE_TOL = 1e-4
SSD_TOL = {"bf16": 5e-2, "f32": 1e-4}
SSD_REL_TOL = {"bf16": 5e-3, "f32": 1e-4}
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
JDTYPES = {"bf16": jnp.bfloat16, "f32": jnp.float32}


def bf16(t):
    return t.to(torch.bfloat16).float()


def operand(t, rounding):
    """A tensor-core operand as the kernel feeds it: f32 (the f32 route's
    CUDA cores), one bf16 ("single"), or bf16 hi + lo ("split")."""
    if rounding == "f32":
        return [t]
    hi = bf16(t)
    return [hi] if rounding == "single" else [hi, bf16(t - hi)]


def product(eq, a_parts, b):
    return sum(torch.einsum(eq, part, b) for part in a_parts)


def three_pass(x, dt, a, b, c, d, chunk, rounding):
    """The kernel's three passes; ``rounding`` is how it rounds the scaled
    B, W and S (C, B and x enter as they are: exact in bf16)."""
    bsz, s_orig, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    pad = (-s_orig) % chunk
    x, b, c = (F.pad(t.float(), (0, 0, 0, 0, 0, pad)) for t in (x, b, c))
    dt = F.pad(dt, (0, 0, 0, pad))
    nc = (s_orig + pad) // chunk
    xc = x.reshape(bsz, nc, chunk, h, p)
    dtc = dt.reshape(bsz, nc, chunk, h)
    bh = b.reshape(bsz, nc, chunk, g, n).repeat_interleave(h // g, dim=3)
    ch = c.reshape(bsz, nc, chunk, g, n).repeat_interleave(h // g, dim=3)
    cum = torch.cumsum(dtc * a, dim=2)
    total = cum[:, :, -1]

    # 1. Each chunk's own state: (B o exp(total - cum) dt)^T x.
    sdec = torch.exp(total[:, :, None] - cum) * dtc
    own = product("bcjhn,bcjhp->bchnp", operand(bh * sdec[..., None],
                                                rounding), xc)
    # 2. The carry: the state into each chunk, and the final state.
    state = torch.zeros((bsz, h, n, p))
    carried = []
    for ci in range(nc):
        carried.append(state)
        state = state * torch.exp(total[:, ci, :, None, None]) + own[:, ci]
    s_in = torch.stack(carried, dim=1)
    # 3. y = W x + exp(cum) C S_in + d x, W masked inside the exponent.
    scores = torch.einsum("bcihn,bcjhn->bcijh", ch, bh)
    ii = torch.arange(chunk)
    diff = cum[:, :, :, None] - cum[:, :, None, :]
    diff = torch.where((ii[:, None] >= ii[None, :])[None, None, :, :, None],
                       diff, -torch.inf)
    w = scores * torch.exp(diff) * dtc[:, :, None, :, :]
    y = product("bcijh,bcjhp->bcihp", operand(w, rounding), xc)
    cs = sum(torch.einsum("bcihn,bchnp->bcihp", ch, part)
             for part in operand(s_in, rounding))
    y = y + torch.exp(cum)[..., None] * cs + xc * d[:, None]
    y = y.reshape(bsz, nc * chunk, h, p)[:, :s_orig]
    return y, state


def inputs(seed, b, s, h, p, g, n, dtype):
    """chip_smoke.py's draw: dt = softplus(N(0, 1) - 5), mamba2's range,
    so a chunk carries on a sizeable share of the state; B and C at 0.3."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(b, s, h, p) * 0.5).astype(np.float32)
    dt = np.logaddexp(0.0, rng.randn(b, s, h) - 5.0).astype(np.float32)
    a = (-np.exp(rng.randn(h) * 0.3)).astype(np.float32)
    bm = (rng.randn(b, s, g, n) * 0.3).astype(np.float32)
    cm = (rng.randn(b, s, g, n) * 0.3).astype(np.float32)
    d = (1.0 + rng.randn(h)).astype(np.float32)
    cast = DTYPES[dtype]
    port = (tensor(x, dtype=cast), tensor(dt), tensor(a),
            tensor(bm, dtype=cast), tensor(cm, dtype=cast), tensor(d))
    jx = tuple(jnp.asarray(v) for v in (x, dt, a, bm, cm, d))
    jax_args = (jx[0].astype(JDTYPES[dtype]), jx[1], jx[2],
                jx[3].astype(JDTYPES[dtype]), jx[4].astype(JDTYPES[dtype]),
                jx[5])
    return port, jax_args


def as_f32(t):
    """A torch tensor or a jax array (bf16 or f32) as an f32 tensor."""
    if torch.is_tensor(t):
        return t.float()
    return torch.from_numpy(np.array(t, np.float32))


def close(got, want, tol, rel_tol):
    """chip_smoke.py's check: allclose with rtol = atol = tol, and the
    normalised error ||got - want|| / ||want|| at most rel_tol."""
    got, want = as_f32(got), as_f32(want)
    diff = (got - want).abs()
    rel = float(diff.norm() / want.norm().clamp_min(1e-30))
    ok = bool((diff <= tol + tol * want.abs()).all())
    return ok and rel <= rel_tol, rel


#: (b, s, h, p, g, n, chunk, dtype)
CASES = [(2, 256, 4, 32, 1, 64, 64, "bf16"),
         (1, 300, 4, 32, 2, 32, 64, "bf16"),     # G = 2, ragged S
         (1, 100, 2, 16, 1, 16, 43, "bf16"),     # chunk 43, ragged S
         (1, 256, 2, 32, 1, 32, 64, "f32"),
         (1, 130, 4, 16, 2, 16, 43, "f32")]      # G = 2, chunk 43, ragged


@pytest.mark.parametrize("b,s,h,p,g,n,chunk,dtype", CASES)
def test_three_pass_model_meets_the_card_tolerances(b, s, h, p, g, n, chunk,
                                                    dtype):
    port, jax_args = inputs(s + n, b, s, h, p, g, n, dtype)
    rounding = "split" if dtype == "bf16" else "f32"
    y, state = three_pass(*port, chunk, rounding)
    y = y.to(DTYPES[dtype])                    # the kernel's y is x's type
    y_plain, st_plain = ssd_chunked(*port, chunk=chunk)
    if s % chunk == 0:
        y_ref, st_ref = j_ssd(*jax_args, chunk=chunk, interpret=True)
    else:
        y_ref, st_ref = j_chunked(*jax_args, chunk=chunk)
    for want_y, want_st in ((y_plain, st_plain), (y_ref, st_ref)):
        ok, rel = close(y, want_y, SSD_TOL[dtype], SSD_REL_TOL[dtype])
        assert ok, f"y: normalised error {rel}"
        ok, rel = close(state, want_st, STATE_TOL, STATE_TOL)
        assert ok, f"state: normalised error {rel}"


def test_single_bf16_rounding_fails_the_state_tolerance():
    """One bf16 per scaled operand costs up to 2^-8 relative per term: the
    normalised state error lands near 1e-3, ten times STATE_TOL, where the
    hi/lo split stays near 1e-5."""
    port, _ = inputs(7, 1, 512, 4, 64, 1, 64, "bf16")
    _, want_st = ssd_chunked(*port, chunk=128)
    _, st_single = three_pass(*port, 128, "single")
    _, st_split = three_pass(*port, 128, "split")
    ok_single, rel_single = close(st_single, want_st, STATE_TOL, STATE_TOL)
    ok_split, rel_split = close(st_split, want_st, STATE_TOL, STATE_TOL)
    assert not ok_single and rel_single > 5 * STATE_TOL, rel_single
    assert ok_split and rel_split < STATE_TOL / 5, rel_split

"""The port's SSD chunk scan (its plain version, as the CPU runs it)
against the JAX reference: its Pallas kernel in interpret mode and its
jnp oracle ``repro.models.ssm.ssd_chunked``; and the port's decode step
continuing the scan's final state.

Inputs are made in float32 with numpy from a seed and cast on both sides.
Tolerances are the reference's own (``tests/test_kernels.py``):
rtol = atol = 1e-4 in float32, 5e-2 in bfloat16, for y and the state.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as j_ref
from repro.kernels.ssd_scan import ssd_scan as j_ssd
from repro.models.ssm import ssd_chunked as j_chunked
from repro.models.ssm import ssd_decode_step as j_decode
from repro_torch.convert import tensor
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.models.ssm import ssd_chunked, ssd_decode_step

BF16 = "bf16"
F32 = "f32"
JDT = {BF16: jnp.bfloat16, F32: jnp.float32}
TDT = {BF16: torch.bfloat16, F32: torch.float32}
TOL = {BF16: 5e-2, F32: 1e-4}

#: tests/test_kernels.py::SSD_CASES: (b, s, h, p, g, n, chunk, dtype)
SSD_CASES = [
    (1, 128, 2, 64, 1, 64, 64, F32),
    (2, 256, 4, 64, 1, 128, 64, F32),
    (1, 256, 4, 64, 2, 64, 128, F32),
    (2, 128, 2, 32, 1, 32, 32, BF16),
]


def make_inputs(seed, b, s, h, p, g, n):
    """(x, dt, a, b, c, d) in float32, as the reference's tests draw them:
    dt after a softplus, a negative."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(b, s, h, p) * 0.5).astype(np.float32)
    dt = (np.logaddexp(0.0, rng.randn(b, s, h)) * 0.5).astype(np.float32)
    a = (-np.exp(rng.randn(h) * 0.3)).astype(np.float32)
    bm = (rng.randn(b, s, g, n) * 0.3).astype(np.float32)
    cm = (rng.randn(b, s, g, n) * 0.3).astype(np.float32)
    d = np.ones(h, np.float32)
    return x, dt, a, bm, cm, d


def to_port(args, dtype):
    x, dt, a, bm, cm, d = args
    cast = TDT[dtype]
    return (tensor(x, dtype=cast), tensor(dt), tensor(a),
            tensor(bm, dtype=cast), tensor(cm, dtype=cast), tensor(d))


def to_jax(args, dtype):
    x, dt, a, bm, cm, d = (jnp.asarray(v) for v in args)
    cast = JDT[dtype]
    return x.astype(cast), dt, a, bm.astype(cast), cm.astype(cast), d


def assert_close(got, want, dtype):
    y, state = got
    y_want, st_want = want
    tol = TOL[dtype]
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(y_want, np.float32),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(state.numpy(), np.asarray(st_want),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("b,s,h,p,g,n,chunk,dtype", SSD_CASES)
def test_ssd_cases_equal_reference(b, s, h, p, g, n, chunk, dtype):
    args = make_inputs(s + n, b, s, h, p, g, n)
    got = ops.ssd_scan(*to_port(args, dtype), chunk=chunk)
    assert got[0].dtype == TDT[dtype] and got[1].dtype == torch.float32
    assert_close(got, j_ssd(*to_jax(args, dtype), chunk=chunk,
                            interpret=True), dtype)
    assert_close(got, j_ref.ssd_scan_ref(*to_jax(args, dtype), chunk=chunk),
                 dtype)


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_grouped_heads_equal_reference(dtype):
    """G = 2, H = 4: heads 0, 1 read group 0 and heads 2, 3 group 1 (the
    reference's kernel meets G = 2 in SSD_CASES)."""
    args = make_inputs(5, 1, 64, 4, 16, 2, 16)
    got = ops.ssd_scan(*to_port(args, dtype), chunk=32)
    assert_close(got, j_chunked(*to_jax(args, dtype), chunk=32), dtype)
    # Swapping the groups' B/C moves each head's output to the other pair.
    x, dt, a, bm, cm, d = to_port(args, dtype)
    swap = ops.ssd_scan(x, dt, a, bm.flip(2), cm.flip(2), d, chunk=32)
    assert not torch.allclose(swap[0][:, :, :2].float(),
                              got[0][:, :, :2].float())


@pytest.mark.parametrize("s,chunk,dtype", [(100, 32, F32), (77, 64, BF16)])
def test_ragged_sequence_equals_reference(s, chunk, dtype):
    """S not a multiple of the chunk: zero padding, exact on both sides
    (the Pallas kernel refuses such S)."""
    args = make_inputs(s, 2, s, 4, 16, 2, 32)
    got = ops.ssd_scan(*to_port(args, dtype), chunk=chunk)
    assert got[0].shape == (2, s, 4, 16)
    assert_close(got, j_chunked(*to_jax(args, dtype), chunk=chunk), dtype)


def test_state_in_equals_reference():
    args = make_inputs(9, 1, 96, 2, 16, 1, 8)
    state_in = (np.random.RandomState(10).randn(1, 2, 8, 16) * 0.3).astype(
        np.float32)
    got = ssd_chunked(*to_port(args, F32), chunk=32,
                      state_in=tensor(state_in))
    assert_close(got, j_chunked(*to_jax(args, F32), chunk=32,
                                state_in=jnp.asarray(state_in)), F32)


def test_state_continuity():
    """The scan's final state continues a decode stream: one decode step
    equals a longer chunked run (test_ssd_state_continuity's check, with
    the port's scan and decode step), and the reference's decode step."""
    b, s, h, p, g, n = 1, 128, 2, 32, 1, 32
    x, dt, a, bm, cm, d = make_inputs(3, b, s, h, p, g, n)
    rng = np.random.RandomState(4)
    xt = (rng.randn(b, h, p) * 0.5).astype(np.float32)
    dt_t = np.full((b, h), 0.3, np.float32)
    bt = np.full((b, g, n), 0.1, np.float32)
    ct = np.full((b, g, n), 0.1, np.float32)
    _, st = ops.ssd_scan(*(tensor(v) for v in (x, dt, a, bm, cm, d)),
                         chunk=64)
    y_dec, st_dec = ssd_decode_step(st, *(tensor(v) for v in
                                          (xt, dt_t, a, bt, ct, d)))
    longer = [np.concatenate([u, v[:, None]], axis=1)
              for u, v in ((x, xt), (dt, dt_t), (bm, bt), (cm, ct))]
    y2, st2 = ssd_chunked(*(tensor(v) for v in (longer[0], longer[1], a,
                                                longer[2], longer[3], d)),
                          chunk=43)
    np.testing.assert_allclose(y_dec.numpy(), y2[:, -1].numpy(), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(st_dec.numpy(), st2.numpy(), rtol=1e-4,
                               atol=1e-4)
    j_y, j_st = j_decode(jnp.asarray(st.numpy()),
                         *(jnp.asarray(v) for v in (xt, dt_t, a, bt, ct, d)))
    np.testing.assert_allclose(y_dec.numpy(), np.asarray(j_y), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(st_dec.numpy(), np.asarray(j_st), rtol=1e-4,
                               atol=1e-4)


def test_wrapper_checks_its_operands():
    x, dt, a, bm, cm, d = to_port(make_inputs(0, 1, 8, 4, 4, 3, 4), F32)
    with pytest.raises(ValueError):           # H = 4 not a multiple of G = 3
        ssd.ssd_scan(x, dt, a, bm, cm, d, chunk=4)
    x, dt, a, bm, cm, d = to_port(make_inputs(0, 1, 8, 4, 4, 2, 4), F32)
    with pytest.raises(TypeError):
        ssd.ssd_scan(x, dt.double(), a, bm, cm, d, chunk=4)
    with pytest.raises(TypeError):
        ssd.ssd_scan(x, dt, a, bm.to(torch.bfloat16), cm, d, chunk=4)
    y, state = ssd.ssd_scan(x, dt, a, bm, cm, d, chunk=4)
    assert y.shape == x.shape and state.shape == (1, 4, 4, 4)
    assert ssd._build.LAUNCHES["ssd_scan"] == 0    # no card here

"""The port's flash attention (its plain version, as the CPU runs it)
against the JAX reference: its Pallas kernel in interpret mode and its
jnp oracle ``repro.models.attention.blocked_attention``.

Inputs are made in float32 with numpy from a seed and cast on both sides
(round to nearest even gives the same bfloat16 bits).  Tolerances are the
reference's own (``tests/test_kernels.py``): rtol = atol = 2e-5 in
float32, 2e-2 in bfloat16.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as j_ref
from repro.kernels.flash_attention import flash_attention as j_flash
from repro.models.attention import blocked_attention as j_blocked
from repro_torch.convert import tensor
from repro_torch.kernels import flash_attention as flash
from repro_torch.kernels import ops
from repro_torch.models.attention import blocked_attention

BF16 = "bf16"
F32 = "f32"
JDT = {BF16: jnp.bfloat16, F32: jnp.float32}
TDT = {BF16: torch.bfloat16, F32: torch.float32}
TOL = {BF16: 2e-2, F32: 2e-5}

#: tests/test_kernels.py::ATTN_CASES: (b, s, h, g, hd, window, softcap, dtype)
ATTN_CASES = [
    (1, 256, 4, 4, 64, None, 0.0, F32),
    (2, 256, 4, 2, 64, None, 0.0, BF16),
    (1, 512, 8, 2, 64, None, 0.0, F32),
    (1, 256, 2, 1, 128, None, 0.0, F32),
    (2, 512, 4, 4, 64, 128, 0.0, F32),       # sliding window
    (1, 256, 4, 2, 64, None, 50.0, F32),     # softcap (gemma2)
    (1, 512, 4, 1, 64, 256, 30.0, BF16),     # window + softcap
]
#: Cases beyond the reference's: r = 7 (qwen2), hd = 80 (zamba2), and
#: gemma2's query_scale of 1/12 with its softcap.
EXTRA_CASES = [
    (1, 256, 7, 1, 64, None, 0.0, F32, None),
    (1, 256, 4, 2, 80, None, 0.0, F32, None),
    (1, 256, 4, 2, 128, None, 50.0, BF16, 1 / 12),
]


def make_qkv(seed, b, s, h, g, hd):
    rng = np.random.RandomState(seed)
    return [(rng.randn(b, s, n, hd) * 0.5).astype(np.float32)
            for n in (h, g, g)]


def port(qkv, dtype, **kw):
    out = ops.flash_attention(*(tensor(a, dtype=TDT[dtype]) for a in qkv),
                              **kw)
    assert out.dtype == TDT[dtype]
    return out.float().numpy()


def reference(fn, qkv, dtype, **kw):
    return np.asarray(fn(*(jnp.asarray(a).astype(JDT[dtype]) for a in qkv),
                         **kw), np.float32)


def assert_close(got, want, dtype):
    np.testing.assert_allclose(got, want, rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("b,s,h,g,hd,window,softcap,dtype", ATTN_CASES)
def test_attention_cases_equal_reference(b, s, h, g, hd, window, softcap,
                                         dtype):
    qkv = make_qkv(s + h + g, b, s, h, g, hd)
    kw = dict(window=window, softcap=softcap)
    got = port(qkv, dtype, **kw)
    assert_close(got, reference(j_flash, qkv, dtype, block_q=128,
                                block_k=128, interpret=True, **kw), dtype)
    assert_close(got, reference(j_ref.flash_attention_ref, qkv, dtype,
                                block_q=128, block_k=128, **kw), dtype)


@pytest.mark.parametrize("b,s,h,g,hd,window,softcap,dtype,qs", EXTRA_CASES)
def test_gqa_head_dim_and_query_scale_equal_reference(b, s, h, g, hd, window,
                                                      softcap, dtype, qs):
    qkv = make_qkv(hd + h, b, s, h, g, hd)
    kw = dict(window=window, softcap=softcap, query_scale=qs)
    got = port(qkv, dtype, **kw)
    assert_close(got, reference(j_flash, qkv, dtype, interpret=True, **kw),
                 dtype)
    assert_close(got, reference(j_blocked, qkv, dtype, block_q=128,
                                block_k=128, **kw), dtype)


@pytest.mark.parametrize("s,window,dtype", [(200, None, F32),
                                            (333, 100, BF16)])
def test_ragged_sequence_equals_blocked_attention(s, window, dtype):
    """S not a multiple of 128: the Pallas kernel refuses it, the oracle
    (and the port) pad to the block grid."""
    qkv = make_qkv(s, 1, s, 4, 2, 64)
    kw = dict(window=window, softcap=30.0)
    assert_close(port(qkv, dtype, **kw),
                 reference(j_blocked, qkv, dtype, block_q=128, block_k=128,
                           **kw), dtype)


@pytest.mark.parametrize("skip", [False, True])
def test_blocked_attention_options_equal_reference(skip):
    """The oracle itself with its other knobs: unequal blocks (lcm
    padding), a query offset and the skipping of masked blocks."""
    qkv = make_qkv(7, 1, 96, 4, 2, 32)
    kw = dict(window=40, block_q=32, block_k=64, q_offset=5,
              skip_masked_blocks=skip)
    got = blocked_attention(*(tensor(a) for a in qkv), **kw).numpy()
    assert_close(got, reference(j_blocked, qkv, F32, **kw), F32)


def test_wrapper_checks_its_operands():
    q, k, v = (tensor(a) for a in make_qkv(0, 1, 16, 4, 2, 32))
    with pytest.raises(ValueError):
        flash.flash_attention(q, k[:, :, :1].expand(1, 16, 3, 32), v)
    with pytest.raises(TypeError):
        flash.flash_attention(q, k.to(torch.bfloat16), v)
    with pytest.raises(TypeError):
        flash.flash_attention(q.double(), k.double(), v.double())
    assert flash.flash_attention(q, k, v).shape == q.shape
    assert flash._build.LAUNCHES["flash_attention"] == 0   # no card here

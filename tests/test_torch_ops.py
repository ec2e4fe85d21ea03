"""The port's kernel library ``repro_torch.kernels.ops`` against the JAX
reference's ``repro.kernels.ops``: every public name, with the
reference's argument names and defaults (less the Pallas switches), and
each function's value on CPU tensors against the reference's with
``use_pallas=False`` (its plain versions) and with ``use_pallas=True,
interpret=True`` (its Pallas kernels).  Bitset results must be bitwise
equal; attention and SSD agree within the reference's tolerances
(rtol = atol = 2e-5 and 1e-4 in float32).
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels.ops as j_ops
from repro_torch.convert import tensor
from repro_torch.kernels import ops
from repro_torch.problems.graphs import num_words

NAMES = ("flash_attention", "ssd_scan", "degree_stats", "degree_argmax",
         "count_stats", "stacked_count_stats", "popcount_reduce",
         "masked_row_reduce", "domination_stats")
#: The reference's arguments with no counterpart: the tensors' device
#: chooses the kernel, and the port's bitset kernels have no layouts.
DROPPED = {"use_pallas", "interpret", "tile", "stages"}


def public_functions(module):
    return {n for n in dir(module) if not n.startswith("_")
            and inspect.isfunction(inspect.unwrap(getattr(module, n)))
            and getattr(getattr(module, n), "__module__", "") ==
            module.__name__}


def test_every_public_name_is_ported():
    assert public_functions(j_ops) == set(NAMES)
    assert public_functions(ops) == set(NAMES)


@pytest.mark.parametrize("name", NAMES)
def test_signatures_match_the_reference(name):
    want = [(p.name, p.kind, p.default) for p in
            inspect.signature(getattr(j_ops, name)).parameters.values()
            if p.name not in DROPPED]
    got = [(p.name, p.kind, p.default) for p in
           inspect.signature(getattr(ops, name)).parameters.values()]
    assert got == want


def random_words(rng, shape):
    return rng.randint(0, 2 ** 32, size=shape, dtype=np.uint64).astype(
        np.uint32)


def bitset_inputs(name, seed=0, n=40, lanes=6, k=3):
    """numpy operands (uint32 bitsets) of a bitset function."""
    rng = np.random.RandomState(seed)
    w = num_words(n)
    table = random_words(rng, (n, w))
    mask = random_words(rng, (lanes, w))
    valid = mask & random_words(rng, (lanes, w))
    valid[0] = 0
    if name in ("degree_stats", "degree_argmax"):
        return (table, mask)
    if name == "count_stats":
        return (table, mask, valid)
    if name == "stacked_count_stats":
        inst = rng.randint(-1, k, size=lanes).astype(np.int32)
        inst[1] = -1
        return (random_words(rng, (k, n, w)), inst, mask, valid)
    if name == "popcount_reduce":
        return (mask,)
    if name == "masked_row_reduce":
        mask[2] = 0
        return (table, mask)
    if name == "domination_stats":
        fullm = np.full(w, 0xFFFFFFFF, np.uint32)
        fullm[-1] = (1 << (n - 32 * (w - 1))) - 1
        return (table, valid, mask, fullm)
    raise KeyError(name)


BITSET = [("degree_stats", {}), ("degree_argmax", {}), ("count_stats", {}),
          ("stacked_count_stats", {}), ("popcount_reduce", {}),
          ("masked_row_reduce", {"op": "or"}),
          ("masked_row_reduce", {"op": "and"}), ("domination_stats", {})]


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("name,kw", BITSET)
def test_bitset_functions_equal_reference(name, kw, use_pallas):
    args = bitset_inputs(name)
    got = getattr(ops, name)(*(tensor(a) for a in args), **kw).numpy()
    ref_kw = dict(kw, use_pallas=use_pallas)
    if use_pallas:
        ref_kw["interpret"] = True
        if name != "popcount_reduce":
            ref_kw["tile"] = 16
    want = np.asarray(getattr(j_ops, name)(*(jnp.asarray(a) for a in args),
                                           **ref_kw))
    if want.dtype == np.uint32:
        got = got.view(np.uint32)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def rand(rng, *shape, scale=0.5):
    return (rng.randn(*shape) * scale).astype(np.float32)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_flash_attention_equals_reference(use_pallas):
    rng = np.random.RandomState(1)
    q, k, v = rand(rng, 1, 128, 4, 32), rand(rng, 1, 128, 2, 32), \
        rand(rng, 1, 128, 2, 32)
    kw = dict(window=48, softcap=20.0, query_scale=0.2)
    got = ops.flash_attention(*(tensor(a) for a in (q, k, v)), **kw)
    want = j_ops.flash_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                 use_pallas=use_pallas, interpret=True, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_ssd_scan_equals_reference(use_pallas):
    rng = np.random.RandomState(2)
    b, s, h, p, g, n = 1, 64, 2, 16, 1, 16
    args = (rand(rng, b, s, h, p),
            (np.logaddexp(0.0, rng.randn(b, s, h)) * 0.5).astype(np.float32),
            (-np.exp(rng.randn(h) * 0.3)).astype(np.float32),
            rand(rng, b, s, g, n, scale=0.3), rand(rng, b, s, g, n, scale=0.3),
            np.ones(h, np.float32))
    y, state = ops.ssd_scan(*(tensor(a) for a in args), chunk=32)
    y_want, st_want = j_ops.ssd_scan(*(jnp.asarray(a) for a in args),
                                     chunk=32, use_pallas=use_pallas,
                                     interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_want), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(state.numpy(), np.asarray(st_want), rtol=1e-4,
                               atol=1e-4)


def test_reference_arrays_cross_bit_for_bit():
    """A JAX bfloat16 array reaches numpy as ``ml_dtypes.bfloat16`` and
    crosses through a 16-bit view; float32 cast on each side gives the
    same bits; uint32 bitsets become int32 words."""
    x = (np.random.RandomState(3).randn(4, 33) * 100).astype(np.float32)
    x[0, :4] = [np.inf, -np.inf, 1e-40, -0.0]
    j_bf16 = np.asarray(jnp.asarray(x).astype(jnp.bfloat16))
    got = tensor(j_bf16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  j_bf16.view(np.int16))
    assert torch.equal(got.view(torch.int16),
                       tensor(x, dtype=torch.bfloat16).view(torch.int16))
    assert torch.equal(tensor(x), torch.from_numpy(x))
    bits = np.array([[0, 1, 0x80000000, 0xFFFFFFFF]], np.uint32)
    assert tensor(bits).tolist() == [[0, 1, -2 ** 31, -1]]


def test_cpu_tensors_launch_no_kernel():
    from repro_torch.kernels import _build
    _build.reset_launches()
    for name, kw in BITSET:
        getattr(ops, name)(*(tensor(a) for a in bitset_inputs(name)), **kw)
    assert all(v == 0 for v in _build.LAUNCHES.values())
    with pytest.raises(ValueError):
        ops.masked_row_reduce(*(tensor(a) for a in
                                bitset_inputs("masked_row_reduce")), op="xor")
    assert isinstance(ops.popcount_reduce(torch.zeros((0, 3),
                                                      dtype=torch.int32)),
                      torch.Tensor)

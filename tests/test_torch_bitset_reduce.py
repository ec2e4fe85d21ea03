"""The port's ``popcount_reduce`` and ``masked_row_reduce`` (plain versions,
as the CPU runs them) against the JAX reference's Pallas kernels and its
plain versions, bitwise.

The reference's Pallas kernels run as ``tests/test_bitset_ops.py`` runs
them: interpret mode; ``masked_row_reduce`` at tile 32 and tile 128.
Inputs are made with numpy from a seed and handed to both packages.  The
selects cover bits at or above n (random words and all-ones words over
the whole last word) and empty selections.  Tolerance: bitwise (0).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import bitset_ops as j_ops
from repro.kernels import ref as j_ref
from repro_torch.convert import words
from repro_torch.kernels import bitset_ops, ref
from repro_torch.problems.graphs import num_words

#: (n, lanes): n on both sides of the word boundaries and above 1024
#: vertices (w = 35).
CASES = [(1, 3), (31, 5), (32, 4), (33, 6), (40, 7), (100, 5), (130, 3),
         (1100, 4)]
#: The cases also run through the reference's Pallas kernel (interpret
#: mode compiles each shape anew, about a second each), with its tile.
PALLAS_CASES = [(1, 3, 32), (33, 6, 128), (40, 7, 32), (100, 5, 128)]


def random_words(rng, shape):
    return rng.randint(0, 2 ** 32, size=shape, dtype=np.uint64).astype(
        np.uint32)


def make_case(n, lanes):
    rng = np.random.RandomState(1000 + n)
    w = num_words(n)
    table = random_words(rng, (n, w))
    select = random_words(rng, (lanes, w))   # bits >= n set in the last word
    select[0] = 0                            # empty selection: the identity
    select[1] = 0xFFFFFFFF                   # every bit, those >= n too
    return table, select


def port_reduce(table, select, op):
    out = bitset_ops.masked_row_reduce(words(table), words(select), op=op)
    return out.numpy().view(np.uint32)


@pytest.mark.parametrize("n,lanes", CASES)
@pytest.mark.parametrize("op", ["or", "and"])
def test_masked_row_reduce_equals_reference_plain(n, lanes, op):
    table, select = make_case(n, lanes)
    got = port_reduce(table, select, op)
    plain = np.asarray(j_ref.masked_row_reduce_ref(
        jnp.asarray(table), jnp.asarray(select), op=op))
    np.testing.assert_array_equal(got, plain)
    ident = 0 if op == "or" else 0xFFFFFFFF
    assert (got[0] == ident).all()


@pytest.mark.parametrize("n,lanes,tile", PALLAS_CASES)
@pytest.mark.parametrize("op", ["or", "and"])
def test_masked_row_reduce_equals_reference_kernel(n, lanes, tile, op):
    table, select = make_case(n, lanes)
    pallas = np.asarray(j_ops.masked_row_reduce(
        jnp.asarray(table), jnp.asarray(select), op=op, tile=tile,
        interpret=True))
    np.testing.assert_array_equal(port_reduce(table, select, op), pallas)


@pytest.mark.parametrize("n,lanes", CASES)
def test_popcount_reduce_equals_reference(n, lanes):
    _, select = make_case(n, lanes)
    got = bitset_ops.popcount_reduce(words(select)).numpy()
    plain = np.asarray(j_ref.popcount_reduce_ref(jnp.asarray(select)))
    np.testing.assert_array_equal(got, plain)
    if (n, lanes) in [c[:2] for c in PALLAS_CASES[1::2]]:
        pallas = np.asarray(j_ops.popcount_reduce(jnp.asarray(select),
                                                  interpret=True))
        np.testing.assert_array_equal(got, pallas)
    assert got.dtype == np.int32
    assert got[1] == 32 * select.shape[1]


def test_bits_at_or_above_n_select_nothing():
    """A select holding only bits >= n gives the identity."""
    n = 37
    table, _ = make_case(n, 2)
    select = np.zeros((2, num_words(n)), np.uint32)
    select[:, -1] = ~np.uint32((1 << (n - 32)) - 1)    # bits 37..63
    for op, ident in (("or", 0), ("and", -1)):
        got = bitset_ops.masked_row_reduce(words(table), words(select), op=op)
        assert (got == ident).all()


def test_reduce_rejects_bad_arguments():
    table, select = make_case(33, 3)
    t, s = words(table), words(select)
    with pytest.raises(ValueError):
        bitset_ops.masked_row_reduce(t, s, op="xor")
    with pytest.raises(ValueError):
        ref.masked_row_reduce_ref(t, s, op="xor")
    with pytest.raises(ValueError):
        bitset_ops.masked_row_reduce(t, s[:, :1])           # w mismatch
    with pytest.raises(TypeError):
        bitset_ops.popcount_reduce(s.to(torch.int64))
    with pytest.raises(ValueError):
        bitset_ops.popcount_reduce(s.t())                  # not contiguous
    assert bitset_ops.LAUNCHES["masked_row_reduce"] == 0   # no card here
    assert bitset_ops.LAUNCHES["popcount_reduce"] == 0

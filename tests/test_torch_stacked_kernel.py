"""The port's ``stacked_count_stats`` (plain version, as the CPU runs it)
against the JAX reference's kernel and its plain version, bitwise.

The reference's Pallas kernel runs as ``tests/test_bitset_ops.py`` runs
it: interpret mode, ``tile`` 8 or 16, both layouts (``stages`` 1 and 2).
Inputs are made with numpy from a seed and handed to both packages;
every case has at least one parked lane (``inst = -1``).  Tolerance:
bitwise (0).
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import bitset_ops as j_ops
from repro.kernels import ref as j_ref
from repro_torch.convert import words
from repro_torch.kernels import bitset_ops
from repro_torch.problems.graphs import circulant_graph, full_mask, num_words

#: (tile, stages) of the reference's kernel, cycled over the cases.
LAYOUTS = [(8, 1), (16, 2), (16, 1), (8, 2)]
CASES = [(k, n, lanes, *LAYOUTS[i % 4]) for i, (k, n, lanes) in enumerate(
    itertools.product((1, 3), (1, 31, 33, 40), (1, 7, 33)))]


def random_words(rng, shape):
    return rng.randint(0, 2 ** 32, size=shape, dtype=np.uint64).astype(
        np.uint32)


def make_case(rng, k, n, lanes, tied=False):
    w = num_words(n)
    if tied:
        # Circulant tables: every vertex has the same degree under the
        # full mask, so every count ties and the smallest valid id wins.
        tables = np.stack([circulant_graph(n, (1, 1 + s)).adj
                           for s in range(k)])
        mask = np.broadcast_to(full_mask(n), (lanes, w)).copy()
    else:
        tables = random_words(rng, (k, n, w))
        mask = random_words(rng, (lanes, w))
    valid = mask & random_words(rng, (lanes, w))
    valid[1::3] = mask[1::3]
    inst = rng.randint(-1, k, size=lanes).astype(np.int32)
    inst[0] = -1                                  # at least one parked lane
    return tables, inst, mask, valid


def port_out(tables, inst, mask, valid):
    return bitset_ops.stacked_count_stats(
        words(tables), torch.from_numpy(inst.copy()), words(mask),
        words(valid)).numpy()


def reference_out(tables, inst, mask, valid, tile, stages):
    args = [jnp.asarray(a) for a in (tables, inst, mask, valid)]
    kernel = np.asarray(j_ops.stacked_count_stats(
        *args, tile=tile, stages=stages, interpret=True))
    plain = np.asarray(j_ref.stacked_count_stats_ref(*args))
    return kernel, plain


@pytest.mark.parametrize("k,n,lanes,tile,stages", CASES)
def test_plain_version_equals_reference_kernel(k, n, lanes, tile, stages):
    rng = np.random.RandomState(1000 * k + 10 * n + lanes)
    case = make_case(rng, k, n, lanes)
    got = port_out(*case)
    kernel, plain = reference_out(*case, tile, stages)
    np.testing.assert_array_equal(got, kernel)
    np.testing.assert_array_equal(got, plain)
    parked = case[1] < 0
    np.testing.assert_array_equal(got[parked],
                                  np.tile([-1, -1, 0, 0], (parked.sum(), 1)))


@pytest.mark.parametrize("k,n,lanes,tile,stages", [(1, 33, 7, 8, 1),
                                                   (3, 40, 33, 16, 2)])
def test_all_tied_counts_pick_the_smallest_id(k, n, lanes, tile, stages):
    case = make_case(np.random.RandomState(n), k, n, lanes, tied=True)
    got = port_out(*case)
    kernel, plain = reference_out(*case, tile, stages)
    np.testing.assert_array_equal(got, kernel)
    np.testing.assert_array_equal(got, plain)


@pytest.mark.parametrize("k,n", [(2, 1025), (3, 1100), (2, 1500)])
@pytest.mark.parametrize("tied", [False, True])
def test_plain_version_equals_reference_above_1024_vertices(k, n, tied):
    """Rows of 33, 35 and 47 words (the kernel's wide path) with parked
    lanes and, for circulant tables, counts that all tie: the port's plain
    version against the reference's."""
    rng = np.random.RandomState(k * n)
    tables, inst, mask, valid = make_case(rng, k, n, 6, tied)
    plain = np.asarray(j_ref.stacked_count_stats_ref(
        *[jnp.asarray(a) for a in (tables, inst, mask, valid)]))
    got = port_out(tables, inst, mask, valid)
    np.testing.assert_array_equal(got, plain)
    assert (got[inst < 0] == [-1, -1, 0, 0]).all()
    if tied:
        live = (inst >= 0) & (np.arange(6) % 3 == 1)   # valid = the mask
        assert (got[live, 1] == 0).all()


def test_all_lanes_parked():
    tables, inst, mask, valid = make_case(np.random.RandomState(5), 3, 33, 7)
    inst[:] = -1
    got = port_out(tables, inst, mask, valid)
    np.testing.assert_array_equal(got, np.tile([-1, -1, 0, 0], (7, 1)))
    np.testing.assert_array_equal(
        got, reference_out(tables, inst, mask, valid, 8, 2)[0])


def test_wrapper_rejects_bad_arguments():
    t = torch.zeros((3, 40, 2), dtype=torch.int32)
    m = torch.zeros((5, 2), dtype=torch.int32)
    i = torch.zeros(5, dtype=torch.int32)
    call = bitset_ops.stacked_count_stats
    with pytest.raises(ValueError):
        call(t[0], i, m, m)                           # tables not 3-D
    with pytest.raises(ValueError):
        call(t, i[:4], m, m)                          # inst / lanes mismatch
    with pytest.raises(ValueError):
        call(t, i, m[:, :1], m[:, :1])                # row width mismatch
    with pytest.raises(ValueError):
        call(torch.zeros((0, 40, 2), dtype=torch.int32), i, m, m)
    with pytest.raises(ValueError):
        call(torch.zeros((3, 70, 2), dtype=torch.int32), i, m, m)  # n > 32w
    with pytest.raises(TypeError):
        call(t, i.long(), m, m)
    with pytest.raises(TypeError):
        call(t.long(), i, m, m)
    with pytest.raises(ValueError):
        call(t, i, m.t().contiguous().t(), m)         # not contiguous
    with pytest.raises(ValueError, match="instance id 3 >= K=3"):
        call(t, torch.tensor([0, 1, 2, 3, -1], dtype=torch.int32), m, m)
    assert call(t, i - 1, m, m).tolist() == [[-1, -1, 0, 0]] * 5
    assert bitset_ops.LAUNCHES["stacked_count_stats"] == 0   # no card here

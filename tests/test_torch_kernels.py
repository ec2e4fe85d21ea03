"""The port's masked-popcount pass against the JAX reference.

On the CPU, ``repro_torch.kernels.bitset_ops.count_stats`` runs its plain
PyTorch version; it must be bitwise equal to the reference Pallas kernel
(run in interpret mode, as the reference's own tests run it) and to its
bindings ``degree_stats`` and ``domination_stats``.  Inputs are made with
numpy from a seed and handed to both packages as numpy arrays.  The CUDA
kernel itself is held against the plain version on the card by
``test_torch_gpu.py`` and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import bitset_degree as jdeg
from repro.kernels import bitset_ops as jops
from repro.kernels import ref as jref
from repro.problems import graphs as jgraphs
from repro_torch.convert import words
from repro_torch.kernels import bitset_degree, bitset_ops, ref
from repro_torch.problems import graphs as tgraphs
from repro_torch.problems.vertex_cover import BIT_WORDS, vbit


def random_words(rng, shape):
    return rng.randint(0, 2 ** 32, size=shape, dtype=np.uint64).astype(
        np.uint32)


def random_case(rng, n, lanes):
    """Random table, mask and valid bits; every third lane has nothing
    valid."""
    w = tgraphs.num_words(n)
    table = random_words(rng, (n, w)) & tgraphs.full_mask(n)[None, :]
    mask = random_words(rng, (lanes, w))
    valid = mask & random_words(rng, (lanes, w))
    valid[::3] = 0
    return table, mask, valid


def tied_case(rng, n, lanes):
    """A circulant graph under the full mask: every degree ties, so the
    smallest valid id must win."""
    g = tgraphs.circulant_graph(n, (1, 7))
    mask = np.broadcast_to(tgraphs.full_mask(n), (lanes, g.words)).copy()
    valid = mask & random_words(rng, mask.shape)
    valid[::2] = mask[::2]
    return g.adj, mask, valid


def port_count_stats(table, mask, valid):
    return bitset_ops.count_stats(words(table), words(mask),
                                  words(valid)).numpy()


# -- numpy substrate ---------------------------------------------------------

@pytest.mark.parametrize("spec", ["gnp:40:20:3", "reg:36:4:3", "cell60",
                                  "gnp:100:10:7", "gnp:33:50:1"])
def test_graph_tables_equal_reference_byte_for_byte(spec):
    a = tgraphs.parse_graph_instance(spec)
    b = jgraphs.parse_graph_instance(spec)
    assert (a.n, a.name, a.m) == (b.n, b.name, b.m)
    assert a.adj.dtype == b.adj.dtype == np.uint32
    assert a.adj.tobytes() == b.adj.tobytes()
    np.testing.assert_array_equal(a.degrees(), b.degrees())
    assert tgraphs.full_mask(a.n).tobytes() == jgraphs.full_mask(b.n).tobytes()
    for v in (0, 31, a.n - 1):
        assert tgraphs.bit(v, a.words).tobytes() == \
            jgraphs.bit(v, b.words).tobytes()


def test_popcount_matches_numpy():
    rng = np.random.RandomState(0)
    x = np.concatenate([random_words(rng, (1000,)),
                        np.array([0, 1, 0x80000000, 0xFFFFFFFF,
                                  0x7FFFFFFF, 0x55555555], np.uint32)])
    want = np.bitwise_count(x).astype(np.int64)
    np.testing.assert_array_equal(ref.popcount(words(x)).numpy(), want)
    np.testing.assert_array_equal(tgraphs.popcount(x), want)


def test_vbit_sets_the_reference_bits_up_to_bit_31():
    w = 2
    v = torch.tensor([0, 5, 31, 32, 63], dtype=torch.int32)
    got = vbit(v, w, words(BIT_WORDS)).numpy().view(np.uint32)
    want = np.stack([jgraphs.bit(int(i), w) for i in v])
    np.testing.assert_array_equal(got, want)
    assert got[2, 0] == np.uint32(1 << 31)


# -- plain count_stats == reference Pallas kernel (interpret mode) ----------

@pytest.mark.parametrize("n,lanes,kind,stages", [
    (1, 3, "random", 2), (31, 7, "random", 1), (33, 7, "random", 2),
    (100, 9, "random", 2), (130, 6, "random", 1), (64, 5, "tied", 2),
    (100, 4, "tied", 1),
])
def test_count_stats_plain_equals_reference_kernel(n, lanes, kind, stages):
    rng = np.random.RandomState(n * 31 + lanes)
    make = random_case if kind == "random" else tied_case
    table, mask, valid = make(rng, n, lanes)
    want = np.asarray(jops.count_stats(
        jnp.asarray(table), jnp.asarray(mask), jnp.asarray(valid),
        tile=32, stages=stages, interpret=True))
    got = port_count_stats(table, mask, valid)
    assert got.dtype == np.int32 and got.shape == (lanes, 4)
    np.testing.assert_array_equal(got, want)
    if kind == "tied":
        # Every fully valid lane ties at degree 4: vertex 0 wins.
        np.testing.assert_array_equal(got[::2, :2], [[4, 0]] * len(got[::2]))


def test_count_stats_all_invalid_lanes():
    g = tgraphs.circulant_graph(96, (1, 7))
    full = tgraphs.full_mask(96)[None, :]
    got = port_count_stats(g.adj, np.repeat(full, 3, 0),
                           np.zeros((3, g.words), np.uint32))
    np.testing.assert_array_equal(got, [[-1, -1, 0, 96]] * 3)
    want = np.asarray(jops.count_stats(
        jnp.asarray(g.adj), jnp.asarray(np.repeat(full, 3, 0)),
        jnp.zeros((3, g.words), jnp.uint32), tile=32, interpret=True))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,lanes", [(45, 6), (70, 5)])
def test_bindings_equal_reference(n, lanes):
    rng = np.random.RandomState(n)
    g = tgraphs.gnp_graph(n, 0.2, seed=n)
    alive = random_words(rng, (lanes, g.words)) & tgraphs.full_mask(n)
    alive[0] = 0
    want = np.asarray(jdeg.degree_stats(jnp.asarray(g.adj),
                                        jnp.asarray(alive), tile=32,
                                        interpret=True))
    got = bitset_degree.degree_stats(words(g.adj), words(alive)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        bitset_degree.degree_argmax(words(g.adj), words(alive)).numpy(),
        want[:, :2])

    from repro.problems.dominating_set import _closed_adj as j_closed
    from repro_torch.problems.dominating_set import _closed_adj
    cadj = _closed_adj(g)
    assert cadj.tobytes() == j_closed(jgraphs.parse_graph_instance(
        f"gnp:{n}:20:{n}")).tobytes()
    dominated = random_words(rng, (lanes, g.words))
    cand = random_words(rng, (lanes, g.words)) & tgraphs.full_mask(n)
    cand[1] = 0
    fullm = tgraphs.full_mask(n)
    want = np.asarray(jops.domination_stats(
        jnp.asarray(cadj), jnp.asarray(dominated), jnp.asarray(cand),
        jnp.asarray(fullm), tile=32, interpret=True))
    got = bitset_ops.domination_stats(words(cadj), words(dominated),
                                      words(cand), words(fullm)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        ref.domination_stats_ref(words(cadj), words(dominated), words(cand),
                                 words(fullm)).numpy(), want)


# -- graphs above 1024 vertices: rows of more than 32 words ------------------

@pytest.mark.parametrize("n", [1025, 1100, 1500])
@pytest.mark.parametrize("kind", ["random", "tied"])
def test_count_stats_plain_equals_reference_above_1024_vertices(n, kind):
    """w = 33, 35 and 47 words, the widths of the kernel's wide path: the
    port's plain version against the reference's, with lanes that have
    nothing valid (random) and counts that all tie (circulant)."""
    rng = np.random.RandomState(n + len(kind))
    make = random_case if kind == "random" else tied_case
    table, mask, valid = make(rng, n, 5)
    want = np.asarray(jref.count_stats_ref(
        jnp.asarray(table), jnp.asarray(mask), jnp.asarray(valid)))
    got = port_count_stats(table, mask, valid)
    np.testing.assert_array_equal(got, want)
    if kind == "tied":
        np.testing.assert_array_equal(got[::2, :2], [[4, 0]] * 3)
    else:
        np.testing.assert_array_equal(got[::3, :3], [[-1, -1, 0]] * 2)


# -- the wrapper's contract ---------------------------------------------------

def test_cpu_tensors_run_the_plain_version_and_count_no_launch():
    rng = np.random.RandomState(1)
    table, mask, valid = random_case(rng, 40, 4)
    bitset_ops.reset_launches()
    got = port_count_stats(table, mask, valid)
    assert bitset_ops.LAUNCHES["count_stats"] == 0
    np.testing.assert_array_equal(
        got, ref.count_stats_ref(words(table), words(mask),
                                 words(valid)).numpy())


def test_count_stats_rejects_what_the_kernel_does_not_take():
    t = torch.zeros((40, 2), dtype=torch.int32)
    m = torch.zeros((3, 2), dtype=torch.int32)
    with pytest.raises(TypeError):
        bitset_ops.count_stats(t.to(torch.int64), m, m)
    with pytest.raises(ValueError):
        bitset_ops.count_stats(t, m, torch.zeros((3, 3), dtype=torch.int32))
    with pytest.raises(ValueError):
        bitset_ops.count_stats(t, torch.zeros((3, 4), dtype=torch.int32)
                               [:, ::2], m)
    with pytest.raises(ValueError):
        bitset_ops.count_stats(torch.zeros((65, 2), dtype=torch.int32), m, m)
    with pytest.raises(ValueError):
        bitset_ops.count_stats(t[0], m, m)

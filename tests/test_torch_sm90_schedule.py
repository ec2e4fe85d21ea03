"""Host-side logic of the port's two Hopper kernels, checked on the CPU.

``flash_attention``'s bf16 kernel: the key tiles each query tile visits,
the heaviest-first order of the query tiles and the tiles that need a mask
(written out below as the kernel computes them from its block index,
``csrc/flash_attention.cu``, namespace ``sm90``), held against a
brute-force mask; and the padding of the head dim to whole swizzle atoms.

``count_stats``: the kernel's decomposition of the pass into binary
products (16 lanes x 8 vertices x 256 bits, words 8s + q and 8s + 4 + q
of k-step s paired, zero past w and past n), eight warps taking every
eighth 8-vertex tile, a strict running best per thread over ascending
vertices and a 64-bit key reduction, written out in numpy.  It must be
bitwise equal to the port's plain version and to the reference's jnp and
Pallas (interpret mode) versions, for n in {1, 31, 33, 300} and w up to 32.

Rows of more than 32 words (n > 1024) take ``count_stats_wide_kernel``:
the same tiles with the k-steps a loop whose A fragments are loaded at
each step, and the mask count summed over words q, q + 4, ... by each
thread of a quad; held at w in {33, 35, 47, 64}.

``stacked_count_stats`` (``csrc/stacked_count_stats.cu``): a warp per
lane against its own instance's table, thread t taking vertices 32 i + t
for i below the template bound on w that the launcher picks (every word
of the row on the wide path, w > 32), the best 64-bit key of each thread
reduced over the warp, a parked lane (id < 0) writing (-1, -1, 0, 0),
written out in numpy.  It must be bitwise equal to the port's plain
version and to the reference's Pallas kernel at ``stages`` 1 and 2
(interpret mode) on interleaved, sorted, one-instance, partly parked and
all-parked ids, all-tied tables and more instances than a warp has
threads, and cover every vertex at each template bound.  Ids at or above
K lie outside the contract and are not drawn.

``masked_row_reduce`` (``csrc/masked_row_reduce.cu``): blocks of 32 lanes
(16 warps of 2), passes of at most 16 words, the table staged in stages of
whole 32-row groups under a fixed budget with the select words beside
them, thread t folding (bit ? row : identity) of the vertices 32 i + t
into registers through a mask made by two shifts from the select word
with its bits >= n cleared, and REDUX over the warp's 32 threads; stale
rows past n in shared memory.  It must be bitwise equal to the port's
plain version and the reference's for OR and AND, with bits >= n set, an
empty and an all-ones select.

``popcount_reduce`` (``csrc/popcount_reduce.cu``): a sub-warp of w
rounded up to a power of two (at most 32) threads per row.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import bitset_ops as jops
from repro.kernels import ref as jref
from repro_torch.convert import words
from repro_torch.kernels import flash_attention as flash
from repro_torch.kernels import ref


# -- flash_attention: the tile schedule ---------------------------------------

#: The bf16 kernel's tiles: 128 query rows per block (two warpgroups of
#: 64), K/V tiles of 128 keys, 64-column swizzle atoms of 128-byte rows.
BLOCK_Q = BLOCK_K = 128
WARPGROUP_ROWS = 64
ATOM_COLS = 64


def head_dim_pad(hd):
    """Columns the kernel stages per row: whole atoms (its launcher takes
    hd = 64 as one atom, 80 and 128 as two; TMA fills past hd with 0)."""
    return ATOM_COLS * -(-hd // ATOM_COLS)


def key_tiles(q_tile, s, window):
    """The key tiles the kernel visits for query tile ``q_tile``
    (``kt_first`` .. ``kt_last``)."""
    q0 = q_tile * BLOCK_Q
    first = max(0, q0 - window + 1) if window else 0
    last = min(q0 + BLOCK_Q, s) - 1
    return range(first // BLOCK_K, last // BLOCK_K + 1)


def tile_order(s):
    """Query tiles in launch order: block y runs tile n - 1 - y."""
    n = -(-s // BLOCK_Q)
    return [n - 1 - y for y in range(n)]


def needs_mask(row0, k0, window):
    """The kernel's ``masked``: does key tile ``k0`` hide a key from a row
    of the warpgroup whose rows are ``row0 .. row0 + 63``?"""
    causal = k0 + BLOCK_K - 1 > row0
    return causal or bool(window) and k0 <= row0 + WARPGROUP_ROWS - 1 - window


def visible(rows, keys, s, window):
    """bool[rows, keys]: causal (and window) visibility of real keys."""
    r, k = np.asarray(rows)[:, None], np.asarray(keys)[None, :]
    ok = (k <= r) & (k < s)
    if window:
        ok &= r - k < window
    return ok


SCHEDULES = [(1, None), (100, None), (128, None), (129, None), (300, 50),
             (640, 50), (1000, 128), (1000, 129), (300, 1000), (4096, None),
             (8192, 4096), (777, 300)]


@pytest.mark.parametrize("s,window", SCHEDULES)
def test_key_tiles_are_the_tiles_with_a_visible_key(s, window):
    n_k = -(-s // BLOCK_K)
    for qt in range(-(-s // BLOCK_Q)):
        q0 = qt * BLOCK_Q
        rows = np.arange(q0, min(q0 + BLOCK_Q, s))
        want = [kt for kt in range(n_k) if visible(
            rows, np.arange(kt * BLOCK_K, (kt + 1) * BLOCK_K),
            s, window).any()]
        assert list(key_tiles(qt, s, window)) == want


@pytest.mark.parametrize("s,window", SCHEDULES)
def test_query_tiles_run_heaviest_first(s, window):
    order = tile_order(s)
    assert sorted(order) == list(range(-(-s // BLOCK_Q)))
    work = [len(key_tiles(qt, s, window)) for qt in order]
    assert work == sorted(work, reverse=True)
    assert order[0] == len(order) - 1          # the last causal tile first


@pytest.mark.parametrize("window", [None, 1, 50, 64, 127, 128, 129, 300,
                                    4096])
def test_mask_is_applied_exactly_where_a_key_is_hidden(window):
    s = 1 << 20                                 # no key past the end here
    for row0 in range(0, 1024, WARPGROUP_ROWS):
        rows = np.arange(row0, row0 + WARPGROUP_ROWS)
        for k0 in range(0, row0 + BLOCK_K, BLOCK_K):
            keys = np.arange(k0, k0 + BLOCK_K)
            hidden = not visible(rows, keys, s, window).all()
            assert needs_mask(row0, k0, window) == hidden, (row0, k0)


def test_a_ragged_tile_is_masked():
    """Keys past S lie after every real row, so the causal test masks the
    tile that holds them (here S = 200)."""
    for row0 in (128, 192):
        assert needs_mask(row0, 128, None)


@pytest.mark.parametrize("hd,pad", [(16, 64), (64, 64), (80, 128),
                                    (96, 128), (128, 128)])
def test_head_dim_pads_to_whole_atoms(hd, pad):
    assert head_dim_pad(hd) == pad
    for hd_k in flash.HEAD_DIMS:
        assert head_dim_pad(hd_k) % ATOM_COLS == 0
        assert 2 * hd_k % 16 == 0       # TMA strides: multiples of 16 bytes


# -- count_stats: the binary-product decomposition ---------------------------

def popcount(x):
    return np.bitwise_count(np.asarray(x, np.uint32)).astype(np.int64)


def count_stats_tiles(table, mask, valid, warps=8):
    """``count_stats`` as the CUDA kernel decomposes it (see
    ``csrc/count_stats.cu``): returns int32[L, 4]."""
    n, w = table.shape
    lanes = mask.shape[0]
    ks = -(-w // 8)
    groups = -(-n // 32)                        # valid words per lane
    a = np.zeros((-(-lanes // 16) * 16, 8 * ks), np.uint32)
    a[:lanes, :w] = mask
    b = np.zeros((32 * groups, 8 * ks), np.uint32)
    b[:n, :w] = table
    vd = np.zeros((a.shape[0], w), np.uint32)
    vd[:lanes] = valid
    out = np.zeros((lanes, 4), np.int64)
    for lane0 in range(0, a.shape[0], 16):
        rows = a[lane0:lane0 + 16]
        keys = np.zeros((warps, 16), np.uint64)
        sums = np.zeros((warps, 16), np.int64)
        for p in range(warps):
            # Thread (g, q) of warp p: lanes g and g + 8, vertices 2q, 2q+1
            # of each 8-vertex tile; a strict best over ascending vertices.
            best = np.full((16, 4), -1)
            arg = np.full((16, 4), -1)
            part = np.zeros((16, 4), np.int64)
            for tile in range(p, -(-n // 8), warps):
                v0, i = 8 * tile, tile // 4
                d = np.zeros((16, 8), np.int64)
                for s in range(ks):
                    for q in range(4):
                        for k in (8 * s + q, 8 * s + 4 + q):
                            d += popcount(rows[:, k:k + 1]
                                          & b[None, v0:v0 + 8, k])
                shift = 8 * (tile % 4)
                bits = vd[lane0:lane0 + 16, i:i + 1] >> np.arange(
                    shift, shift + 8, dtype=np.uint32)[None]
                for q in range(4):
                    for c in range(2):
                        v = v0 + 2 * q + c
                        if v >= n:
                            continue
                        ok = (bits[:, 2 * q + c] & 1) == 1
                        cnt = d[:, 2 * q + c]
                        part[:, q] += np.where(ok, cnt, 0)
                        better = ok & (cnt > best[:, q])
                        best[:, q] = np.where(better, cnt, best[:, q])
                        arg[:, q] = np.where(better, v, arg[:, q])
            key = np.where(best < 0, 0, ((best + 1).astype(np.uint64) << 32)
                           | (0xFFFFFFFF - arg.astype(np.int64)
                              ).astype(np.uint64))
            keys[p] = key.max(axis=1)
            sums[p] = part.sum(axis=1)
        key = keys.max(axis=0)
        bst = (key >> np.uint64(32)).astype(np.int64) - 1
        low = (key & np.uint64(0xFFFFFFFF)).astype(np.int64)
        n_out = min(16, lanes - lane0)
        out[lane0:lane0 + n_out, 0] = bst[:n_out]
        out[lane0:lane0 + n_out, 1] = np.where(bst < 0, -1,
                                               0xFFFFFFFF - low)[:n_out]
        out[lane0:lane0 + n_out, 2] = sums.sum(axis=0)[:n_out]
        out[lane0:lane0 + n_out, 3] = popcount(
            rows[:n_out]).sum(axis=1)
    return out.astype(np.int32)


def count_stats_wide_tiles(table, mask, valid, warps=8):
    """``count_stats_wide_kernel`` (w > 32) as it computes: each quad
    thread q counts the mask words q, q + 4, ...; each tile runs the
    k-steps as a loop, loading step s's A fragments (words 8s + q and
    8s + 4 + q of the 16 lanes, 0 past w and past the lanes) and B
    fragments (0 past w and past n) where the product needs them; then
    ``count_stats_kernel``'s epilogue.  Returns int32[L, 4]."""
    n, w = table.shape
    lanes = mask.shape[0]
    ks = -(-w // 8)
    out = np.zeros((lanes, 4), np.int64)
    for lane0 in range(0, lanes, 16):
        live = min(16, lanes - lane0)

        def words_of(src, rows, ids, k):
            """src[rows, k] with 0 where a row is past ``ids`` or k >= w."""
            got = np.zeros(len(rows), np.uint32)
            ok = rows < ids
            if k < w:
                got[ok] = src[rows[ok], k]
            return got

        lane_ids = lane0 + np.arange(16)
        mcount = np.zeros((16, 4), np.int64)      # per lane row, per q
        for q in range(4):
            for k in range(q, w, 4):
                mcount[:, q] += popcount(words_of(mask, lane_ids, lanes, k))
        keys = np.zeros((warps, 16), np.uint64)
        sums = np.zeros((warps, 16), np.int64)
        for p in range(warps):
            best = np.full((16, 4), -1)
            arg = np.full((16, 4), -1)
            part = np.zeros((16, 4), np.int64)
            for tile in range(p, -(-n // 8), warps):
                v0, i = 8 * tile, tile // 4
                cols = v0 + np.arange(8)
                d = np.zeros((16, 8), np.int64)
                for s in range(ks):                # A reloaded each step
                    for q in range(4):
                        for k in (8 * s + q, 8 * s + 4 + q):
                            a = words_of(mask, lane_ids, lanes, k)
                            b = words_of(table, cols, n, k)
                            d += popcount(a[:, None] & b[None, :])
                vw = np.zeros(16, np.uint32)
                vw[:live] = valid[lane0:lane0 + live, i]
                bits = vw[:, None] >> np.arange(8 * (tile % 4),
                                                8 * (tile % 4) + 8,
                                                dtype=np.uint32)[None]
                for q in range(4):
                    for c in range(2):
                        v = v0 + 2 * q + c
                        if v >= n:
                            continue
                        ok = (bits[:, 2 * q + c] & 1) == 1
                        cnt = d[:, 2 * q + c]
                        part[:, q] += np.where(ok, cnt, 0)
                        better = ok & (cnt > best[:, q])
                        best[:, q] = np.where(better, cnt, best[:, q])
                        arg[:, q] = np.where(better, v, arg[:, q])
            key = np.where(best < 0, 0, ((best + 1).astype(np.uint64) << 32)
                           | (0xFFFFFFFF - arg.astype(np.int64)
                              ).astype(np.uint64))
            keys[p] = key.max(axis=1)
            sums[p] = part.sum(axis=1)
        key = keys.max(axis=0)
        bst = (key >> np.uint64(32)).astype(np.int64) - 1
        low = (key & np.uint64(0xFFFFFFFF)).astype(np.int64)
        out[lane0:lane0 + live, 0] = bst[:live]
        out[lane0:lane0 + live, 1] = np.where(bst < 0, -1,
                                              0xFFFFFFFF - low)[:live]
        out[lane0:lane0 + live, 2] = sums.sum(axis=0)[:live]
        out[lane0:lane0 + live, 3] = mcount.sum(axis=1)[:live]
    return out.astype(np.int32)


def random_words(rng, shape):
    return rng.randint(0, 2 ** 32, size=shape, dtype=np.uint64).astype(
        np.uint32)


def wide_case(rng, n, w, lanes):
    """Random inputs with lanes that have nothing valid, bits past n set,
    and a lane whose counts all tie at 0."""
    table = random_words(rng, (n, w))
    mask = random_words(rng, (lanes, w))
    valid = mask & random_words(rng, (lanes, w))
    valid[::4] = 0                              # nothing valid
    valid[1::4] = 0xFFFFFFFF                    # bits past n set too
    mask[2] = 0                                 # every count 0: all tie
    valid[2] = 0xFFFFFFFF
    return table, mask, valid


@pytest.mark.parametrize("n,w", [(1025, 33), (1056, 33), (1100, 35),
                                 (1500, 47), (1500, 64), (2048, 64)])
def test_count_stats_wide_tiles_equal_the_plain_and_reference_passes(n, w):
    rng = np.random.RandomState(n + w)
    lanes = 21                  # not a multiple of the 16 lanes of a block
    table, mask, valid = wide_case(rng, n, w, lanes)
    got = count_stats_wide_tiles(table, mask, valid)
    plain = ref.count_stats_ref(words(table), words(mask),
                                words(valid)).numpy()
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_array_equal(got, np.asarray(jref.count_stats_ref(
        *(jnp.asarray(x) for x in (table, mask, valid)))))
    np.testing.assert_array_equal(got, count_stats_tiles(table, mask, valid))
    assert (got[::4, :3] == [-1, -1, 0]).all()
    assert (got[2, :2] == [0, 0]).all()         # smallest valid id wins


@pytest.mark.parametrize("n,w", [(1, 1), (1, 9), (31, 1), (31, 32),
                                 (33, 2), (33, 17), (300, 10), (300, 24),
                                 (300, 32)])
def test_count_stats_tiles_equal_the_plain_and_reference_passes(n, w):
    rng = np.random.RandomState(n * 33 + w)
    lanes = 21                  # not a multiple of the 16 lanes of a block
    table = random_words(rng, (n, w))
    mask = random_words(rng, (lanes, w))
    valid = mask & random_words(rng, (lanes, w))
    valid[::4] = 0                              # nothing valid
    valid[1::4] = 0xFFFFFFFF                    # bits past n set too
    mask[2] = 0                                 # every count 0: all tie
    valid[2] = 0xFFFFFFFF
    got = count_stats_tiles(table, mask, valid)
    plain = ref.count_stats_ref(words(table), words(mask),
                                words(valid)).numpy()
    np.testing.assert_array_equal(got, plain)
    jt, jm, jv = (jnp.asarray(x) for x in (table, mask, valid))
    np.testing.assert_array_equal(got, np.asarray(jref.count_stats_ref(
        jt, jm, jv)))
    np.testing.assert_array_equal(got, np.asarray(jops.count_stats(
        jt, jm, jv, tile=32, interpret=True)))
    assert (got[::4, :3] == [-1, -1, 0]).all()
    assert (got[2, :2] == [0, 0]).all()         # smallest valid id wins


# -- stacked_count_stats: a warp per lane ----------------------------------

def template_words(w):
    """The launcher's compile-time bound on w (MAXW); None on the wide
    path (w > 32), whose threads walk every word of the row."""
    return next((m for m in (2, 4, 8, 16, 32) if w <= m), None)


def stacked_count_stats_warps(tables, inst, mask, valid):
    """``stacked_count_stats`` as the CUDA kernel computes it: returns
    int32[L, 4]."""
    k, n, w = tables.shape
    maxw = template_words(w)
    lanes = len(inst)
    out = np.zeros((lanes, 4), np.int64)
    v = np.arange(n)
    for lane in range(lanes):
        i = inst[lane]
        if i < 0 or i >= k:                     # parked: reads no table
            out[lane] = [-1, -1, 0, 0]
            continue
        counts = popcount(tables[i] & mask[lane][None]).sum(axis=1)
        bits = (valid[lane][v // 32] >> (v % 32)) & 1
        # Thread t of the warp takes vertices 32 j + t, j < min(w, MAXW),
        # or j < ceil(n / 32) on the wide path.
        keys = np.zeros(32, np.uint64)
        sums = np.zeros(32, np.int64)
        groups = maxw if maxw is not None else -(-n // 32)
        for t in range(32):
            for j in range(groups):
                u = 32 * j + t
                if j < w and u < n and bits[u]:
                    sums[t] += counts[u]
                    cand = (int(counts[u]) + 1) << 32 | (0xFFFFFFFF - u)
                    keys[t] = max(int(keys[t]), cand)
        key = int(keys.max())                   # the shuffle reduction
        best = (key >> 32) - 1
        out[lane] = [best, -1 if best < 0 else 0xFFFFFFFF - (key & 0xFFFFFFFF),
                     sums.sum(), popcount(mask[lane]).sum()]
    return out.astype(np.int32)


def stacked_layout(rng, layout, k, lanes):
    """Instance ids of a layout; every one below K."""
    if layout in ("interleaved", "ragged L", "all tied"):
        return (np.arange(lanes) % k).astype(np.int32)
    if layout == "sorted":
        return np.sort(rng.randint(0, k, size=lanes)).astype(np.int32)
    if layout == "one instance":
        return np.full(lanes, k - 1, np.int32)
    inst = rng.randint(-1, k, size=lanes).astype(np.int32)
    inst[::3] = -1
    if layout == "all parked":
        inst[:] = -1
    return inst


#: (layout, K, n, lanes): the id layouts the service and phase 6 of
#: ``chip_smoke.py`` hand the kernel; n = 33 and 40 take two words.
STACKED_LAYOUTS = [("interleaved", 16, 33, 512), ("sorted", 3, 31, 300),
                   ("one instance", 2, 40, 300), ("mixed parked", 3, 33, 70),
                   ("all parked", 3, 33, 40), ("ragged L", 5, 20, 300),
                   ("all tied", 4, 40, 64),
                   ("many instances", 40, 33, 256)]


@pytest.mark.parametrize("layout,k,n,lanes", STACKED_LAYOUTS)
def test_lane_warps_equal_the_plain_and_reference_passes(layout, k, n,
                                                         lanes):
    from repro_torch.problems.graphs import circulant_graph, full_mask
    rng = np.random.RandomState(lanes + k)
    w = -(-n // 32)
    if layout == "all tied":
        tables = np.stack([circulant_graph(n, (1, 2 + s)).adj
                           for s in range(k)])
        mask = np.broadcast_to(full_mask(n), (lanes, w)).copy()
    else:
        tables = random_words(rng, (k, n, w))
        mask = random_words(rng, (lanes, w))
    valid = mask & random_words(rng, (lanes, w))
    valid[1::5] = mask[1::5]
    inst = stacked_layout(rng, layout, k, lanes)
    got = stacked_count_stats_warps(tables, inst, mask, valid)
    plain = ref.stacked_count_stats_ref(
        words(tables), torch.from_numpy(inst.copy()), words(mask),
        words(valid)).numpy()
    np.testing.assert_array_equal(got, plain)
    args = [jnp.asarray(x) for x in (tables, inst, mask, valid)]
    for stages in (1, 2):
        np.testing.assert_array_equal(got, np.asarray(
            jops.stacked_count_stats(*args, tile=16, stages=stages,
                                     interpret=True)))
    parked = inst < 0
    assert (got[parked] == [-1, -1, 0, 0]).all()
    if layout == "all tied":          # full masks: every count ties
        bits = (valid[:, np.arange(n) // 32] >> (np.arange(n) % 32)) & 1
        first = np.where(bits.any(1), bits.argmax(1), -1)
        np.testing.assert_array_equal(got[:, 1], first)


@pytest.mark.parametrize("w", [1, 2, 3, 4, 5, 8, 9, 16, 17, 31, 32, 33,
                               35, 47, 64])
def test_lane_warps_cover_every_vertex_at_each_template_bound(w):
    """n = 32 w, the most a row of w words holds, with every vertex valid
    and the last one the only maximum: the threads' vertices 32 j + t,
    j < min(w, MAXW), must reach it."""
    rng = np.random.RandomState(w)
    k, n, lanes = 3, 32 * w, 9
    tables = random_words(rng, (k, n, w)) & np.uint32(0x0F0F0F0F)
    tables[:, n - 1] = 0xFFFFFFFF
    mask = np.full((lanes, w), 0xFFFFFFFF, np.uint32)
    valid = mask.copy()
    inst = (np.arange(lanes) % (k + 1) - 1).astype(np.int32)  # -1 parked
    got = stacked_count_stats_warps(tables, inst, mask, valid)
    plain = ref.stacked_count_stats_ref(
        words(tables), torch.from_numpy(inst), words(mask),
        words(valid)).numpy()
    np.testing.assert_array_equal(got, plain)
    live = inst >= 0
    assert (got[live, 1] == n - 1).all() and (got[live, 0] == n).all()


# -- masked_row_reduce: branch-free folds and REDUX ------------------------

#: ``csrc/masked_row_reduce.cu``: 16 warps of 2 lanes a block, passes of
#: at most 16 words, 32 KB of shared memory a stage, the select words of a
#: 32-row group at a pitch of 33.
MRR_WARPS, MRR_LANES_PER_WARP = 16, 2
MRR_BLOCK_LANES = MRR_WARPS * MRR_LANES_PER_WARP
MRR_MAX_CHUNK, MRR_STAGE_BYTES = 16, 32 * 1024
MRR_SEL_PITCH = MRR_BLOCK_LANES + 1


def row_pitch(wc):
    """Words per staged row: an odd number of 16-byte groups."""
    return 4 * (-(-wc // 4) | 1)


def stage_rows(n, wc):
    group_bytes = 4 * (32 * row_pitch(wc) + MRR_SEL_PITCH)
    return 32 * min(MRR_STAGE_BYTES // group_bytes, -(-n // 32))


def pass_words(w):
    """WC: the words of each pass, passes of equal width at most 16."""
    passes = -(-w // MRR_MAX_CHUNK)
    return -(-w // passes)


def masked_row_reduce_warps(table, select, op):
    """``masked_row_reduce`` as the CUDA kernel computes it: returns
    uint32[L, w].  Shared memory starts as garbage, so the stale rows past
    n that the last group reads are garbage too."""
    n, w = table.shape
    lanes = select.shape[0]
    is_and = op == "and"
    ident = np.uint32(0xFFFFFFFF if is_and else 0)
    wc, t = pass_words(w), np.arange(32, dtype=np.uint64)
    rows_per_stage = stage_rows(n, wc)
    garbage = np.random.RandomState(n)
    out = np.zeros((lanes, w), np.uint32)
    for b0 in range(0, lanes, MRR_BLOCK_LANES):
        s_rows = random_words(garbage, (rows_per_stage, row_pitch(wc)))
        for c0 in range(0, w, wc):
            acc = np.full((MRR_BLOCK_LANES, 32, wc), ident)  # lane, thread
            for r0 in range(0, n, rows_per_stage):
                rows = min(rows_per_stage, n - r0)
                groups, g0 = -(-rows // 32), r0 // 32
                words_in = min(wc, w - c0)
                s_rows[:rows, :wc] = 0
                s_rows[:rows, :words_in] = table[r0:r0 + rows,
                                                 c0:c0 + words_in]
                s_sel = np.zeros((groups, MRR_SEL_PITCH), np.uint32)
                for g in range(groups):
                    live = select[b0:b0 + MRR_BLOCK_LANES, g0 + g]
                    s_sel[g, :len(live)] = live
                for g in range(groups):
                    row = s_rows[32 * g + np.arange(32), :wc]  # [thread, k]
                    left = n - 32 * (g0 + g)     # bits >= n select nothing
                    lim = 0xFFFFFFFF if left >= 32 else (1 << left) - 1
                    sel = (s_sel[g, :MRR_BLOCK_LANES]
                           & np.uint32(lim)).astype(np.uint64)
                    shifted = (sel[:, None] << (31 - t)[None]) & 0xFFFFFFFF
                    m = (shifted.astype(np.uint32).view(np.int32) >> 31
                         ).view(np.uint32)[:, :, None]   # [lane, thread, 1]
                    acc = (acc & (row[None] | ~m) if is_and
                           else acc | (row[None] & m))
            red = (np.bitwise_and.reduce(acc, axis=1) if is_and
                   else np.bitwise_or.reduce(acc, axis=1))   # REDUX
            live = min(MRR_BLOCK_LANES, lanes - b0)
            words_out = min(wc, w - c0)
            out[b0:b0 + live, c0:c0 + words_out] = red[:live, :words_out]
    return out


#: (n, w): the port's widths on both sides of a word and of 1024 vertices
#: (w = 33 and 47 run in passes of 11 and 16 words, and n = 1500 in four
#: stages), and rows wider than n needs.
MRR_CASES = [(1, 1), (31, 1), (32, 1), (33, 2), (300, 10), (1025, 33),
             (1500, 47), (33, 20), (300, 40)]


@pytest.mark.parametrize("n,w", MRR_CASES)
@pytest.mark.parametrize("op", ["or", "and"])
def test_masked_row_reduce_warps_equal_the_plain_and_reference(n, w, op):
    rng = np.random.RandomState(n * 7 + w)
    lanes = 37                    # a block of 32 lanes and a ragged one
    table = random_words(rng, (n, w))
    select = random_words(rng, (lanes, w))     # bits >= n set too
    select[0] = 0                              # empty: the identity
    select[1] = 0xFFFFFFFF                     # all ones
    got = masked_row_reduce_warps(table, select, op)
    plain = ref.masked_row_reduce_ref(words(table), words(select),
                                      op=op).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_array_equal(got, np.asarray(jref.masked_row_reduce_ref(
        jnp.asarray(table), jnp.asarray(select), op=op)))
    assert (got[0] == (0xFFFFFFFF if op == "and" else 0)).all()


@pytest.mark.parametrize("wc", range(1, MRR_MAX_CHUNK + 1))
def test_masked_row_reduce_stages_fit_and_rows_avoid_bank_conflicts(wc):
    """Each stage fits its budget (under the 48 KB a block takes without
    opting in); the 8 rows a quarter warp reads with 128-bit loads start
    in 8 disjoint groups of 4 banks; a row holds the pass's words."""
    pitch = row_pitch(wc)
    assert pitch >= wc and pitch % 4 == 0 and (pitch // 4) % 2 == 1
    for n in (1, 300, 1025, 1500, 100000):
        rows = stage_rows(n, wc)
        assert rows >= 32 and rows % 32 == 0
        assert 4 * (rows * pitch + rows // 32 * MRR_SEL_PITCH) \
            <= MRR_STAGE_BYTES <= 48 * 1024
    for j in range(-(-wc // 4)):
        banks = {(r * pitch + 4 * j) % 32 // 4 for r in range(8)}
        assert len(banks) == 8


# -- popcount_reduce: a sub-warp per row -----------------------------------

def sub_warp(w):
    sw = 1
    while sw < w and sw < 32:
        sw *= 2
    return sw


@pytest.mark.parametrize("w", [0, 1, 2, 3, 5, 10, 16, 17, 32, 33, 47])
def test_popcount_sub_warps_read_every_word_once(w):
    """Thread t of a row's sub-warp reads words t, t + SW, ...; the
    shuffle sum over the sub-warp is the row's popcount."""
    rng = np.random.RandomState(w)
    lanes, threads = 45, 256
    rows = random_words(rng, (lanes, w))
    sw = sub_warp(w)
    assert 32 % sw == 0 and (sw >= w or sw == 32)
    per_block = threads // sw
    got = np.zeros(lanes, np.int64)
    reads = np.zeros((lanes, w), np.int64)
    for block in range(-(-lanes // per_block)):
        for tid in range(threads):
            lane, t = block * per_block + tid // sw, tid % sw
            if lane < lanes:
                for k in range(t, w, sw):
                    reads[lane, k] += 1
                    got[lane] += popcount(rows[lane, k])
    assert (reads == 1).all()
    np.testing.assert_array_equal(
        got, ref.popcount_reduce_ref(words(rows)).numpy())

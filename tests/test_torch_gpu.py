"""Card-only tests of the port: the CUDA kernels against their plain
versions on CUDA tensors (the four bitset kernels bitwise, attention and
the SSD scan within the reference's tolerances), and a solve and a
service drain on the card against the same on the CPU, with telemetry
off and on.  This file imports neither ``jax`` nor
``repro``, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

Each test decides inside itself whether a card is present and skips
without one.
"""

import json

import numpy as np
import pytest
import torch

from repro_torch import registry
from repro_torch.convert import words
from repro_torch.core.api import tree_leaves
from repro_torch.kernels import _build, bitset_degree, bitset_ops, ops, ref
from repro_torch.problems.graphs import (circulant_graph, full_mask,
                                         num_words, parse_graph_instance)
from repro_torch.service import SolveRequest
from repro_torch.solver import Solver, SolverConfig


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


def random_words(rng, shape):
    return rng.randint(0, 2 ** 32, size=shape, dtype=np.uint64).astype(
        np.uint32)


def trace_records(path):
    """A trace's records with ``meta.backend`` (the device type) dropped."""
    out = [json.loads(line) for line in open(path)]
    assert out[0]["t"] == "meta"
    out[0].pop("backend")
    return out


def assert_lanes_equal(a, b):
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x.cpu(), y.cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 31, 33, 100, 300, 1000, 1025, 1100, 1500,
                               4100])
def test_cuda_kernel_equals_plain_version(n):
    """n above 1024 takes the kernel's wide path (w > 32 words)."""
    need_card()
    rng = np.random.RandomState(n)
    w = num_words(n)
    for lanes in (1, 7, 1024):
        cases = [(random_words(rng, (n, w)) & full_mask(n),
                  random_words(rng, (lanes, w)))]
        if n >= 15:
            # All-tied degrees: the smallest valid id must win.
            cases.append((circulant_graph(n, (1, 7)).adj,
                          np.broadcast_to(full_mask(n), (lanes, w)).copy()))
        for table, mask in cases:
            valid = mask & random_words(rng, mask.shape)
            valid[::3] = 0
            valid[1::3] = mask[1::3]
            t, m, v = (words(a, "cuda") for a in (table, mask, valid))
            before = bitset_ops.LAUNCHES["count_stats"]
            got = bitset_ops.count_stats(t, m, v)
            torch.cuda.synchronize()
            assert bitset_ops.LAUNCHES["count_stats"] == before + 1
            assert torch.equal(got, ref.count_stats_ref(t, m, v))
            assert torch.equal(bitset_degree.degree_stats(t, m),
                               ref.degree_stats_ref(t, m))
            fullm = words(full_mask(n), "cuda")
            assert torch.equal(
                bitset_ops.domination_stats(t, m, v, fullm),
                ref.domination_stats_ref(t, m, v, fullm))


@pytest.mark.gpu
@pytest.mark.parametrize("n,w", [(1, 1), (20, 1), (300, 10), (257, 10),
                                 (31, 32), (1000, 32), (1024, 32), (33, 40),
                                 (1025, 33), (1500, 64)])
def test_cuda_kernel_equals_plain_version_at_any_width(n, w):
    """Rows wider than n needs (w up to 64), n not a multiple of 32, lane
    counts that are not multiples of a block's 16, all-tied counts and
    lanes with nothing valid."""
    need_card()
    rng = np.random.RandomState(n * 40 + w)
    for lanes in (1, 17, 1000):
        table = random_words(rng, (n, w))
        mask = random_words(rng, (lanes, w))
        valid = mask & random_words(rng, (lanes, w))
        valid[::3] = 0                          # nothing valid
        valid[1::3] = 0xFFFFFFFF                # bits past n set too
        tied = np.zeros_like(mask)              # every count 0: all tie
        for m in (mask, tied):
            t, mk, v = (words(a, "cuda") for a in (table, m, valid))
            before = bitset_ops.LAUNCHES["count_stats"]
            got = bitset_ops.count_stats(t, mk, v)
            torch.cuda.synchronize()
            assert bitset_ops.LAUNCHES["count_stats"] == before + 1
            assert torch.equal(got, ref.count_stats_ref(t, mk, v))
        assert (got[::3, :3].cpu() == torch.tensor([-1, -1, 0])).all()
        if lanes > 1:
            assert got[1, :2].tolist() == [0, 0]  # smallest valid id


@pytest.mark.gpu
@pytest.mark.parametrize("family,spec,lanes", [("vc", "gnp:40:20:3", 32),
                                               ("ds", "gnp:30:15:2", 16)])
def test_solve_on_the_card_equals_the_cpu(family, spec, lanes):
    need_card()
    handle = registry.problem(family, spec)
    cfg = dict(lanes=lanes, steps_per_round=16, bootstrap_rounds=2)
    bitset_ops.reset_launches()
    gpu = Solver(SolverConfig(device="cuda", **cfg)).solve(handle)
    assert bitset_ops.LAUNCHES["count_stats"] > 0
    cpu = Solver(SolverConfig(device="cpu", **cfg)).solve(handle)
    assert gpu.stats == cpu.stats
    assert torch.equal(gpu.payload.cpu(), cpu.payload)


@pytest.mark.gpu
def test_wide_solve_on_the_card_equals_the_cpu():
    """A graph of 1100 vertices (35 words a row): one round (8 steps and a
    steal with its replay) on the card and on the CPU, the same
    ``SolveStats`` and lanes."""
    need_card()
    handle = registry.problem("vc", "gnp:1100:1:3")
    cfg = dict(lanes=16, steps_per_round=64, bootstrap_rounds=1,
               bootstrap_steps=8, max_rounds=1)
    bitset_ops.reset_launches()
    gpu = Solver(SolverConfig(device="cuda", **cfg)).solve(handle)
    assert bitset_ops.LAUNCHES["count_stats"] > 0
    cpu = Solver(SolverConfig(device="cpu", **cfg)).solve(handle)
    assert gpu.stats == cpu.stats
    assert_lanes_equal(gpu.lanes, cpu.lanes)


@pytest.mark.gpu
@pytest.mark.parametrize("family,spec,lanes", [("vc", "gnp:40:20:3", 32),
                                               ("ss", "ss:16:2", 16)])
def test_traced_solve_on_the_card_equals_untraced(family, spec, lanes,
                                                   tmp_path):
    """Telemetry on the card is observation only: the traced solve gives
    the untraced one's ``SolveStats`` and lanes, and its trace is the
    CPU's, record for record, with ``meta.backend`` "cuda"."""
    need_card()
    handle = registry.problem(family, spec)
    cfg = dict(lanes=lanes, steps_per_round=16, bootstrap_rounds=2)
    runs = {}
    for name, device, tele in (
            ("bare", "cuda", {}),
            ("cuda", "cuda", dict(metrics=True,
                                  trace_path=str(tmp_path / "cuda.jsonl"))),
            ("cpu", "cpu", dict(metrics=True,
                                trace_path=str(tmp_path / "cpu.jsonl")))):
        solver = Solver(SolverConfig(device=device, **cfg, **tele))
        runs[name] = (solver, solver.solve(handle))
    bare, traced = runs["bare"][1], runs["cuda"][1]
    assert traced.stats == bare.stats == runs["cpu"][1].stats
    assert_lanes_equal(traced.lanes, bare.lanes)
    assert trace_records(tmp_path / "cuda.jsonl") == \
        trace_records(tmp_path / "cpu.jsonl")
    assert json.loads(open(tmp_path / "cuda.jsonl").readline())[
        "backend"] == "cuda"
    assert runs["cuda"][0].metrics().value("engine_nodes") == \
        traced.stats.nodes


@pytest.mark.gpu
@pytest.mark.parametrize("k,n", [(1, 33), (4, 100), (16, 300), (64, 100),
                                 (4, 1100), (16, 1500)])
def test_stacked_kernel_equals_plain_version(k, n):
    """Ids mixed with parked lanes, all parked, sorted (each instance's
    lanes together) and all on one instance: every layout must give the
    plain version's bits, K = 64 and rows of more than 32 words (the
    kernel's wide path) included."""
    need_card()
    rng = np.random.RandomState(k * n)
    w = num_words(n)
    for lanes in (1, 7, 1024, 4096):
        tables = random_words(rng, (k, n, w))
        mask = random_words(rng, (lanes, w))
        valid = mask & random_words(rng, mask.shape)
        inst = rng.randint(-1, k, size=lanes).astype(np.int32)
        inst[0] = -1                                  # a parked lane
        layouts = (inst, np.full_like(inst, -1),     # and all parked
                   np.sort(rng.randint(0, k, size=lanes)).astype(np.int32),
                   np.full_like(inst, k - 1))
        for ids in layouts:
            t, m, v = (words(a, "cuda") for a in (tables, mask, valid))
            i = torch.from_numpy(ids).cuda()
            before = bitset_ops.LAUNCHES["stacked_count_stats"]
            got = bitset_ops.stacked_count_stats(t, i, m, v)
            torch.cuda.synchronize()
            assert bitset_ops.LAUNCHES["stacked_count_stats"] == before + 1
            assert torch.equal(got, ref.stacked_count_stats_ref(t, i, m, v))
            assert (got[i < 0].cpu() == torch.tensor([-1, -1, 0, 0],
                                                     dtype=torch.int32)).all()


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["narrow", "wide"])
@pytest.mark.parametrize("w", [1, 4, 10, 32])
def test_count_kernels_equal_plain_version_on_either_route(route, w):
    """Rows of up to 32 words take both routes (``measured_choice`` may
    cache either): each must give the plain version's bits, with lanes
    that see nothing valid, all-tied counts, and (stacked) parked lanes."""
    need_card()
    rng = np.random.RandomState(w * 2 + (route == "wide"))
    for n in sorted({max(1, 32 * w - 5), 32 * w}):
        for lanes in (1, 17, 1024):
            table = random_words(rng, (n, w)) & full_mask(n)
            mask = random_words(rng, (lanes, w))
            valid = mask & random_words(rng, (lanes, w))
            valid[::3] = 0
            valid[1::3] = mask[1::3]
            for m in (mask, np.zeros_like(mask)):
                t, mk, v = (words(a, "cuda") for a in (table, m, valid))
                before = bitset_ops.LAUNCHES["count_stats"]
                got = bitset_ops.count_stats(t, mk, v, route=route)
                torch.cuda.synchronize()
                assert bitset_ops.LAUNCHES["count_stats"] == before + 1
                assert torch.equal(got, ref.count_stats_ref(t, mk, v))
            k = 4
            tables = random_words(rng, (k, n, w))
            inst = rng.randint(-1, k, size=lanes).astype(np.int32)
            t, m, v = (words(a, "cuda") for a in (tables, mask, valid))
            i = torch.from_numpy(inst).cuda()
            before = bitset_ops.LAUNCHES["stacked_count_stats"]
            got = bitset_ops.stacked_count_stats(t, i, m, v, route=route)
            torch.cuda.synchronize()
            assert bitset_ops.LAUNCHES["stacked_count_stats"] == before + 1
            assert torch.equal(got, ref.stacked_count_stats_ref(t, i, m, v))


@pytest.mark.gpu
@pytest.mark.parametrize("traced", [False, True])
def test_service_on_the_card_equals_the_cpu(traced, tmp_path):
    """The card's service drain equals the CPU's; traced, both traces are
    the same record for record."""
    need_card()
    mix = [("vc", "gnp:20:30:5", {}), ("ds", "gnp:16:30:7", {}),
           ("vc", "reg:18:3:2", {"priority": 2}),
           ("ds", "gnp:18:25:4", {"node_budget": 40})]
    runs = {}
    for device in ("cuda", "cpu"):
        tele = (dict(metrics=True, trace_path=str(tmp_path / f"{device}.jsonl"))
                if traced else {})
        svc = Solver(SolverConfig(lanes=16, steps_per_round=6,
                                  device=device, **tele)).serve(max_n=20,
                                                                slots=2)
        for rid, (f, spec, kw) in enumerate(mix):
            svc.submit(SolveRequest(rid=rid, graph=parse_graph_instance(spec),
                                    family=f, **kw))
        bitset_ops.reset_launches()
        svc.drain()
        if device == "cuda":
            assert bitset_ops.LAUNCHES["stacked_count_stats"] > 0
        runs[device] = svc
    gpu, cpu = runs["cuda"], runs["cpu"]
    assert gpu.rounds == cpu.rounds
    for rid in cpu.results:
        a, b = gpu.results[rid], cpu.results[rid]
        assert (a.optimum, a.status, a.retired_round) == \
            (b.optimum, b.status, b.retired_round)
        assert np.array_equal(a.payload, b.payload)
    assert_lanes_equal(gpu.lanes, cpu.lanes)
    if traced:
        assert trace_records(tmp_path / "cuda.jsonl") == \
            trace_records(tmp_path / "cpu.jsonl")
        assert gpu.metrics().to_dict() == cpu.metrics().to_dict()


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 31, 32, 33, 100, 300, 1025, 1500])
def test_bitset_reduce_kernels_equal_plain_versions(n):
    need_card()
    rng = np.random.RandomState(n)
    w = num_words(n)
    for lanes in (1, 7, 1024):
        table = words(random_words(rng, (n, w)), "cuda")
        sel = random_words(rng, (lanes, w))     # bits >= n set too
        sel[0] = 0                              # empty: the identity
        if lanes > 1:
            sel[1] = 0xFFFFFFFF                 # all ones
        sel = words(sel, "cuda")
        before = dict(_build.LAUNCHES)
        got = {op: ops.masked_row_reduce(table, sel, op=op)
               for op in ("or", "and")}
        count = ops.popcount_reduce(sel)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["masked_row_reduce"] == \
            before["masked_row_reduce"] + 2
        assert _build.LAUNCHES["popcount_reduce"] == \
            before["popcount_reduce"] + 1
        for op, out in got.items():
            assert torch.equal(out, ref.masked_row_reduce_ref(table, sel,
                                                              op=op))
        assert torch.equal(count, ref.popcount_reduce_ref(sel))
    with pytest.raises(ValueError):
        ops.masked_row_reduce(table, sel, op="xor")


def _randn(rng, shape, dtype, scale=0.5):
    x = torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32))
    return x.to(dtype).cuda()


def _assert_close(got, want, tol, rel_tol):
    """allclose with rtol = atol = tol, and ||got - want|| / ||want|| at
    most rel_tol."""
    got, want = got.float(), want.float()
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    assert float((got - want).norm() / want.norm()) <= rel_tol


#: q and k at 2.5: the scores spread by about 6, so the softmax is peaked
#: and the softcap bends the largest scores.
QK_SCALE = 2.5


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,h,g,hd,window,softcap,qs,dtype", [
    (1, 256, 4, 2, 64, None, 0.0, None, torch.float32),
    (1, 200, 7, 1, 80, None, 0.0, None, torch.float32),   # r=7, hd=80
    (1, 256, 4, 2, 64, 100, 50.0, None, torch.float32),
    (2, 130, 4, 4, 128, 50, 30.0, None, torch.bfloat16),
    (1, 300, 4, 2, 128, None, 50.0, 1 / 12, torch.bfloat16),
    # The bf16 wgmma kernel: hd 64 / 80 / 128, r = H / G in {1, 7, 8}, S
    # below, at and past the 128-row tile, windows below a tile and past S.
    (1, 100, 8, 1, 64, None, 0.0, None, torch.bfloat16),      # S < tile
    (2, 128, 4, 4, 128, None, 0.0, None, torch.bfloat16),     # S = tile
    (1, 333, 7, 1, 80, None, 0.0, None, torch.bfloat16),      # hd=80, r=7
    (1, 640, 16, 2, 128, 50, 0.0, None, torch.bfloat16),      # r=8
    (1, 300, 4, 4, 64, 1000, 30.0, None, torch.bfloat16),     # window > S
    (1, 513, 14, 2, 80, 200, 50.0, 1 / 12, torch.bfloat16),
])
def test_flash_attention_kernel_equals_plain_version(b, s, h, g, hd, window,
                                                     softcap, qs, dtype):
    need_card()
    rng = np.random.RandomState(s + h)
    q, k, v = (_randn(rng, (b, s, n_, hd), dtype, scale)
               for n_, scale in ((h, QK_SCALE), (g, QK_SCALE), (g, 0.5)))
    before = _build.LAUNCHES["flash_attention"]
    got = ops.flash_attention(q, k, v, window=window, softcap=softcap,
                              query_scale=qs)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["flash_attention"] == before + 1

    def plain(window=window, softcap=softcap):
        return ref.flash_attention_ref(q, k, v, window=window,
                                       softcap=softcap, query_scale=qs,
                                       block_q=128, block_k=128)
    want = plain()
    tol, rel_tol = ((2e-2, 5e-3) if dtype == torch.bfloat16
                    else (2e-5, 2e-5))
    _assert_close(got, want, tol, rel_tol)
    # The inputs can tell a kernel that skipped the softcap or the window.
    faults = ([plain(softcap=0.0)] if softcap else []) + \
        ([plain(window=None)] if window is not None and window < s else [])
    for bad in faults:
        with pytest.raises(AssertionError):
            _assert_close(bad, want, tol, rel_tol)


@pytest.mark.gpu
def test_flash_attention_kernel_rejects_a_head_dim_it_lacks():
    """Past the largest built head dim (128): head dims below it are
    padded up to a built one (tests/test_torch_lm_gpu.py)."""
    need_card()
    q = torch.zeros((1, 8, 2, 160), device="cuda")
    with pytest.raises(ValueError, match=r"hd <= 128"):
        ops.flash_attention(q, q, q)


def _ssd_inputs(rng, b, s, h, p, g, n, dtype, dt_shift):
    """dt = softplus(N(0, 1) + dt_shift): at -5 in mamba2's range, so a
    chunk carries on a sizeable share of the state; a gain per head."""
    x = _randn(rng, (b, s, h, p), dtype)
    dt = torch.nn.functional.softplus(
        _randn(rng, (b, s, h), torch.float32, 1.0) + dt_shift)
    a = -torch.exp(_randn(rng, (h,), torch.float32, 0.3))
    bm, cm = (_randn(rng, (b, s, g, n), dtype, 0.3) for _ in range(2))
    d = 1.0 + _randn(rng, (h,), torch.float32)
    return x, dt, a, bm, cm, d


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,h,p,g,n,chunk,dtype,dt_shift", [
    (1, 256, 4, 64, 1, 128, 128, torch.bfloat16, -5.0),
    (2, 300, 4, 32, 2, 64, 64, torch.float32, -5.0),     # G=2, ragged S
    (1, 100, 2, 64, 1, 16, 43, torch.float32, -5.0),     # chunk 43, ragged
    (1, 256, 4, 64, 1, 128, 128, torch.float32, 1.0),    # decay > exp(88)
    (4, 512, 24, 64, 1, 128, 128, torch.bfloat16, -5.0),  # mamba2-130m
])
def test_ssd_scan_kernel_equals_plain_version(b, s, h, p, g, n, chunk,
                                              dtype, dt_shift):
    need_card()
    rng = np.random.RandomState(s + n)
    args = _ssd_inputs(rng, b, s, h, p, g, n, dtype, dt_shift)
    before = _build.LAUNCHES["ssd_scan"]
    y, state = ops.ssd_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["ssd_scan"] == before + 1
    y_want, st_want = ref.ssd_scan_ref(*args, chunk=chunk)
    tol, rel_tol = ((5e-2, 5e-3) if dtype == torch.bfloat16
                    else (1e-4, 1e-4))
    _assert_close(y, y_want, tol, rel_tol)
    _assert_close(state, st_want, 1e-4, 1e-4)     # f32 on both sides
    if dt_shift < 0:
        # The inputs can tell a kernel that dropped the carried state:
        # the plain version run one chunk at a time fails.
        x, dt, a, bm, cm, d = args
        last = (s - 1) // chunk * chunk
        cut = slice(last, s)
        _, st_alone = ref.ssd_scan_ref(x[:, cut], dt[:, cut], a, bm[:, cut],
                                       cm[:, cut], d, chunk=chunk)
        with pytest.raises(AssertionError):
            _assert_close(st_alone, st_want, 1e-4, 1e-4)


@pytest.mark.gpu
def test_ssd_scan_kernel_refuses_a_chunk_that_does_not_fit():
    need_card()
    rng = np.random.RandomState(0)
    for dtype in (torch.float32, torch.bfloat16):
        # N = 1024: the f32 passes stage a [128, 1024] B (512 KB), the
        # bf16 output pass C and B [128, 1024] and S hi/lo [1024, 64]
        # (806 KB); the card gives a block 227 KB.
        big = _ssd_inputs(rng, 1, 8, 1, 64, 1, 1024, dtype, -5.0)
        with pytest.raises(ValueError):
            ops.ssd_scan(*big, chunk=128)
    # The refusal leaves no error behind for the next launch.
    args = _ssd_inputs(rng, 1, 64, 2, 32, 1, 16, torch.float32, -5.0)
    y, state = ops.ssd_scan(*args, chunk=32)
    y_want, st_want = ref.ssd_scan_ref(*args, chunk=32)
    _assert_close(y, y_want, 1e-4, 1e-4)
    _assert_close(state, st_want, 1e-4, 1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("family,spec,lanes", [("vc", "gnp:40:20:3", 8),
                                               ("ds", "gnp:30:15:2", 4)])
def test_sharded_solve_on_the_card_equals_the_cpu(family, spec, lanes):
    """Four shards on cuda:0 against four CPU shards: the same
    ``SolveStats``, gathered lanes and payload, with tasks crossing
    shards."""
    need_card()
    from repro_torch.core.distributed import Mesh
    handle = registry.problem(family, spec)
    cfg = dict(lanes=lanes, steps_per_round=16, bootstrap_rounds=2)
    bitset_ops.reset_launches()
    gpu = Solver(SolverConfig(device="cuda", mesh=Mesh(["cuda:0"] * 4),
                              **cfg)).solve(handle)
    assert bitset_ops.LAUNCHES["count_stats"] > 0
    cpu = Solver(SolverConfig(device="cpu", mesh=Mesh(["cpu"] * 4),
                              **cfg)).solve(handle)
    assert gpu.stats == cpu.stats and gpu.stats.t_c > 0
    assert_lanes_equal(gpu.lanes.gather(), cpu.lanes.gather())
    assert torch.equal(gpu.payload.cpu(), cpu.payload)


@pytest.mark.gpu
def test_sharded_service_on_the_card_equals_the_cpu():
    """The test-sized mix on 2 shards of cuda:0, resized to 4 mid-drain,
    against the same schedule on CPU shards: the same results, rounds and
    lanes."""
    need_card()
    from repro_torch.core.distributed import Mesh
    from repro_torch.problems.graphs import parse_graph_instance
    mix = [("vc", "gnp:20:30:5"), ("ds", "gnp:16:30:7"), ("vc", "reg:18:3:2"),
           ("ds", "gnp:18:25:4"), ("vc", "gnp:16:35:9")]
    runs = {}
    for device, dev in (("cuda", "cuda:0"), ("cpu", "cpu")):
        svc = Solver(SolverConfig(lanes=8, steps_per_round=8, device=device,
                                  mesh=Mesh([dev] * 2))).serve(max_n=20,
                                                               slots=3)
        for rid, (family, spec) in enumerate(mix):
            svc.submit(SolveRequest(rid=rid, graph=parse_graph_instance(spec),
                                    family=family))
        bitset_ops.reset_launches()
        while svc._has_work():
            if svc.rounds == 3:
                svc.resize(mesh=Mesh([dev] * 4), num_lanes=4)
            svc.step_round()
        runs[device] = svc
        if device == "cuda":
            assert bitset_ops.LAUNCHES["stacked_count_stats"] > 0
    gpu, cpu = runs["cuda"], runs["cpu"]
    assert gpu.rounds == cpu.rounds and gpu.n_devices == 4
    assert {r: v.optimum for r, v in gpu.results.items()} == {
        r: v.optimum for r, v in cpu.results.items()}
    assert_lanes_equal(gpu.lanes.gather(), cpu.lanes.gather())


def _launch_delta(before):
    return {k: v - before[k] for k, v in _build.LAUNCHES.items()}


@pytest.mark.gpu
@pytest.mark.parametrize("family,spec,lanes", [("vc", "reg:300:4:1", 4096),
                                               ("ds", "gnp:60:10:5", 1024),
                                               ("ss", "ss:36:0", 1024)])
def test_graphed_round_equals_the_eager_round(family, spec, lanes):
    """20 rounds of ``make_round``'s CUDA graph (warm-up, capture, 18
    replays) against the same body run eager, from one root: every lane
    field and the open work bitwise, and the same launches, each round;
    vc fills its 4096 lanes within them."""
    need_card()
    from repro_torch.core import round_graph
    from repro_torch.core.distributed import make_round
    from repro_torch.core.engine import init_lanes
    problem = registry.problem(family, spec).build(device="cuda")
    graphed = make_round(problem, 64)
    round_graph.reset_counts()
    a = b = init_lanes(problem, lanes)
    for _ in range(20):
        before = dict(_build.LAUNCHES)
        a, open_a = graphed(a)
        mid = dict(_build.LAUNCHES)
        got = _launch_delta(before)
        b, open_b = graphed.fn(b)
        assert got == _launch_delta(mid)
        assert_lanes_equal((a, open_a), (b, open_b))
    assert round_graph.COUNTS == dict(captures=1, replays=19, cpu=0, mesh=0,
                                      warmup=1, capture_failed=0, short=0)
    if family == "vc":
        assert bool(a.active.all())


@pytest.mark.gpu
def test_a_wide_graphed_round_equals_the_eager_round():
    """Vertex cover at 35 words a row (G(1100, 0.5); the vc-c2000 cell
    runs 63) over 4096 lanes: 16 rounds of ``make_round``'s CUDA graph
    (warm-up, capture, 14 replays) against the same body run eager, from
    one root, bitwise and with the same counts each round; no capture
    fails; every ``count_stats`` launch, the replay chunks' included,
    takes the wide route, as the profiler sees it on one more replayed
    round; each round's 64 steps clone the whole stack."""
    need_card()
    import re
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import round_graph
    from repro_torch.core.distributed import make_round
    from repro_torch.core.engine import init_lanes
    problem = registry.problem("vc", "gnp:1100:50:1").build(device="cuda")
    assert num_words(problem.max_depth) == 35
    graphed = make_round(problem, 64)
    round_graph.reset_counts()
    a = b = init_lanes(problem, 4096)
    pushed = 64 * sum(s.numel() * s.element_size() for s in a.stack)
    chunked = 0
    for _ in range(16):
        before = dict(_build.LAUNCHES)
        a, open_a = graphed(a)
        mid = dict(_build.LAUNCHES)
        got = _launch_delta(before)
        b, open_b = graphed.fn(b)
        assert got == _launch_delta(mid), (got, _launch_delta(mid))
        assert got["count_stats.wide"] == got["count_stats"] >= 64, got
        assert got["count_stats.narrow"] == 0, got
        assert got["stack_push_bytes"] == pushed, (got, pushed)
        assert_lanes_equal((a, open_a), (b, open_b))
        chunked += got["count_stats"] > 64
    assert round_graph.COUNTS == dict(captures=1, replays=15, cpu=0, mesh=0,
                                      warmup=1, capture_failed=0, short=0)
    assert chunked, "no round ran a replay chunk"
    torch.cuda.synchronize()
    before = dict(_build.LAUNCHES)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        a, _ = graphed(a)
        torch.cuda.synchronize()
    ran = sum(e.count for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and re.search(
                  r"(?<![A-Za-z_])count_stats_wide_kernel", e.key))
    got = _launch_delta(before)
    assert ran == got["count_stats.wide"] == got["count_stats"] >= 64, (
        ran, got)


@pytest.mark.gpu
def test_graphed_service_equals_the_eager_service():
    """The stacked service with its round graphed against a twin whose
    round runs eager, step for step: admissions write the slot tables in
    place between rounds, and a resize at round 8 rebuilds the round (a
    new key, a new capture).  Results, open work, lanes and launches
    equal every round; no capture falls back."""
    need_card()
    from repro_torch.core import round_graph
    mix = [("vc", "gnp:40:20:3"), ("ds", "gnp:30:15:2"), ("vc", "reg:36:4:3"),
           ("ds", "gnp:25:20:6"), ("ds", "gnp:40:15:3"), ("vc", "gnp:35:25:8"),
           ("vc", "gnp:40:15:1"), ("ds", "gnp:32:20:4")]
    svcs = [Solver(SolverConfig(lanes=512, steps_per_round=16,
                                device="cuda")).serve(max_n=40, slots=3)
            for _ in range(2)]
    graphed, eager = svcs
    eager._round = eager._round.fn
    for svc in svcs:
        for rid, (family, spec) in enumerate(mix):
            svc.submit(SolveRequest(rid=rid, graph=parse_graph_instance(spec),
                                    family=family))
    round_graph.reset_counts()
    rounds = 0
    while graphed._has_work() or eager._has_work():
        if rounds == 8:
            for svc in svcs:
                svc.resize(num_lanes=384)
            eager._round = eager._round.fn
        before = dict(_build.LAUNCHES)
        open_g = graphed.step_round()
        mid = dict(_build.LAUNCHES)
        got = _launch_delta(before)
        open_e = eager.step_round()
        assert got == _launch_delta(mid)
        assert np.array_equal(open_g, open_e)
        assert_lanes_equal(graphed.lanes, eager.lanes)
        rounds += 1
        assert rounds < 400
    assert rounds >= 20
    assert {r: (v.optimum, v.retired_round) for r, v in
            graphed.results.items()} == {
        r: (v.optimum, v.retired_round) for r, v in eager.results.items()}
    counts = round_graph.COUNTS
    assert counts["capture_failed"] == counts["cpu"] == counts["mesh"] \
        == counts["short"] == 0
    assert counts["captures"] == counts["warmup"] == 2
    assert counts["replays"] == rounds - 2


@pytest.mark.gpu
@pytest.mark.parametrize("family,spec", [("vc", "reg:300:4:1"),
                                         ("ds", "gnp:60:10:5")])
def test_a_replayed_round_runs_the_launches_it_counts(family, spec):
    """A replay adds the launches its captures counted to
    ``_build.LAUNCHES`` without reaching the launcher: the plan's once,
    the chunk's for each replay chunk launched.  The profiler's count of
    the port's kernels on the card in a replayed round equals that
    addition (``_build.KERNELS``: the registry's route and stack-byte
    names are no further launches), on a round that ran replay chunks and
    on one that ran none; ``count_stats`` ran 64 + the passes
    ``steal.REPLAYS`` counts, all on the narrow route."""
    need_card()
    import re
    from collections import Counter
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import round_graph, steal
    from repro_torch.core.distributed import make_round
    from repro_torch.core.engine import init_lanes
    problem = registry.problem(family, spec).build(device="cuda")
    round_fn = make_round(problem, 64)
    lanes = init_lanes(problem, 1024)
    for _ in range(3):                  # warm-up, capture, replay
        lanes, _ = round_fn(lanes)
    seen = set()
    for _ in range(40):
        # The last round's replay chunks may still run: profile a round
        # on a card with nothing queued, as a replay used to leave it.
        torch.cuda.synchronize()
        replays = round_graph.COUNTS["replays"]
        chunks, passes = steal.REPLAYS["chunks"], steal.REPLAYS["passes"]
        before = dict(_build.LAUNCHES)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            lanes, _ = round_fn(lanes)
            torch.cuda.synchronize()
        assert round_graph.COUNTS["replays"] == replays + 1
        ran = Counter()
        for evt in prof.key_averages():
            for name in _build.KERNELS:     # count_stats is not stacked_...
                if evt.device_type == DeviceType.CUDA and re.search(
                        r"(?<![A-Za-z_])" + name + r"(_wide)?_kernel",
                        evt.key):
                    ran[name] += evt.count
        delta = _launch_delta(before)
        counted = {k: delta[k] for k in _build.KERNELS if delta[k]}
        assert counted["count_stats"] == 64 + steal.REPLAYS["passes"] \
            - passes
        assert delta["count_stats.narrow"] == counted["count_stats"]
        assert dict(ran) == counted, (steal.REPLAYS["chunks"] - chunks)
        seen.add(steal.REPLAYS["chunks"] > chunks)
        if seen == {True, False}:
            break
    assert seen == {True, False}, "no round both with and without chunks"


def _solve_rounds(family, spec, lanes, rounds, on):
    """``rounds`` rounds of ``Solver.solve`` on the card, no listener, with
    the span recorder on or off (on again afterwards)."""
    from repro_torch.obs import spans
    (spans.enable if on else spans.disable)()
    try:
        return Solver(SolverConfig(lanes=lanes, steps_per_round=64,
                                   max_rounds=rounds, device="cuda")).solve(
            registry.problem(family, spec))
    finally:
        spans.enable()


def _syncs(fn):
    """The synchronizing CUDA operations inside ``fn()``, counted as
    ``chip_smoke.py``'s phase 25 counts them."""
    import warnings
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum("synchronizing CUDA operation" in str(w.message)
               for w in caught)


@pytest.mark.gpu
@pytest.mark.parametrize("family", ["ds", "vc"])
def test_graphed_rounds_record_one_device_span_per_phase(family):
    """Ten rounds of a solve at 4096 lanes on the benchmark's graph: every
    round, the eager warm-up, the capture (which replays at once) and
    each later replay, files one device span per phase (``expand``,
    ``balance`` twice, ``replay`` twice: the plan's start of the replay
    and the chunks after the readback, filed by the next readback or the
    solve's end) of the card's time, the replays without running the
    phases' host code.
    The lanes are bitwise those of the same rounds with the recorder off,
    and a round makes as many host syncs with it on as off (one)."""
    need_card()
    from collections import Counter
    from repro_torch.core import round_graph
    from repro_torch.obs import spans
    spec, lanes = "reg:300:4:1", 4096
    round_graph.reset_counts()
    on = _solve_rounds(family, spec, lanes, 10, True)
    run = spans.run_spans("solve")
    assert round_graph.COUNTS["capture_failed"] == 0
    assert round_graph.COUNTS["replays"] == 9       # the capture's round too
    replayed = {s.round for s in run if s.name == "graph"}
    assert replayed == set(range(2, 11))
    for r in range(1, 11):
        dev = [s for s in run if s.round == r and s.clock == "device"]
        assert Counter(s.name for s in dev) == {"expand": 1, "balance": 2,
                                                "replay": 2}, r
        assert all(s.duration_ns > 0 for s in dev), r
        # The host's phase spans: the warm-up's and the capture's only.
        host = Counter(s.name for s in run if s.round == r
                       and s.clock == "host")
        assert host["expand"] == (1 if r <= 2 else 0), r
    off = _solve_rounds(family, spec, lanes, 10, False)
    assert on.stats == off.stats
    assert_lanes_equal(on.lanes, off.lanes)
    _solve_rounds(family, spec, lanes, 2, True)     # first use, not counted
    per_round = {
        state: _syncs(lambda: _solve_rounds(family, spec, lanes, 3, state))
        - _syncs(lambda: _solve_rounds(family, spec, lanes, 2, state))
        for state in (True, False)}
    assert per_round == {True: 1, False: 1}



@pytest.mark.gpu
def test_admission_rebuild_equals_the_whole_pool_replay_at_the_cells_shape(
        monkeypatch):
    """``vc-service-closed``'s shape: 4096 lanes, 32 slots, ``max_n`` 64,
    80 requests of G(n, 0.15) with n in 40..64, so admissions go on as
    slots free.  A resize to 48 lanes at round 6 parks tasks in the
    pending pool and one back to 4096 at round 8 lets later admissions
    install them below their roots.  After every rebuild, the resizes'
    and the admissions', the lanes equal a whole-pool rebuild of the same
    input (``whole_pool_rebuild``), bitwise, in as many passes as the
    deepest touched lane (0 for roots alone); every optimum is the serial
    oracle's."""
    need_card()
    from test_torch_targeted_rebuild import checked_rebuilds, drive
    calls = checked_rebuilds(monkeypatch)
    rng = np.random.RandomState(29)
    mix = [("vc", f"gnp:{n}:15:{rid}")
           for rid, n in enumerate(rng.randint(40, 65, size=80))]
    svc = Solver(SolverConfig(lanes=4096, steps_per_round=64,
                              device="cuda")).serve(max_n=64, slots=32)
    drive(svc, mix, resize_at={6: dict(num_lanes=48),
                               8: dict(num_lanes=4096)})
    assert svc.rounds >= 30
    assert len(calls) >= 15             # one a round that admits
    assert all(c["passes"] == c["deepest"] for c in calls)
    assert any(c["deepest"] > 0 for c in calls)

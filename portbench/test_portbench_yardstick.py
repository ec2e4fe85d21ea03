"""The yardstick on the CPU: generators, roofline arithmetic, percentiles
and the readers' window arithmetic."""

from __future__ import annotations

import statistics

import numpy as np
import pytest

from portbench import generate, readers, roofline, stats, trace


@pytest.mark.parametrize("family,spec", [
    ("gnp", {"family": "gnp", "n": 60, "p": 0.1}),
    ("reg", {"family": "reg", "n": 300, "k": 4}),
])
def test_generators_seeded_and_deterministic(family, spec):
    a = generate.graph(spec, 7)
    b = generate.graph(spec, 7)
    c = generate.graph(spec, 8)
    assert a.dtype == bool and (a == b).all() and not (a == c).all()
    assert (a == a.T).all() and not a.diagonal().any()
    if family == "reg":
        assert a.sum(axis=1).max() <= spec["k"]


def test_generators_equal_the_paper_families_of_the_port():
    from repro_torch.problems import graphs
    from portbench.reference.bits import pack
    assert (pack(generate.gnp(60, 0.1, 5)) ==
            graphs.gnp_graph(60, 0.1, 5).adj).all()
    assert (pack(generate.reg(300, 4, 3)) ==
            graphs.random_regularish_graph(300, 4, 3).adj).all()


@pytest.mark.parametrize("seed", [0, 1, 2 ** 31 + 17, 2 ** 40 + 3, -5])
def test_instance_seed_takes_any_whole_number(seed):
    s = generate.instance_seed(seed, 3)
    assert 0 <= s < 2 ** 32
    assert s == generate.instance_seed(seed, 3)
    assert s != generate.instance_seed(seed, 4)


def test_roofline_copy_matches_the_cell60_numbers():
    # 405,216 bytes and 0.121 us at n=300, w=10, L=4096 (PERF.md, kernels).
    nbytes = roofline.count_stats_bytes(300, 10, 4096)
    assert nbytes == 405_216
    assert roofline.bound_s(nbytes) == pytest.approx(0.121e-6, abs=5e-10)
    assert roofline.stacked_count_stats_bytes(16, 64, 2, 4096) == \
        4 * (16 * 64 * 2 + 4096 + 2 * 4096 * 2 + 4 * 4096)
    assert roofline.share_pct(0, 1e-6, 1.0) is None
    assert roofline.share_pct(10, 1e-6, 0.0) is None
    assert roofline.share_pct(1000, 1e-6, 2e-3) == pytest.approx(50.0)


@pytest.mark.parametrize("q", [0, 5, 50, 95, 99, 100])
def test_percentile_is_numpys_linear(q):
    xs = np.random.default_rng(3).exponential(size=257)
    assert stats.percentile(list(xs), q) == pytest.approx(
        float(np.percentile(xs, q)))


def test_spread_uses_statistics_quartiles():
    xs = [10.0, 11.0, 9.5, 10.2, 10.8, 30.0]
    q1, med, q3 = statistics.quantiles(xs, n=4)
    assert stats.spread(xs) == pytest.approx((q3 - q1) / med)


def test_readers_window_arithmetic():
    r = {"window": {"seconds": 10.0, "rounds": 22, "nodes": 1000,
                    "lane_steps": 4000, "done": 50,
                    "latencies": [1.0] * 95 + [5.0] * 5,
                    "waits": [0.1, 0.2, 0.3]},
         "profile": {"rounds": 2, "busy_s": 0.25,
                     "window_s": 1.0, "device_ops": 500,
                     "launches": {"count_stats": 100},
                     "kernel_s": {"count_stats": 4e-4}},
         "shape": {"count_stats": (300, 10, 4096)}, "setup_s": 3.0}
    assert readers.nodes_per_s(r) == 100.0
    assert readers.instances_per_s(r) == 5.0
    assert readers.round_ms(r) == pytest.approx(1e3 * 10.0 / 22)
    assert readers.lane_util(r) == 0.25
    assert readers.idle_share(r) == 0.75
    assert readers.device_ops_per_round(r) == 250
    assert readers.latency_p95_s(r) == pytest.approx(
        float(np.percentile(r["window"]["latencies"], 95)))
    assert readers.queue_wait_p50_s(r) == pytest.approx(0.2)
    share = readers.kernel_roofline("count_stats")(r)
    assert share == pytest.approx(100 * 100 * 405_216 / 3.35e12 / 4e-4)
    empty = {"window": {"seconds": 1.0, "rounds": 0, "nodes": 0},
             "profile": {"busy_s": 0.0, "window_s": 1.0}}
    for fn in (readers.nodes_per_s, readers.round_ms, readers.idle_share,
               readers.device_ops_per_round, readers.lane_util,
               readers.kernel_roofline("count_stats")):
        assert fn(empty) is None


def test_trace_reduction_union_gaps_and_kernels():
    dev = [(0.0, 10.0, "void count_stats_kernel<4>(...)"),
           (5.0, 20.0, "stacked_count_stats_kernel"),
           (50.0, 60.0, "Memcpy DtoH")]
    cpu = [(-10.0, 100.0, "outer"), (20.0, 50.0, "aten::item")]
    out = trace.reduce_events(dev, cpu)
    assert out["device_ops"] == 3
    assert out["busy_s"] == pytest.approx(30e-6)
    assert out["kernel_s"]["count_stats"] == pytest.approx(10e-6)
    assert out["kernel_s"]["stacked_count_stats"] == pytest.approx(15e-6)
    gaps = dict(out["idle_gaps"])
    assert gaps["aten::item"] == pytest.approx(30e-6)
    assert gaps["outer"] == pytest.approx(50e-6)      # the edges

"""The autotuner of the port (``repro_torch.kernels.autotune``) on the
CPU: the routes ``choose`` names and caches, ``predict_cost`` against the
bounds ``chip_smoke.py`` prints for ``count_stats`` (phase 5: 0.121 us at
cell60's shape, 0.015 us at gnp:100:10:7's, both by bytes), and
``measured_choice`` refusing the CPU."""

import pytest
import torch

from repro_torch.kernels import autotune, bitset_ops


@pytest.fixture(autouse=True)
def fresh_cache():
    autotune.clear_cache()
    yield
    autotune.clear_cache()


@pytest.mark.parametrize("n,w,route", [(300, 10, "narrow"),
                                       (1024, 32, "narrow"),
                                       (1025, 33, "wide"),
                                       (1500, 47, "wide")])
def test_choose_takes_the_fixed_rule_and_caches(n, w, route):
    """Narrow wherever w <= 32, wide beyond: the launchers' rule before
    the route was an argument.  The pick is cached per shape and device
    type, and a cached pick (as ``measured_choice`` leaves one) wins."""
    for k in (1, 4):
        got = autotune.choose(n, w, 1024, k)
        assert got.route == route and got.measured_ms is None
        assert autotune.choose(n, w, 1024, k) is got
    assert autotune.routes(w) == (("narrow", "wide") if w <= 32
                                  else ("wide",))
    autotune._CACHE[(n, w, 1024, 1, "cuda")] = autotune.KernelChoice(
        "wide", {"wide": 1.0})
    assert autotune.choose(n, w, 1024, 1).route == "wide"
    assert autotune.choose(n, w, 1024, 1, "cpu").route == route


@pytest.mark.parametrize("n,w,lanes,bound_us", [(300, 10, 4096, 0.121),
                                                (100, 4, 1024, 0.015)])
def test_predict_cost_is_the_smokes_bound_plus_a_launch(n, w, lanes,
                                                        bound_us):
    """``chip_smoke.py`` bounds ``count_stats`` by the bytes of reading
    each input once and writing the output once, through ``roofline``;
    ``predict_cost`` adds the launch floor.  Both routes move the same
    bytes, so they cost the same and the tie goes to ``narrow``."""
    rl = autotune.roofline(n, w, lanes)
    nbytes = 4 * (n * w + 2 * lanes * w + 4 * lanes)
    assert (rl.bound_by, rl.nbytes, rl.popcounts) == ("bytes", nbytes, 0)
    assert rl.seconds == pytest.approx(nbytes / autotune.HBM_BYTES_PER_S)
    assert rl.seconds == rl.bytes_s and rl.popcount_s == 0
    assert round(rl.seconds * 1e6, 3) == bound_us
    narrow = autotune.predict_cost(n, w, lanes, 1, "narrow")
    assert narrow == pytest.approx(rl.seconds + autotune.LAUNCH_OVERHEAD_S)
    assert autotune.predict_cost(n, w, lanes, 1, "wide") == narrow
    assert autotune.predict_cost(1500, 47, lanes, 1, "narrow") is None
    assert autotune.predict_cost(1500, 47, lanes, 1, "wide") is not None


def test_stacked_bound_is_popcount_issue_at_the_service_extremes():
    """``stacked_count_stats`` at (K=16, n=300, L=4096) with every lane
    valid: the popcount issue on the CUDA cores, 2.94 us at the data
    sheet's clock, as phase 10 of the smoke prints it."""
    rl = autotune.roofline(300, 10, 4096, 16)
    assert rl.bound_by == "operations" and rl.popcounts == 4096 * 300 * 10
    assert round(rl.seconds * 1e6, 2) == 2.94
    assert rl.nbytes == 4 * (16 * 3000 + 4096 + 2 * 40960 + 4 * 4096)


def test_roofline_counts_the_valid_pairs_on_the_cards_sms_and_clock():
    """The smoke passes the data's valid pairs and the card's SM count
    and clock: the popcount term scales with each, and once it falls
    under the bytes the bound is the bytes."""
    full = autotune.roofline(300, 10, 4096, 16)
    half = autotune.roofline(300, 10, 4096, 16, valid_pairs=4096 * 150)
    assert half.popcounts * 2 == full.popcounts
    assert half.popcount_s == pytest.approx(full.popcount_s / 2)
    slow = autotune.roofline(300, 10, 4096, 16, sms=66,
                             clock_hz=autotune.SM_CLOCK_HZ / 2)
    assert slow.seconds == pytest.approx(full.seconds * 4)
    assert slow.popcount_s == pytest.approx(autotune.popcount_issue_s(
        full.popcounts, 66, autotune.SM_CLOCK_HZ / 2))
    few = autotune.roofline(300, 10, 4096, 16, valid_pairs=10)
    assert few.bound_by == "bytes" and few.seconds == few.bytes_s


def test_measured_choice_refuses_the_cpu():
    with pytest.raises(RuntimeError, match="times the CUDA kernels"):
        autotune.measured_choice(300, 10, 64, device="cpu")
    assert autotune._CACHE == {}


def test_wrappers_take_a_route_and_refuse_a_wrong_one():
    """On CPU tensors the plain version runs whatever the route; a route
    that does not take the row width raises, as on the card."""
    g = torch.Generator().manual_seed(0)
    table = torch.randint(-2 ** 31, 2 ** 31 - 1, (40, 2), generator=g,
                          dtype=torch.int32)
    mask = torch.randint(-2 ** 31, 2 ** 31 - 1, (8, 2), generator=g,
                         dtype=torch.int32)
    want = bitset_ops.count_stats(table, mask, mask)
    for route in ("narrow", "wide"):
        assert torch.equal(bitset_ops.count_stats(table, mask, mask,
                                                  route=route), want)
    with pytest.raises(ValueError, match="route"):
        bitset_ops.count_stats(table, mask, mask, route="tiled")
    wide = torch.zeros((1100, 35), dtype=torch.int32)
    lanes = torch.zeros((4, 35), dtype=torch.int32)
    with pytest.raises(ValueError, match="route"):
        bitset_ops.count_stats(wide, lanes, lanes, route="narrow")
    inst = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="route"):
        bitset_ops.stacked_count_stats(wide[None], inst, lanes, lanes,
                                       route="narrow")

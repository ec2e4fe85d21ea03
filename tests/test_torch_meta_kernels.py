"""The six kernel wrappers on ``meta`` tensors (the dry run's route).

On ``meta`` each wrapper takes the card's route with the launch replaced
by its abstract form.  For each kernel: the output's shape and dtype are
the plain version's on CPU inputs of the same shape; under
``roofline.analyze`` the recorded cost is the kernel's cost function
(one launch, its FLOPs and bytes); what the launch path allocates is
allocated (``ssd_scan``'s chunk states, ``flash_attention``'s padded
copies); ``_build.LAUNCHES`` is unchanged.  Under grad, ``flash_attention``
and ``ssd_scan`` give input gradients of the inputs' shapes through
``PlainGrad`` (the plain recompute counted as score bytes).  Any other
device type still raises.
"""

import pytest
import torch

from repro_torch import roofline
from repro_torch.kernels import _build, bitset_ops, flash_attention, ops, \
    ssd_scan


def words(*shape, device):
    return torch.randint(-2 ** 31, 2 ** 31, shape, dtype=torch.int64
                         ).to(torch.int32).to(device)


def count_case(device):
    return (words(100, 4, device=device), words(7, 4, device=device),
            words(7, 4, device=device))


def stacked_case(device):
    tables = words(3, 100, 4, device=device)
    inst = torch.tensor([0, 1, 2, -1, 0, 1, 2], dtype=torch.int32
                        ).to(device)
    return (tables, inst, words(7, 4, device=device),
            words(7, 4, device=device))


def flash_case(device, hd=64):
    gen = torch.Generator().manual_seed(0)
    return [torch.randn((2, 48, 4, hd), generator=gen).to(device)
            for _ in range(1)] + [
        torch.randn((2, 48, 2, hd), generator=gen).to(device)
        for _ in range(2)]


def ssd_case(device):
    gen = torch.Generator().manual_seed(1)
    b, s, h, p, g, n = 2, 40, 4, 8, 2, 16
    return (torch.randn((b, s, h, p), generator=gen).to(device),
            torch.rand((b, s, h), generator=gen).to(device),
            -torch.rand((h,), generator=gen).to(device),
            torch.randn((b, s, g, n), generator=gen).to(device),
            torch.randn((b, s, g, n), generator=gen).to(device),
            torch.ones((h,)).to(device))


#: name -> (wrapper, inputs on a device, cost function of those inputs)
CASES = {
    "count_stats": (bitset_ops.count_stats, count_case,
                    bitset_ops.count_stats_cost),
    "stacked_count_stats": (bitset_ops.stacked_count_stats, stacked_case,
                            bitset_ops.stacked_count_stats_cost),
    "popcount_reduce": (bitset_ops.popcount_reduce,
                        lambda d: (words(7, 4, device=d),),
                        bitset_ops.popcount_reduce_cost),
    "masked_row_reduce": (bitset_ops.masked_row_reduce,
                          lambda d: (words(100, 4, device=d),
                                     words(7, 4, device=d)),
                          bitset_ops.masked_row_reduce_cost),
    "flash_attention": (flash_attention.flash_attention, flash_case,
                        flash_attention.cost),
    "ssd_scan": (ssd_scan.ssd_scan, ssd_case, ssd_scan.cost),
}


def outputs(out):
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_on_meta(name):
    wrapper, case, cost_fn = CASES[name]
    torch.manual_seed(0)
    cpu_args = case("cpu")
    want = outputs(wrapper(*cpu_args))
    args = tuple(t.to("meta") for t in cpu_args)
    before = dict(_build.LAUNCHES)
    counts, mem, out = roofline.analyze(wrapper, *args)
    assert dict(_build.LAUNCHES) == before
    got = outputs(out)
    assert [(tuple(t.shape), t.dtype) for t in got] == \
        [(tuple(t.shape), t.dtype) for t in want]
    assert all(t.device.type == "meta" for t in got)
    cost = cost_fn(*args)
    assert counts.kernels == {name: 1}
    assert counts.flops == cost.flops
    # The wrapper's own operations move nothing here (contiguous
    # inputs, a built head dim): the bytes are the cost function's.
    assert counts.hbm_bytes == cost.nbytes
    out_bytes = sum(t.untyped_storage().nbytes() for t in got)
    assert mem.output_bytes == out_bytes
    if name == "ssd_scan":
        x, b = args[0], args[3]
        bsz, s, h, p = x.shape
        n = b.shape[3]
        chunks = -(-s // 64)
        assert mem.temp_bytes == 4 * bsz * h * chunks * (n * p + 1)
    else:
        assert mem.temp_bytes == 0


def test_flash_attention_pads_on_meta():
    """hd 16 runs the kernel built for 64: the padded q, k, v and the
    padded output are allocated, the output a view of the last."""
    q, k, v = (t.to("meta") for t in flash_case("cpu", hd=16))
    counts, mem, out = roofline.analyze(flash_attention.flash_attention,
                                        q, k, v)
    assert out.shape == q.shape
    padded = 4 * 4 * (q.numel() + k.numel() + v.numel())
    assert mem.output_bytes == 4 * 4 * q.numel()
    assert mem.temp_bytes == padded
    assert counts.kernels == {"flash_attention": 1}
    assert counts.flops == flash_attention.cost(q, k, v).flops


@pytest.mark.parametrize("name", ["flash_attention", "ssd_scan"])
def test_gradients_on_meta(name):
    wrapper, case, _ = CASES[name]
    args = [t.to("meta").requires_grad_(t.is_floating_point())
            for t in case("cpu")]

    def loss(*xs):
        out = outputs(wrapper(*xs))[0]
        grads = torch.autograd.grad(out.float().sum(), xs)
        return grads
    before = dict(_build.LAUNCHES)
    counts, _, grads = roofline.analyze(loss, *args)
    assert dict(_build.LAUNCHES) == before
    assert [tuple(g.shape) for g in grads] == [tuple(a.shape) for a in args]
    assert counts.kernels == {name: 1}
    assert counts.score_bytes > 0


@pytest.mark.parametrize("name", sorted(CASES))
def test_other_devices_raise(name, monkeypatch):
    """A device that is neither cpu, cuda nor meta has no kernel."""
    wrapper, case, _ = CASES[name]
    args = case("meta")
    monkeypatch.setattr(torch.Tensor, "device", property(
        lambda self: torch.device("xpu")))
    with pytest.raises(ValueError, match="no kernel for xpu"):
        wrapper(*args)


def test_costs_match_the_library_calls():
    """``ops`` routes each name to the wrapper the costs describe."""
    q, k, v = (t.to("meta") for t in flash_case("cpu"))
    counts, _, _ = roofline.analyze(ops.flash_attention, q, k, v)
    assert counts.kernels == {"flash_attention": 1}
    x = ssd_case("meta")
    counts, _, _ = roofline.analyze(lambda *a: ops.ssd_scan(*a, chunk=16),
                                    *x)
    assert counts.flops == ssd_scan.cost(*x, chunk=16).flops

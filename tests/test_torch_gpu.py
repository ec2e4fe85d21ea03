"""Card-only tests of the port: the CUDA kernel against its plain version
on CUDA tensors, and a solve on the card against the same solve on the
CPU.  This file imports neither ``jax`` nor ``repro``, so it runs on a
machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

Each test decides inside itself whether a card is present and skips
without one.
"""

import numpy as np
import pytest
import torch

from repro_torch import registry
from repro_torch.convert import words
from repro_torch.kernels import bitset_degree, bitset_ops, ref
from repro_torch.problems.graphs import circulant_graph, full_mask, num_words
from repro_torch.solver import Solver, SolverConfig


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


def random_words(rng, shape):
    return rng.randint(0, 2 ** 32, size=shape, dtype=np.uint64).astype(
        np.uint32)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 31, 33, 100, 300, 1000])
def test_cuda_kernel_equals_plain_version(n):
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
def test_cuda_kernel_rejects_rows_wider_than_it_takes():
    need_card()
    t = torch.zeros((1100, 35), dtype=torch.int32, device="cuda")
    m = torch.zeros((2, 35), dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError):
        bitset_ops.count_stats(t, m, m)


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

"""Card-only tests of the port: the CUDA kernels against their plain
versions on CUDA tensors, and a solve and a service drain on the card
against the same on the CPU.  This file imports neither ``jax`` nor
``repro``, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

Each test decides inside itself whether a card is present and skips
without one.
"""

import numpy as np
import pytest
import torch

from repro_torch import registry
from repro_torch.convert import to_numpy, words
from repro_torch.kernels import bitset_degree, bitset_ops, ref
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


@pytest.mark.gpu
@pytest.mark.parametrize("k,n", [(1, 33), (4, 100), (16, 300)])
def test_stacked_kernel_equals_plain_version(k, n):
    need_card()
    rng = np.random.RandomState(k * n)
    w = num_words(n)
    for lanes in (1, 7, 1024):
        tables = random_words(rng, (k, n, w))
        mask = random_words(rng, (lanes, w))
        valid = mask & random_words(rng, mask.shape)
        inst = rng.randint(-1, k, size=lanes).astype(np.int32)
        inst[0] = -1                                  # a parked lane
        for ids in (inst, np.full_like(inst, -1)):    # and all parked
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
def test_service_on_the_card_equals_the_cpu():
    need_card()
    mix = [("vc", "gnp:20:30:5", {}), ("ds", "gnp:16:30:7", {}),
           ("vc", "reg:18:3:2", {"priority": 2}),
           ("ds", "gnp:18:25:4", {"node_budget": 40})]
    runs = {}
    for device in ("cuda", "cpu"):
        svc = Solver(SolverConfig(lanes=16, steps_per_round=6,
                                  device=device)).serve(max_n=20, slots=2)
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
    for a, b in zip(to_numpy(gpu.lanes), to_numpy(cpu.lanes)):
        for x, y in zip(*((v,) if isinstance(v, np.ndarray) else tuple(v)
                          for v in (a, b))):
            assert np.array_equal(x, y)

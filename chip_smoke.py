#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py            # all phases, one card

Phases (any failure raises and exits non-zero):

  1. build ``count_stats`` and ``stacked_count_stats`` from
     ``kernels/csrc`` with nvcc, both at once; print the card and its
     power limit;
  2. hold ``count_stats`` bitwise against its plain PyTorch version on
     CUDA tensors (n in {1, 31, 33, 100, 300, 1000} x L in {1, 7, 1024,
     8192}, all-invalid lanes, all-tied circulant degrees) and the
     ``degree_stats`` / ``domination_stats`` bindings;
  3. drain ``vc gnp:100:10:7`` and ``ds gnp:60:10:5`` at 1024 lanes
     through ``Solver.solve`` and check the optima (69, 11); run one
     drained solve on the card and on the CPU and require identical
     ``SolveStats`` and lane arrays;
  4. the 60-cell analogue of the paper, ``vc cell60`` (n=300, w=10) at
     4096 lanes: a fixed number of rounds through ``Solver.solve``
     (nodes/s); the same first rounds driven step by step through
     ``make_step`` with the kernel checked against the plain version on
     every step's live masks; the round time split into expand and
     balance; one round under the profiler for the card's busy share;
  5. time ``count_stats`` (profiler device time, and CUDA events) and its
     plain version at (n=300, w=10, L=4096) and (n=100, w=4, L=1024),
     and compute the bound from the inputs;
  6. hold ``stacked_count_stats`` bitwise against its plain version (K in
     {1, 4, 16} x n in {1, 31, 33, 100, 300, 1000} x L in {1, 7, 1024,
     8192}; mixed ids with parked lanes, all lanes parked, all-tied
     circulant tables);
  7. the multi-tenant service at full width through ``Solver.serve``:
     1024 lanes, 4 slots of n = 100, 8 requests of both families drained
     to their serial optima; the same first rounds again with the kernel
     checked against the plain version on every step's live inputs; one
     round's split into expand, balance and an admission's rebuild; one
     service round under the profiler;
  8. the test-sized service mix (a deadline, a budget, a cancel) on the
     card and on the CPU: identical results, tickets, rounds and lanes
     after every round;
  9. checkpoints: a service saved mid-run on the card restores onto 512
     lanes and drains to the same optima; a solve saved on the card
     resumes on the CPU to the same optimum;
 10. time ``stacked_count_stats`` and its plain version at the service's
     shape (K=4, n=100, L=1024) and at (K=16, n=300, L=4096), and print
     the ``kernels`` line for both kernels.

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Details go to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import json
import pathlib
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
KERNELS = ("count_stats", "stacked_count_stats")
CSRC = "src/repro_torch/kernels/csrc/{}.cu"
REPLACES = {"count_stats": "src/repro/kernels/bitset_ops.py:258",
            "stacked_count_stats": "src/repro/kernels/bitset_ops.py:374"}

#: H100 SXM: 132 SMs, HBM at 3.35 TB/s (NVIDIA data sheet).  __popc issues
#: 16 results per clock per SM on compute capability 9.0 (CUDA C++
#: Programming Guide, arithmetic instruction throughput table).
HBM_BYTES_PER_S = 3.35e12
POPC_PER_CLOCK_PER_SM = 16

#: Where the port runs, and the sizes of each phase.
DEV = "cuda"
PARITY_NS = (1, 31, 33, 100, 300, 1000)
PARITY_LANES = (1, 7, 1024, 8192)
DRAIN = (("vc", "gnp:100:10:7", 69), ("ds", "gnp:60:10:5", 11))
DRAIN_LANES = 1024
TWIN = ("vc", "gnp:60:15:7", 64)          # solved on the card and the CPU
CELL60_LANES = 4096
STACKED_KS = (1, 4, 16)
#: The service phase: 4 slots of n = 100 on 1024 lanes, 8 requests, so
#: slots are reused.  Optima from the reference's serial oracle:
#:   PYTHONPATH=src python -c "from repro import registry; \
#:     from repro.core.serial import serial_rb; \
#:     print(serial_rb(registry.problem('vc', 'gnp:100:10:7').oracle())[0])"
#: (and likewise for each instance below).
SERVICE = dict(lanes=1024, steps=64, max_n=100, slots=4, restore_lanes=512)
SERVICE_MIX = (("vc", "gnp:100:10:7", 69), ("ds", "gnp:60:10:5", 11),
               ("vc", "gnp:60:15:7", 42), ("vc", "gnp:40:20:3", 27),
               ("ds", "gnp:30:15:2", 8), ("vc", "reg:36:4:3", 21),
               ("ds", "gnp:25:20:6", 6), ("ds", "gnp:40:15:3", 8))
#: The test-sized service mix run on the card and on the CPU: rid 1
#: expires on its deadline, rid 3 on its node budget, rid 4 is cancelled
#: before round 10 while it runs.
SVC_TWIN_MIX = (("vc", "gnp:20:30:5", {}),
                ("ds", "gnp:16:30:7", {"deadline_rounds": 2}),
                ("vc", "reg:18:3:2", {"priority": 3}),
                ("ds", "gnp:18:25:4", {"node_budget": 40}),
                ("vc", "gnp:16:35:9", {}), ("ds", "gnp:14:25:2", {}))
SVC_TWIN_CANCEL = (4, 9)
#: A solve checkpointed on the card and resumed on the CPU (optimum from
#: the serial oracle, as above).
SOLVE_CKPT = ("vc", "gnp:60:15:7", 42)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def sync_ms(fn):
    """(host milliseconds of ``fn()`` between two synchronizes, result)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


# -- phase 2 ----------------------------------------------------------------

def rand_words(rng, shape):
    return rng.randint(0, 2 ** 32, size=shape, dtype=np.uint64).astype(
        np.uint32)


def random_case(rng, n, lanes):
    from repro_torch.convert import words
    from repro_torch.problems.graphs import num_words
    w = num_words(n)
    table = rand_words(rng, (n, w))
    mask = rand_words(rng, (lanes, w))
    valid = mask & rand_words(rng, (lanes, w))
    valid[:: 3] = 0                       # every third lane: nothing valid
    return words(table, DEV), words(mask, DEV), words(valid, DEV)


def tied_case(rng, n, lanes):
    """All-tied degrees: every vertex of a circulant graph has degree 4
    under the full mask, so the smallest valid id must win across thread,
    warp and block boundaries."""
    from repro_torch.convert import words
    from repro_torch.problems.graphs import circulant_graph, full_mask
    g = circulant_graph(n, (1, 7) if n > 14 else (1,))
    mask = np.broadcast_to(full_mask(n), (lanes, g.words)).copy()
    valid = mask & rand_words(rng, mask.shape)
    valid[:: 5] = mask[:: 5]
    return words(g.adj, DEV), words(mask, DEV), words(valid, DEV)


def compare(kernel_out, plain_out, what, parity):
    """Hold a kernel's output bitwise against its plain version's;
    ``parity`` is that kernel's tally (compared, mismatches, max_abs_err)."""
    torch.cuda.synchronize()
    err = int((kernel_out.long() - plain_out.long()).abs().max())
    parity["max_abs_err"] = max(parity["max_abs_err"], err)
    parity["compared"] += 1
    if not torch.equal(kernel_out, plain_out):
        parity["mismatches"] += 1
        raise RuntimeError(f"chip_smoke: kernel != plain on {what} "
                           f"(max abs err {err})")


def phase_parity(report):
    from repro_torch.kernels import bitset_degree, bitset_ops, ref
    parity = report["parity"]["count_stats"]
    rng = np.random.RandomState(0)
    shapes = []
    for n in PARITY_NS:
        for lanes in PARITY_LANES:
            for kind, make in (("random", random_case), ("tied", tied_case)):
                if kind == "tied" and n < 3:
                    continue
                table, mask, valid = make(rng, n, lanes)
                out = bitset_ops.count_stats(table, mask, valid)
                compare(out, ref.count_stats_ref(table, mask, valid),
                        f"count_stats {kind} n={n} L={lanes}", parity)
                deg = bitset_degree.degree_stats(table, mask)
                compare(deg, ref.degree_stats_ref(table, mask),
                        f"degree_stats n={n} L={lanes}", parity)
                fullm = mask[0].clone()
                dom = bitset_ops.domination_stats(table, valid, mask, fullm)
                compare(dom, ref.domination_stats_ref(table, valid, mask,
                                                      fullm),
                        f"domination_stats n={n} L={lanes}", parity)
                shapes.append((kind, n, lanes))
    print(f"phase 2: count_stats / degree_stats / domination_stats bitwise "
          f"equal to plain on {parity['compared']} calls over "
          f"{len(shapes)} cases", flush=True)


# -- phases 3 and 4 ---------------------------------------------------------

def run_solve(problem, instance, lanes, device, max_rounds=100000):
    from repro_torch import registry
    from repro_torch.kernels import bitset_ops
    from repro_torch.solver import Solver, SolverConfig
    cfg = SolverConfig(lanes=lanes, steps_per_round=64, bootstrap_rounds=4,
                       bootstrap_steps=8, max_rounds=max_rounds,
                       device=device)
    handle = registry.problem(problem, instance)
    bitset_ops.reset_launches()
    ms, res = sync_ms(lambda: Solver(cfg).solve(handle))
    launches = bitset_ops.LAUNCHES["count_stats"]
    return res, ms, launches


def phase_drain(report):
    for problem, instance, want in DRAIN:
        res, ms, launches = run_solve(problem, instance, DRAIN_LANES, DEV)
        s = res.stats
        print(f"phase 3: {problem} {instance} lanes={DRAIN_LANES}: "
              f"optimum={s.best} "
              f"rounds={s.rounds} nodes={s.nodes} T_S={s.t_s} T_R={s.t_r} "
              f"wall={ms:.1f} ms nodes/s={s.nodes / ms * 1e3:.0f} "
              f"count_stats launches={launches}", flush=True)
        check(s.best == want, f"{problem} {instance}: optimum {s.best} != "
                              f"{want}")
        check(launches > 0, f"{problem} {instance}: count_stats never "
                            f"launched on the solve path")
        report["solves"].append(dict(problem=problem, instance=instance,
                                     lanes=DRAIN_LANES, stats=s._asdict(),
                                     wall_ms=ms, launches=launches))
        report["launches"]["count_stats"] += launches

    # The same drained solve on the card and on the CPU.
    gpu, gpu_ms, launches = run_solve(*TWIN, DEV)
    cpu, cpu_ms, _ = run_solve(*TWIN, "cpu")
    print(f"phase 3: {' '.join(map(str, TWIN))} (problem, instance, lanes)"
          f"\n  cuda {tuple(gpu.stats)} "
          f"({gpu_ms:.0f} ms, {launches} launches)\n  cpu  "
          f"{tuple(cpu.stats)} ({cpu_ms:.0f} ms)", flush=True)
    for field in gpu.stats._fields:
        print(f"  {field:8s} cuda={getattr(gpu.stats, field)} "
              f"cpu={getattr(cpu.stats, field)}")
    check(gpu.stats == cpu.stats, "SolveStats differ between cuda and cpu")
    check(launches > 0, "count_stats never launched on the cuda solve")
    check_same_lanes(gpu.lanes, cpu.lanes, "solve twin")
    report["launches"]["count_stats"] += launches
    report["cpu_vs_cuda"] = dict(problem=TWIN[0], instance=TWIN[1],
                                 lanes=TWIN[2],
                                 stats=gpu.stats._asdict(), cuda_ms=gpu_ms,
                                 cpu_ms=cpu_ms)


def phase_cell60(report, rounds_after_boot=2):
    from repro_torch.convert import words
    from repro_torch.core import steal
    from repro_torch.core.engine import init_lanes, make_expand, make_step
    from repro_torch.kernels import bitset_ops, ref
    from repro_torch.problems.graphs import cell60_graph
    from repro_torch.problems.vertex_cover import make_vertex_cover

    lanes_n = CELL60_LANES
    graph = cell60_graph()
    problem = make_vertex_cover(graph, device=DEV)
    adj = words(graph.adj, DEV)

    # (a) The main path: Solver.solve for 4 bootstrap + N main rounds.  The
    # root's bound, ceil(m / max degree) = 150, is the optimum of this
    # 4-regular analogue, so the search may drain before N rounds.
    res, ms, launches = run_solve("vc", "cell60", lanes_n, DEV,
                                  max_rounds=4 + rounds_after_boot)
    s = res.stats
    drained = int(res.lanes.active.sum()) == 0
    print(f"phase 4: vc cell60 lanes={lanes_n} rounds={s.rounds}: "
          f"incumbent={s.best} nodes={s.nodes} T_S={s.t_s} T_R={s.t_r} "
          f"wall={ms:.1f} ms nodes/s={s.nodes / ms * 1e3:.0f} "
          f"count_stats launches={launches} drained={drained}", flush=True)
    check(s.rounds == 4 + rounds_after_boot or (drained and s.best == 150),
          f"cell60: {s.rounds} rounds, drained={drained}, best={s.best}")
    check(launches > 0, "cell60: count_stats never launched")
    report["launches"]["count_stats"] += launches
    report["solves"].append(dict(problem="vc", instance="cell60",
                                 lanes=lanes_n, stats=s._asdict(),
                                 wall_ms=ms, launches=launches))

    # (b) The same rounds driven step by step through make_step: the
    # kernel on every step's live alive masks, held against the plain
    # version, for the 4 bootstrap rounds and the first main round.
    step = make_step(problem)
    lanes = init_lanes(problem, lanes_n)
    il = lanes.idx.shape[1]
    ar = torch.arange(lanes_n, device=DEV)
    checked = 0
    for steps in [8] * 4 + [64]:
        for _ in range(steps):
            alive = lanes.stack.alive[ar, lanes.depth.clamp(0, il - 1)]
            compare(bitset_ops.count_stats(adj, alive, alive),
                    ref.count_stats_ref(adj, alive, alive),
                    "cell60 live masks", report["parity"]["count_stats"])
            checked += 1
            ran = lanes.active.any().to(torch.int32)
            lanes = step(lanes)._replace(steps=lanes.steps + ran)
        lanes = steal.balance_device(problem, lanes)
    active = int(lanes.active.sum())
    print(f"phase 4: cell60 lanes={lanes_n}: kernel == plain on the live "
          f"masks of all {checked} steps of the first 5 rounds "
          f"({active} lanes active after them)", flush=True)

    # (c) Round time split from there: expand (64 steps) vs balance (steal
    # + CONVERTINDEX replay), each between two synchronizes.
    expand = make_expand(problem, 64)
    split = []
    for _ in range(2):
        before = bitset_ops.LAUNCHES["count_stats"]
        nodes0 = int(lanes.nodes.sum())
        t_exp, lanes = sync_ms(lambda: expand(lanes))
        mid = bitset_ops.LAUNCHES["count_stats"]
        t_bal, lanes = sync_ms(lambda: steal.balance_device(problem, lanes))
        after = bitset_ops.LAUNCHES["count_stats"]
        split.append(dict(expand_ms=t_exp, balance_ms=t_bal,
                          expand_launches=mid - before,
                          balance_launches=after - mid,
                          nodes=int(lanes.nodes.sum()) - nodes0,
                          active_after=int(lanes.active.sum())))
        check(mid - before == 64 and after - mid == il,
              f"launches per round: expand {mid - before} (want 64), "
              f"balance {after - mid} (want {il})")
    for r in split:
        share = r["expand_ms"] / (r["expand_ms"] + r["balance_ms"])
        print(f"phase 4: round split: expand {r['expand_ms']:.1f} ms "
              f"({r['expand_launches']} launches), balance "
              f"{r['balance_ms']:.1f} ms ({r['balance_launches']} launches), "
              f"expand share {share:.3f}, nodes {r['nodes']}, "
              f"active lanes after {r['active_after']}", flush=True)
    report["cell60_split"] = split

    # (d) One more round under the profiler: how busy the card is.
    busy = {}
    for name, fn in (("expand", expand),
                     ("balance", lambda l: steal.balance_device(problem, l))):
        busy[name] = device_busy(lambda: fn(lanes))
        lanes = busy[name].pop("out")
        print(f"phase 4: profiled {name}: wall {busy[name]['wall_ms']:.1f} ms, "
              f"device busy {busy[name]['device_ms']:.2f} ms "
              f"(share {busy[name]['busy_share']:.3f}) over "
              f"{busy[name]['device_ops']} device operations, count_stats "
              f"{busy[name]['kernel_ms']['count_stats']:.2f} ms", flush=True)
    report["cell60_busy"] = busy
    return lanes


def is_kernel(name, key):
    """Does the profiler's ``key`` (mangled or demangled) name the kernel
    of ``csrc/<name>.cu``?  ``count_stats`` must not match
    ``stacked_count_stats``."""
    return re.search(r"(?<![A-Za-z_])" + name + "_kernel", key) is not None


def device_busy(fn):
    """Wall time of ``fn()`` between two synchronizes, and the device time
    the profiler records inside it (kernels and copies on the card), with
    each of the port's kernels' share."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_ms, out = sync_ms(fn)
    device_us, ops = 0.0, 0
    kernel_us = dict.fromkeys(KERNELS, 0.0)
    for evt in prof.key_averages():
        us = evt.self_device_time_total
        if us > 0:
            device_us += us
            ops += evt.count
            for name in KERNELS:
                if is_kernel(name, evt.key):
                    kernel_us[name] += us
    return dict(wall_ms=wall_ms, device_ms=device_us / 1e3,
                busy_share=device_us / 1e3 / wall_ms, device_ops=ops,
                kernel_ms={k: v / 1e3 for k, v in kernel_us.items()},
                out=out)


# -- phase 5 ----------------------------------------------------------------

def time_kernel(kernel, plain, name, iters=200):
    """(CUDA-event ms, profiler device ms or None, plain ms) per call of
    ``kernel`` / ``plain``; ``name`` is the kernel's source in ``csrc``."""
    from torch.profiler import ProfilerActivity, profile

    def events_ms(fn, n_iter):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n_iter):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / n_iter

    ev_ms = events_ms(kernel, iters)
    plain_ms = events_ms(plain, 20)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(50):
            kernel()
        torch.cuda.synchronize()
    prof_ms = None
    for evt in prof.key_averages():
        if is_kernel(name, evt.key) and evt.device_time_total:
            prof_ms = evt.device_time_total / evt.count / 1e3
    return ev_ms, prof_ms, plain_ms


def bound(popcounts, bytes_moved, clock_hz, sms):
    """The least time for the work: popcount issue or HBM traffic."""
    ops_s = popcounts / (POPC_PER_CLOCK_PER_SM * sms * clock_hz)
    bytes_s = bytes_moved / HBM_BYTES_PER_S
    return (max(ops_s, bytes_s) * 1e3,
            "operations" if ops_s >= bytes_s else "bytes")


def timed(name, kernel, plain, popcounts, bytes_moved, clock_hz, sms,
          iters=200, **shape):
    """Kernel time (profiler device time and CUDA events), plain time and
    the bound for one input of the kernel of ``csrc/<name>.cu``."""
    ev_ms, prof_ms, plain_ms = time_kernel(kernel, plain, name, iters)
    bound_ms, bound_by = bound(popcounts, bytes_moved, clock_hz, sms)
    return dict(shape, ms=prof_ms if prof_ms is not None else ev_ms,
                ms_source="profiler" if prof_ms is not None else "events",
                ms_events=ev_ms, ms_profiler=prof_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by,
                popcounts=popcounts, bytes=bytes_moved)


def kernel_times(table, mask, valid, clock_hz, sms):
    """``count_stats`` timed on one input; its bound counts the popcounts
    of every valid vertex, or the bytes of reading each input once and
    writing the output once."""
    from repro_torch.kernels import bitset_ops, ref
    from repro_torch.kernels.ref import bit_set
    n, w = table.shape
    lanes = mask.shape[0]
    n_valid = int(bit_set(valid, n).sum())
    return timed("count_stats",
                 lambda: bitset_ops.count_stats(table, mask, valid),
                 lambda: ref.count_stats_ref(table, mask, valid),
                 n_valid * w, 4 * (n * w + 2 * lanes * w + 4 * lanes),
                 clock_hz, sms, n=n, w=w, L=lanes, valid_pairs=n_valid)


def live_alive(lanes):
    """Each lane's alive mask at its current depth: what the next engine
    step hands the kernel."""
    il = lanes.idx.shape[1]
    ar = torch.arange(lanes.idx.shape[0], device=DEV)
    return lanes.stack.alive[ar, lanes.depth.clamp(0, il - 1)]


def phase_timing(cell60_lanes, report):
    """The kernel at (n=300, w=10, L=4096) and (n=100, w=4, L=1024).  At
    cell60's shape it is timed on the heaviest masks of that shape (every
    lane at the root: all 300 vertices alive, L*n*w = 12.3 M popcounts)
    and on the live masks the search left; at the small shape on the live
    masks of a saturated ``vc gnp:100:10:7`` solve."""
    from repro_torch.convert import words
    from repro_torch.problems.graphs import (cell60_graph, full_mask,
                                             parse_graph_instance)
    clock_hz = float(smi("clocks.max.sm").split()[0]) * 1e6
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    adj = words(cell60_graph().adj, DEV)
    root = words(np.broadcast_to(full_mask(300), (CELL60_LANES, 10)).copy(),
                 DEV)
    full = dict(kernel_times(adj, root, root, clock_hz, sms),
                masks="cell60, every lane at the root")
    alive = live_alive(cell60_lanes)
    live = dict(kernel_times(adj, alive, alive, clock_hz, sms),
                masks="cell60, live masks after the split rounds")

    problem, instance, _ = DRAIN[0]
    res, _, _ = run_solve(problem, instance, DRAIN_LANES, DEV, max_rounds=14)
    alive = live_alive(res.lanes)
    small = dict(kernel_times(words(parse_graph_instance(instance).adj, DEV),
                              alive, alive, clock_hz, sms),
                 masks=f"{instance}, live masks after 14 rounds "
                       f"({int(res.lanes.active.sum())} lanes active)")
    for t in (full, live, small):
        print(f"phase 5: count_stats n={t['n']} w={t['w']} L={t['L']} "
              f"({t['masks']}): kernel {t['ms'] * 1e3:.2f} us "
              f"({t['ms_source']}; events {t['ms_events'] * 1e3:.2f} us), "
              f"plain {t['plain_ms'] * 1e3:.1f} us, bound "
              f"{t['bound_ms'] * 1e3:.3f} us ({t['bound_by']}: "
              f"{t['popcounts']} popcounts, {t['bytes']} bytes)", flush=True)
    report["timing"] = [full, live, small]
    report["clock_max_sm_hz"] = clock_hz
    report["sms"] = sms
    return full, live, small


# -- phase 6 ----------------------------------------------------------------

def stacked_case(rng, k, n, lanes, kind):
    """Inputs of ``stacked_count_stats``: random tables with mixed ids (a
    third of the lanes parked), the same with every lane parked, or
    circulant tables, whose counts all tie under the full mask."""
    from repro_torch.convert import words
    from repro_torch.problems.graphs import (circulant_graph, full_mask,
                                             num_words)
    w = num_words(n)
    if kind == "tied":
        tables = np.stack([circulant_graph(n, (1, 2 + s)).adj
                           for s in range(k)])
        mask = np.broadcast_to(full_mask(n), (lanes, w)).copy()
    else:
        tables = rand_words(rng, (k, n, w))
        mask = rand_words(rng, (lanes, w))
    valid = mask & rand_words(rng, (lanes, w))
    valid[1::5] = mask[1::5]
    inst = rng.randint(0, k, size=lanes).astype(np.int32)
    inst[::3] = -1
    if kind == "parked":
        inst[:] = -1
    return (words(tables, DEV), torch.from_numpy(inst).to(DEV),
            words(mask, DEV), words(valid, DEV))


def phase_stacked_parity(report):
    from repro_torch.kernels import bitset_ops, ref
    parity = report["parity"]["stacked_count_stats"]
    rng = np.random.RandomState(1)
    parked_row = torch.tensor([-1, -1, 0, 0], dtype=torch.int32, device=DEV)
    cases = 0
    for k in STACKED_KS:
        for n in PARITY_NS:
            for lanes in PARITY_LANES:
                for kind in ("mixed", "parked", "tied"):
                    if kind == "tied" and n < 3:
                        continue
                    tables, inst, mask, valid = stacked_case(rng, k, n,
                                                             lanes, kind)
                    out = bitset_ops.stacked_count_stats(tables, inst, mask,
                                                         valid)
                    compare(out, ref.stacked_count_stats_ref(tables, inst,
                                                             mask, valid),
                            f"stacked_count_stats {kind} K={k} n={n} "
                            f"L={lanes}", parity)
                    check(bool((out[inst < 0] == parked_row).all()),
                          f"parked lanes not (-1, -1, 0, 0) at K={k} n={n} "
                          f"L={lanes}")
                    cases += 1
    print(f"phase 6: stacked_count_stats bitwise equal to plain on {cases} "
          f"cases (mixed ids with parked lanes, all parked, all tied)",
          flush=True)


# -- phases 7 to 9 ----------------------------------------------------------

def new_service(device, lanes, steps, max_n, slots):
    from repro_torch.solver import Solver, SolverConfig
    return Solver(SolverConfig(lanes=lanes, steps_per_round=steps,
                               device=device)).serve(max_n=max_n, slots=slots)


def submit_all(svc, mix):
    """Submit ``(family, spec, lifecycle kwargs)`` as rids 0, 1, ...;
    returns the tickets."""
    from repro_torch.problems.graphs import parse_graph_instance
    from repro_torch.service import SolveRequest
    return [svc.submit(SolveRequest(rid=rid, graph=parse_graph_instance(spec),
                                    family=family, **kw))
            for rid, (family, spec, kw) in enumerate(mix)]


def check_optima(results, what):
    for rid, (family, spec, want) in enumerate(SERVICE_MIX):
        res = results[rid]
        check(res.status == "done" and res.optimum == want,
              f"{what}: rid {rid} {family} {spec}: {res.status} "
              f"{res.optimum} (want done {want})")


def check_same_lanes(a, b, what):
    from repro_torch.convert import to_numpy
    a_np, b_np = to_numpy(a), to_numpy(b)
    for field in a_np._fields:
        for x, y in zip(*((v,) if isinstance(v, np.ndarray) else tuple(v)
                          for v in (getattr(a_np, field),
                                    getattr(b_np, field)))):
            check(np.array_equal(x, y), f"{what}: lanes.{field} differ")


def phase_service(report):
    """The main path of the slice: ``Solver.serve`` at full width, drained,
    with the launch counts set to 0 just before and read just after."""
    from repro_torch.kernels import bitset_ops
    cfg = SERVICE
    svc = new_service(DEV, cfg["lanes"], cfg["steps"], cfg["max_n"],
                      cfg["slots"])
    submit_all(svc, [(f, s, {}) for f, s, _ in SERVICE_MIX])
    bitset_ops.reset_launches()
    ms, results = sync_ms(svc.drain)
    launches = dict(bitset_ops.LAUNCHES)
    check_optima(results, "service")
    il = svc.lanes.idx.shape[1]
    per_round = cfg["steps"] + il          # expand steps + steal replay
    extra = launches["stacked_count_stats"] - svc.rounds * per_round
    check(extra >= 0 and extra % il == 0,
          f"service: {launches['stacked_count_stats']} stacked_count_stats "
          f"launches in {svc.rounds} rounds (want {per_round} per round "
          f"plus {il} per admission rebuild)")
    check(launches["count_stats"] == 0,
          "service: the single-table count_stats ran on the service path")
    nodes = int(svc.lanes.nodes.sum())
    print(f"phase 7: service lanes={cfg['lanes']} slots={cfg['slots']} "
          f"max_n={cfg['max_n']}: {len(SERVICE_MIX)} requests drained to "
          f"their serial optima in {svc.rounds} rounds, wall={ms:.1f} ms, "
          f"instances/s={len(SERVICE_MIX) / ms * 1e3:.3f}, nodes={nodes} "
          f"nodes/s={nodes / ms * 1e3:.0f}, stacked_count_stats "
          f"launches={launches['stacked_count_stats']} ({per_round} per "
          f"round, {extra // il} admission rebuilds of {il})", flush=True)
    for rid, (family, spec, _) in enumerate(SERVICE_MIX):
        res = results[rid]
        print(f"  rid={rid} {family}[{spec}] optimum={res.optimum} rounds="
              f"{res.admitted_round}..{res.retired_round}", flush=True)
    report["service"] = dict(
        lanes=cfg["lanes"], slots=cfg["slots"], max_n=cfg["max_n"],
        steps_per_round=cfg["steps"], rounds=svc.rounds, wall_ms=ms,
        requests=len(SERVICE_MIX), nodes=nodes, launches=launches,
        rebuilds=extra // il,
        results={rid: [r.optimum, r.admitted_round, r.retired_round]
                 for rid, r in results.items()})
    report["launches"]["stacked_count_stats"] += launches[
        "stacked_count_stats"]


def phase_service_steps(report, check_rounds=3):
    """The same service again: its first rounds with every kernel launch
    held against the plain version on the live inputs, then one round
    split into expand, balance and an admission's rebuild, and one round
    under the profiler.  Returns the service (mid-run) and its live
    kernel inputs."""
    from repro_torch.core import checkpoint as ckpt
    from repro_torch.core import steal
    from repro_torch.core.api import tree_map
    from repro_torch.core.engine import make_expand
    from repro_torch.kernels import bitset_ops, ref
    from repro_torch.service import batch_problem
    cfg = SERVICE
    parity = report["parity"]["stacked_count_stats"]
    svc = new_service(DEV, cfg["lanes"], cfg["steps"], cfg["max_n"],
                      cfg["slots"])
    submit_all(svc, [(f, s, {}) for f, s, _ in SERVICE_MIX])

    # (a) The bound problem looks the kernel up at call time: route it
    # through a check for the first rounds (expand steps, steal replay and
    # admission rebuilds alike).
    kernel = batch_problem.stacked_count_stats
    checked = [0]

    def checked_kernel(tables, inst, mask, valid):
        out = kernel(tables, inst, mask, valid)
        compare(out, ref.stacked_count_stats_ref(tables, inst, mask, valid),
                "service live inputs", parity)
        checked[0] += 1
        return out

    batch_problem.stacked_count_stats = checked_kernel
    try:
        for _ in range(check_rounds):
            svc.step_round()
    finally:
        batch_problem.stacked_count_stats = kernel
    print(f"phase 7: kernel == plain on all {checked[0]} launches of the "
          f"first {check_rounds} service rounds (slots {svc.slot_rid})",
          flush=True)

    # (b) Round split from there, on copies (the service's lanes stay).
    problem = svc.problem
    expand = make_expand(problem, cfg["steps"])
    lanes = svc.lanes
    split = []
    for _ in range(2):
        c0 = bitset_ops.LAUNCHES["stacked_count_stats"]
        t_exp, after_exp = sync_ms(lambda: expand(lanes))
        c1 = bitset_ops.LAUNCHES["stacked_count_stats"]
        t_bal, after_bal = sync_ms(
            lambda: steal.balance_device(problem, after_exp))
        c2 = bitset_ops.LAUNCHES["stacked_count_stats"]
        t_reb, _ = sync_ms(lambda: ckpt.rebuild_stacks(problem, after_bal))
        c3 = bitset_ops.LAUNCHES["stacked_count_stats"]
        split.append(dict(expand_ms=t_exp, balance_ms=t_bal, rebuild_ms=t_reb,
                          expand_launches=c1 - c0, balance_launches=c2 - c1,
                          rebuild_launches=c3 - c2,
                          active_after=int(after_bal.active.sum())))
        lanes = after_bal
    for r in split:
        print(f"phase 7: service round split: expand {r['expand_ms']:.1f} ms "
              f"({r['expand_launches']} launches), balance "
              f"{r['balance_ms']:.1f} ms ({r['balance_launches']} launches), "
              f"admission rebuild {r['rebuild_ms']:.1f} ms "
              f"({r['rebuild_launches']} launches), active lanes after "
              f"{r['active_after']}", flush=True)
    report["service_split"] = split

    # (c) One service round under the profiler (its result is dropped).
    busy = device_busy(lambda: svc._round(svc.lanes))
    busy.pop("out")
    print(f"phase 7: profiled service round: wall {busy['wall_ms']:.1f} ms, "
          f"device busy {busy['device_ms']:.2f} ms (share "
          f"{busy['busy_share']:.3f}) over {busy['device_ops']} device "
          f"operations, stacked_count_stats "
          f"{busy['kernel_ms']['stacked_count_stats']:.2f} ms", flush=True)
    report["service_busy"] = busy

    # The kernel's live inputs at this point, for the timing phase.
    il = svc.lanes.idx.shape[1]
    ar = torch.arange(svc.num_lanes, device=DEV)
    d = svc.lanes.depth.clamp(0, il - 1)
    states = tree_map(lambda x: x[ar, d], svc.lanes.stack)
    inst, mask, valid = svc.spec.stats_inputs(svc._tables_dev, states)
    live = (svc._tables_dev.adj, inst.contiguous(), mask.contiguous(),
            valid.contiguous())
    return svc, live


def phase_service_twin(report, lanes=16, slots=3, steps=6):
    """The test-sized mix (a deadline, a budget, a cancel) on the card and
    on the CPU, compared after every round."""
    from repro_torch import registry
    from repro_torch.core.serial import serial_rb
    from repro_torch.kernels import bitset_ops
    gpu, cpu = (new_service(d, lanes, steps, 20, slots) for d in (DEV, "cpu"))
    tickets = [submit_all(svc, SVC_TWIN_MIX) for svc in (gpu, cpu)]
    bitset_ops.reset_launches()
    rid_cancel, at_round = SVC_TWIN_CANCEL
    while cpu._has_work():
        check(gpu._has_work(), "twin: the card's service drained early")
        if cpu.rounds == at_round:
            for ticket in (t[rid_cancel] for t in tickets):
                check(ticket.status.value == "running",
                      f"twin: rid {rid_cancel} not running at round "
                      f"{at_round}")
                check(ticket.cancel(), "twin: cancel failed")
        open_gpu, open_cpu = gpu.step_round(), cpu.step_round()
        where = f"twin round {cpu.rounds}"
        check(np.array_equal(open_gpu, open_cpu), f"{where}: open work")
        check_same_lanes(gpu.lanes, cpu.lanes, where)
        check(gpu.slot_rid == cpu.slot_rid and gpu.rounds == cpu.rounds,
              f"{where}: slots or rounds differ")
        check({r: (t.status, t.nodes_used) for r, t in gpu.tickets.items()}
              == {r: (t.status, t.nodes_used)
                  for r, t in cpu.tickets.items()}, f"{where}: tickets")
        check(sorted(gpu.results) == sorted(cpu.results), f"{where}: results")
        for rid, b in cpu.results.items():
            a = gpu.results[rid]
            check((a.optimum, a.admitted_round, a.retired_round, a.status)
                  == (b.optimum, b.admitted_round, b.retired_round, b.status)
                  and np.array_equal(a.payload, b.payload),
                  f"{where}: result of rid {rid}")
    check(not gpu._has_work(), "twin: the card's service did not drain")
    launches = bitset_ops.LAUNCHES["stacked_count_stats"]
    check(launches > 0, "twin: stacked_count_stats never launched")
    status = {rid: r.status for rid, r in cpu.results.items()}
    check(status == {0: "done", 1: "expired", 2: "done", 3: "expired",
                     4: "cancelled", 5: "done"}, f"twin: statuses {status}")
    for rid, (family, spec, _) in enumerate(SVC_TWIN_MIX):
        if status[rid] == "done":
            want = serial_rb(registry.problem(family, spec).oracle())[0]
            check(cpu.results[rid].optimum == want,
                  f"twin: rid {rid} optimum {cpu.results[rid].optimum} != "
                  f"{want}")
    print(f"phase 8: service twin (lanes={lanes}, slots={slots}): card and "
          f"CPU equal after each of {cpu.rounds} rounds (lanes, open work, "
          f"slots, tickets, results); statuses {status}; "
          f"{launches} stacked_count_stats launches on the card", flush=True)
    report["service_twin"] = dict(rounds=cpu.rounds, statuses=status,
                                  launches=launches)


def phase_checkpoints(report, svc):
    """A service saved mid-run on the card restores onto fewer lanes and
    drains to the same optima; a solve saved on the card resumes on the
    CPU (and on the card) to the same optimum and ``SolveStats``."""
    from repro_torch import registry
    from repro_torch.service import SolverService
    from repro_torch.solver import Solver, SolverConfig
    # Run on until more tasks are live than the restore has lanes, so the
    # restore parks the surplus in its pending pool.
    while (int(svc.lanes.active.sum()) <= SERVICE["restore_lanes"]
           and svc.rounds < 16 and len(svc.queue)):
        svc.step_round()
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    svc_path = out / "chip_smoke_service.ckpt"
    svc.save(str(svc_path))
    restored = SolverService.restore(
        str(svc_path), num_lanes=SERVICE["restore_lanes"],
        steps_per_round=SERVICE["steps"], device=DEV)
    check([r.rid for r in restored.queue] == [r.rid for r in svc.queue],
          "restored queue order differs")
    pool, saved_round = len(restored.pool), restored.rounds
    ms, results = sync_ms(restored.drain)
    check_optima(results, f"restore on {SERVICE['restore_lanes']} lanes")
    print(f"phase 9: service saved at round {saved_round} on "
          f"{svc.num_lanes} lanes ({int(svc.lanes.active.sum())} active, "
          f"{len(svc.queue)} queued), restored on "
          f"{restored.num_lanes} lanes ({pool} tasks pooled): drained to "
          f"the same optima by round {restored.rounds} in {ms:.0f} ms",
          flush=True)

    family, instance, want = SOLVE_CKPT
    solve_path = out / "chip_smoke_solve.ckpt"
    base = dict(steps_per_round=64, bootstrap_rounds=4, bootstrap_steps=8)
    handle = registry.problem(family, instance)
    mid = Solver(SolverConfig(lanes=64, max_rounds=6, device=DEV,
                              checkpoint_every=2,
                              checkpoint_path=str(solve_path), **base)
                 ).solve(handle)
    resumed = {d: Solver(SolverConfig(lanes=32, device=d,
                                      resume_from=str(solve_path), **base)
                         ).solve(handle).stats for d in ("cpu", DEV)}
    check(resumed["cpu"].best == want and resumed["cpu"] == resumed[DEV],
          f"solve resume: cpu {tuple(resumed['cpu'])}, card "
          f"{tuple(resumed[DEV])}, want optimum {want}")
    print(f"phase 9: {family} {instance} saved on the card at round "
          f"{mid.stats.rounds} (64 lanes), resumed on 32 lanes: cpu "
          f"{tuple(resumed['cpu'])} == card {tuple(resumed[DEV])}",
          flush=True)
    report["checkpoints"] = dict(
        service_saved_round=saved_round, service_pool=pool,
        service_restore_ms=ms, service_rounds=restored.rounds,
        solve_resumed=resumed["cpu"]._asdict())
    svc_path.unlink()
    solve_path.unlink()


# -- phase 10 ---------------------------------------------------------------

def stacked_times(tables, inst, mask, valid, clock_hz, sms):
    """``stacked_count_stats`` timed on one input; its bound counts the
    popcounts of the valid vertices of every unparked lane, or the bytes
    of reading each input once and writing the output once."""
    from repro_torch.kernels import bitset_ops, ref
    from repro_torch.kernels.ref import bit_set
    k, n, w = tables.shape
    lanes = mask.shape[0]
    n_valid = int(bit_set(valid, n)[inst >= 0].sum())
    return timed("stacked_count_stats",
                 lambda: bitset_ops.stacked_count_stats(tables, inst, mask,
                                                        valid),
                 lambda: ref.stacked_count_stats_ref(tables, inst, mask,
                                                     valid),
                 n_valid * w,
                 4 * (k * n * w + lanes + 2 * lanes * w + 4 * lanes),
                 clock_hz, sms, K=k, n=n, w=w, L=lanes, valid_pairs=n_valid)


def phase_stacked_timing(report, live):
    """The kernel at the service's shape (K=4, n=100, w=4, L=1024) on the
    live inputs of the service phase, and at (K=16, n=300, w=10, L=4096)
    with every lane at the root of its instance."""
    from repro_torch.convert import words
    from repro_torch.problems.graphs import full_mask
    clock_hz, sms = report["clock_max_sm_hz"], report["sms"]
    service = dict(stacked_times(*live, clock_hz, sms),
                   inputs="service phase, live inputs after its split")
    rng = np.random.RandomState(2)
    k, n, lanes = 16, 300, CELL60_LANES
    full = words(np.broadcast_to(full_mask(n), (lanes, 10)).copy(), DEV)
    inst = torch.arange(lanes, dtype=torch.int32, device=DEV) % k
    large = dict(stacked_times(words(rand_words(rng, (k, n, 10)), DEV), inst,
                               full, full, clock_hz, sms),
                 inputs="random tables, every lane at its root")
    for t in (service, large):
        print(f"phase 10: stacked_count_stats K={t['K']} n={t['n']} "
              f"w={t['w']} L={t['L']} ({t['inputs']}): kernel "
              f"{t['ms'] * 1e3:.2f} us ({t['ms_source']}; events "
              f"{t['ms_events'] * 1e3:.2f} us), plain "
              f"{t['plain_ms'] * 1e3:.1f} us, bound "
              f"{t['bound_ms'] * 1e3:.3f} us ({t['bound_by']}: "
              f"{t['popcounts']} popcounts, {t['bytes']} bytes)", flush=True)
    report["stacked_timing"] = [service, large]
    return service, large


# -- driver -----------------------------------------------------------------

def kernel_entry(name, report, headline, shapes):
    parity = report["parity"][name]
    return {"name": name, "route": "cuda", "source": CSRC.format(name),
            "replaces": REPLACES[name], "launches": report["launches"][name],
            "max_abs_err": parity["max_abs_err"], "ms": headline["ms"],
            "plain_ms": headline["plain_ms"],
            "bound_ms": headline["bound_ms"],
            "bound_by": headline["bound_by"], "library_ms": None,
            "library": "none: no single PyTorch call computes this function",
            "mismatches": parity["mismatches"],
            "compared": parity["compared"], "tolerance": "bitwise (0)",
            "shapes": shapes}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false: no card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    t_start = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    card = smi("name,power.limit")
    print(f"phase 1: torch {torch.__version__} cuda {torch.version.cuda} "
          f"on {kind}; nvidia-smi: {card}", flush=True)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:    # one nvcc per source
        libs = list(pool.map(_build.build, KERNELS))
    build_s = time.perf_counter() - t0
    for lib in libs:
        print(f"phase 1: built {lib.name} ({build_s:.1f} s for all); nvcc: "
              f"{pathlib.Path(str(lib) + '.log').read_text().strip()}",
              flush=True)

    report = dict(device=kind, card=card, build_s=build_s,
                  parity={k: dict(compared=0, mismatches=0, max_abs_err=0)
                          for k in KERNELS},
                  launches=dict.fromkeys(KERNELS, 0), solves=[])
    phase_parity(report)
    phase_drain(report)
    cell60_lanes = phase_cell60(report)
    full, live, small = phase_timing(cell60_lanes, report)
    phase_stacked_parity(report)
    phase_service(report)
    svc, service_inputs = phase_service_steps(report)
    phase_service_twin(report)
    phase_checkpoints(report, svc)
    service, large = phase_stacked_timing(report, service_inputs)
    kernels_line = {"kernels": [
        kernel_entry("count_stats", report, full, [full, live, small]),
        kernel_entry("stacked_count_stats", report, service,
                     [service, large])]}
    report["seconds"] = time.perf_counter() - t_start
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    print(f"all phases passed in {report['seconds']:.1f} s", flush=True)
    print(smi("name,power.limit"))
    print(json.dumps(kernels_line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

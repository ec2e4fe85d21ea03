#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py            # all phases, one card

Phases (any failure raises and exits non-zero):

  1. build ``count_stats`` from ``kernels/csrc`` with nvcc; print the
     card and its power limit;
  2. hold the kernel bitwise against its plain PyTorch version on CUDA
     tensors (n in {1, 31, 33, 100, 300, 1000} x L in {1, 7, 1024, 8192},
     all-invalid lanes, all-tied circulant degrees) and the
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
  5. time the kernel (profiler device time, and CUDA events) and its
     plain version at (n=300, w=10, L=4096) and (n=100, w=4, L=1024),
     compute the bound from the inputs, and print the ``kernels`` line.

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Details go to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
SRC = "src/repro_torch/kernels/csrc/count_stats.cu"
REPLACES = "src/repro/kernels/bitset_ops.py:258"

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

def random_case(rng, n, lanes):
    from repro_torch.convert import words
    from repro_torch.problems.graphs import num_words
    w = num_words(n)
    table = rng.randint(0, 2 ** 32, size=(n, w), dtype=np.uint64).astype(
        np.uint32)
    mask = rng.randint(0, 2 ** 32, size=(lanes, w), dtype=np.uint64).astype(
        np.uint32)
    valid = mask & rng.randint(0, 2 ** 32, size=(lanes, w),
                               dtype=np.uint64).astype(np.uint32)
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
    valid = mask & rng.randint(0, 2 ** 32, size=mask.shape,
                               dtype=np.uint64).astype(np.uint32)
    valid[:: 5] = mask[:: 5]
    return words(g.adj, DEV), words(mask, DEV), words(valid, DEV)


def compare(kernel_out, plain_out, what, report):
    torch.cuda.synchronize()
    err = int((kernel_out.long() - plain_out.long()).abs().max())
    report["max_abs_err"] = max(report["max_abs_err"], err)
    report["compared"] += 1
    if not torch.equal(kernel_out, plain_out):
        report["mismatches"] += 1
        raise RuntimeError(f"chip_smoke: kernel != plain on {what} "
                           f"(max abs err {err})")


def phase_parity(report):
    from repro_torch.kernels import bitset_degree, bitset_ops, ref
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
                        f"count_stats {kind} n={n} L={lanes}", report)
                deg = bitset_degree.degree_stats(table, mask)
                compare(deg, ref.degree_stats_ref(table, mask),
                        f"degree_stats n={n} L={lanes}", report)
                fullm = mask[0].clone()
                dom = bitset_ops.domination_stats(table, valid, mask, fullm)
                compare(dom, ref.domination_stats_ref(table, valid, mask,
                                                      fullm),
                        f"domination_stats n={n} L={lanes}", report)
                shapes.append((kind, n, lanes))
    print(f"phase 2: count_stats / degree_stats / domination_stats bitwise "
          f"equal to plain on {report['compared']} calls over "
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
    from repro_torch.convert import to_numpy
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
        report["launches"] += launches

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
    g_np, c_np = to_numpy(gpu.lanes), to_numpy(cpu.lanes)
    for field in g_np._fields:
        for a, b in zip(*(
                (x,) if isinstance(x, np.ndarray) else tuple(x)
                for x in (getattr(g_np, field), getattr(c_np, field)))):
            check(np.array_equal(a, b), f"lanes.{field} differ cuda vs cpu")
    report["launches"] += launches
    report["cpu_vs_cuda"] = dict(problem=TWIN[0], instance=TWIN[1],
                                 lanes=TWIN[2],
                                 stats=gpu.stats._asdict(), cuda_ms=gpu_ms,
                                 cpu_ms=cpu_ms)


def phase_cell60(report, rounds_after_boot=4):
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
    report["launches"] += launches
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
                    "cell60 live masks", report)
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
    for _ in range(3):
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
              f"{busy[name]['count_stats_ms']:.2f} ms", flush=True)
    report["cell60_busy"] = busy
    return lanes


def device_busy(fn):
    """Wall time of ``fn()`` between two synchronizes, and the device time
    the profiler records inside it (kernels and copies on the card)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_ms, out = sync_ms(fn)
    device_us, ops, count_us = 0.0, 0, 0.0
    for evt in prof.key_averages():
        us = evt.self_device_time_total
        if us > 0:
            device_us += us
            ops += evt.count
            if "count_stats_kernel" in evt.key:
                count_us += us
    return dict(wall_ms=wall_ms, device_ms=device_us / 1e3,
                busy_share=device_us / 1e3 / wall_ms, device_ops=ops,
                count_stats_ms=count_us / 1e3, out=out)


# -- phase 5 ----------------------------------------------------------------

def kernel_times(table, mask, valid, clock_hz, sms, iters=200):
    """Kernel time (profiler device time and CUDA events), plain time and
    the bound for one input."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import bitset_ops, ref

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

    kernel = lambda: bitset_ops.count_stats(table, mask, valid)  # noqa: E731
    plain = lambda: ref.count_stats_ref(table, mask, valid)      # noqa: E731
    ev_ms = events_ms(kernel, iters)
    plain_ms = events_ms(plain, 20)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(50):
            kernel()
        torch.cuda.synchronize()
    prof_ms = None
    for evt in prof.key_averages():
        if "count_stats_kernel" in evt.key and evt.device_time_total:
            prof_ms = evt.device_time_total / evt.count / 1e3
    n, w = table.shape
    lanes = mask.shape[0]
    from repro_torch.kernels.ref import bit_set
    n_valid = int(bit_set(valid, n).sum())
    popcounts = n_valid * w
    ops_s = popcounts / (POPC_PER_CLOCK_PER_SM * sms * clock_hz)
    bytes_moved = 4 * (n * w + 2 * lanes * w + 4 * lanes)
    bytes_s = bytes_moved / HBM_BYTES_PER_S
    return dict(n=n, w=w, L=lanes, valid_pairs=n_valid,
                ms=prof_ms if prof_ms is not None else ev_ms,
                ms_source="profiler" if prof_ms is not None else "events",
                ms_events=ev_ms, ms_profiler=prof_ms, plain_ms=plain_ms,
                bound_ms=max(ops_s, bytes_s) * 1e3,
                bound_by="operations" if ops_s >= bytes_s else "bytes",
                popcounts=popcounts, bytes=bytes_moved)


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


# -- driver -----------------------------------------------------------------

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
    lib = _build.build("count_stats")
    print(f"phase 1: built {lib.name} in {time.perf_counter() - t0:.1f} s; "
          f"nvcc: {pathlib.Path(str(lib) + '.log').read_text().strip()}",
          flush=True)

    report = dict(device=kind, card=card, compared=0, mismatches=0,
                  max_abs_err=0, launches=0, solves=[])
    phase_parity(report)
    phase_drain(report)
    cell60_lanes = phase_cell60(report)
    full, live, small = phase_timing(cell60_lanes, report)
    kernels_line = {"kernels": [{
        "name": "count_stats", "route": "cuda", "source": SRC,
        "replaces": REPLACES, "launches": report["launches"],
        "max_abs_err": report["max_abs_err"], "ms": full["ms"],
        "plain_ms": full["plain_ms"], "bound_ms": full["bound_ms"],
        "bound_by": full["bound_by"], "library_ms": None,
        "library": "none: no single PyTorch call computes this function",
        "mismatches": report["mismatches"], "tolerance": "bitwise (0)",
        "shapes": [full, live, small]}]}
    report["seconds"] = time.perf_counter() - t_start
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    print(smi("name,power.limit"))
    print(json.dumps(kernels_line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

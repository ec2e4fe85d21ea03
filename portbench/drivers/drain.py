"""Instances drained to the proven optimum back to back through
``Solver.solve``: ramp-up from the root, steal and replay, and the drain
tail.

The mix fixes a pool of instances (``pool`` of them from generator seeds
``instance_seed(pool_base, i)``); ``--seed`` orders it.  Every run solves
the same work in another order, so that seeds do not change the work
(node counts differ by a factor of 30 between random instances of this
size).  The pool is solved cycle after cycle; the window closes at the
first cycle's end after ``--seconds``.  The window's solves run as a user
drains instances, with no ``on_event`` listener (a listener costs the
facade an incumbent readback a round); a solve that reaches the mix's
``max_rounds`` (ten times the pool's longest) is cut there and counts as
unfinished.  A traced run profiles the first ``profile_rounds`` rounds
of one more solve of the first instance (its ramp from the root) after
the window, under a listener that counts them.

Check: the reference solves each instance of the pool from the root and
must give each solve's counters (optimum, rounds, nodes, tasks received,
requests, donations); each payload must be a solution of its size.
"""

from __future__ import annotations

import time

from portbench import generate
from portbench.drivers import common
from portbench.reference import engine, problem_module
from portbench.reference.bits import num_words

COUNTERS = ("best", "rounds", "nodes", "t_s", "t_r", "donated")


class _Traced(Exception):
    """The traced rounds have run."""


def run(ctx) -> dict:
    import dataclasses

    from repro_torch.solver import Solver

    cfg, mix = ctx.config, ctx.mix
    lanes_n, steps = int(cfg["lanes"]), int(cfg["steps_per_round"])
    ref = problem_module(cfg["problem"])
    pool = [generate.graph(mix["graph"],
                           generate.instance_seed(int(mix["pool_base"]), i))
            for i in range(int(mix["pool"]))]
    order = [int(i) for i in generate.stream(ctx.seed, 0).permutation(
        len(pool))]
    handles = [common.handle(cfg["problem"], d, f"pool{i}")
               for i, d in enumerate(pool)]
    win = ctx.window()
    max_rounds = int(mix["max_rounds"])

    # Set-up: the first rounds of one solve load and warm every kernel.
    config = ctx.solver_config()
    Solver(dataclasses.replace(config, max_rounds=int(mix["warm_rounds"]))
           ).solve(handles[order[0]])
    solver = Solver(dataclasses.replace(config, max_rounds=max_rounds))
    records, unfinished = [], 0
    win.open()
    while unfinished == 0:
        for i in order:
            t = time.perf_counter()
            res = solver.solve(handles[i])
            if res.stats.rounds >= max_rounds:
                unfinished += 1
                break
            win.rounds += res.stats.rounds
            records.append(dict(instance=i, stats=res.stats._asdict(),
                                seconds=time.perf_counter() - t,
                                steps=int(res.lanes.steps),
                                payload=common.words(res.payload)))
        if win.expired():
            break
    win.close()
    if win.traced_rounds and not unfinished:
        def on_event(ev):
            if ev.kind == "round" and win.profile_tick():
                raise _Traced

        win.profile_start()
        try:
            Solver(config, on_event=on_event).solve(handles[order[0]])
        except _Traced:
            pass
        win.profile_stop()

    window = dict(seconds=win.elapsed_s, rounds=win.rounds,
                  nodes=sum(r["stats"]["nodes"] for r in records),
                  lane_steps=lanes_n * sum(r["steps"] for r in records))
    t_check = time.perf_counter()
    want = {}
    for i in sorted({r["instance"] for r in records}):
        want[i], _ = engine.solve(ref.NODE(pool[i]), lanes_n, steps)
    mism = sum(int(r["stats"][c] != want[r["instance"]][c])
               for r in records for c in COUNTERS)
    faults = sum(ref.payload_faults(pool[r["instance"]], r["payload"],
                                    r["stats"]["best"]) for r in records)
    checks = [("solve_mismatch", mism, 0), ("payload_faults", faults, 0),
              ("unfinished", unfinished, 0)]
    n = pool[0].shape[0]
    reading = dict(window=window, profile=win.profile, checks=checks,
                   attempted=len(records) + unfinished, failed=unfinished,
                   memory_peak_bytes=win.memory_peak_bytes,
                   notes=dict(solves=len(records), order=order,
                              optima=[r["stats"]["best"] for r in records],
                              solve_s=[r["seconds"] for r in records],
                              check_s=time.perf_counter() - t_check),
                   shape={"count_stats": (n, num_words(n), lanes_n)})
    if ctx.control:
        ctl = 0
        for i in want:
            got, lanes = engine.solve(ref.NODE(pool[i]), lanes_n, steps,
                                      slack=1)
            ctl += sum(int(got[c] != want[i][c]) for c in COUNTERS)
            ctl += ref.payload_faults(pool[i], lanes["best_payload"][0],
                                      got["best"])
        reading["control_checks"] = [("solve_mismatch", ctl, 0)]
    return reading

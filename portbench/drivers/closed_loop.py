"""A closed loop of clients on the multi-tenant service
(``Solver.serve`` -> ``SolverService.submit`` / ``step_round``).

Each client submits one instance and its next once the previous one
retires.  The mix fixes a pool of ``pool`` instances (instance i from
generator seed ``instance_seed(pool_base, i)``, its size ``n`` uniform in
``[n_min, n_max]``); ``--seed`` orders the pool, and request ``rid`` is
the ``rid % pool``-th instance of that order.  A window serves the pool
about twice, so every seed serves the same requests in another order:
drawn afresh per seed, the few hardest requests of a window, which set
its 95th percentile, changed it by a third from seed to seed.
``warm_rounds`` rounds run before the window; the window closes at the
first round's end after ``--seconds``.  A traced run profiles
``profile_rounds`` rounds right after it.  The requests still in flight
then run on, untimed, for at most ``late_s``; one that has not retired by
then never came.

Metrics: requests retired as solved in the window over its seconds;
the 95th percentile of submission to retirement over every request
retired in the window; submission to admission of those admitted in it.

Check: every request retired (in the window or after it) must be done,
with the optimum the reference's own serial solver finds for its
instance, and a payload that is a solution of that size.
"""

from __future__ import annotations

import time

from portbench import generate
from portbench.drivers import common
from portbench.reference import problem_module
from portbench.reference.bits import num_words


def pool_graph(mix: dict, i: int):
    """Instance ``i`` of the mix's pool."""
    s = generate.instance_seed(int(mix["pool_base"]), i)
    g = mix["graph"]
    n = int(g["n_min"]) + s % (int(g["n_max"]) - int(g["n_min"]) + 1)
    return generate.graph(g, s, n=n)


def run(ctx) -> dict:
    from repro_torch.service import SolveRequest
    from repro_torch.solver import Solver

    cfg, mix = ctx.config, ctx.mix
    ref = problem_module(cfg["problem"])
    clock = time.perf_counter
    submitted, admitted, retired = {}, {}, {}
    inflight = set()
    svc = Solver(ctx.solver_config()).serve(max_n=int(mix["max_n"]),
                                            slots=int(mix["slots"]))
    pool = [pool_graph(mix, i) for i in range(int(mix["pool"]))]
    order = [int(i) for i in generate.stream(ctx.seed, 0).permutation(
        len(pool))]
    instance = {}
    win = ctx.window()

    def submit() -> None:
        rid = len(submitted)
        instance[rid] = order[rid % len(order)]
        svc.submit(SolveRequest(
            rid=rid, graph=common.graph(pool[instance[rid]], f"r{rid}"),
            family=cfg["problem"]))
        submitted[rid] = clock()
        inflight.add(rid)

    def step(resubmit: bool) -> None:
        # Admission is the first thing a round does, retirement the last:
        # the tickets say which happened in it.
        began = clock()
        svc.step_round()
        ended = clock()
        for rid in sorted(inflight):
            ticket = svc.tickets[rid]
            if ticket.admitted_round is not None and rid not in admitted:
                admitted[rid] = began
            if ticket.done():
                retired[rid] = ended
                inflight.discard(rid)
                if resubmit:
                    submit()

    for _ in range(int(mix["clients"])):
        submit()
    for _ in range(int(mix["warm_rounds"])):
        step(True)
    lanes = svc.lanes
    nodes0, steps0 = int(lanes.nodes.sum()), int(lanes.steps)
    win.open()
    while True:
        step(True)
        win.tick()
        if win.expired():
            break
    win.close()
    t0, t1 = win.t_start, win.t_end
    lanes = svc.lanes
    nodes1, steps1 = int(lanes.nodes.sum()), int(lanes.steps)
    in_window = [r for r, t in retired.items() if t0 <= t <= t1]
    done = [r for r in in_window if svc.results[r].status == "done"]
    window = dict(
        seconds=win.elapsed_s, rounds=win.rounds, done=len(done),
        latencies=[retired[r] - submitted[r] for r in in_window],
        waits=[admitted[r] - submitted[r] for r, t in admitted.items()
               if t0 <= t <= t1],
        nodes=nodes1 - nodes0,
        lane_steps=int(cfg["lanes"]) * (steps1 - steps0))
    if win.traced_rounds:
        win.profile_start()
        while True:
            step(True)
            if win.profile_tick():
                break

    # The requests still in flight run on, untimed.
    late = clock() + float(mix["late_s"])
    while inflight and clock() < late:
        step(False)
    missing = len(submitted) - len(retired)
    results = {r: svc.results[r] for r in retired}
    del svc, lanes

    t_check = clock()
    optima = {i: ref.optimum(pool[i]) for i in sorted(set(instance.values()))}
    wrong = faults = 0
    for rid, res in sorted(results.items()):
        i = instance[rid]
        wrong += int(res.status != "done" or res.optimum != optima[i])
        faults += ref.payload_faults(pool[i], res.payload, res.optimum) \
            if res.status == "done" else 0
    checks = [("wrong_answers", wrong, 0), ("payload_faults", faults, 0),
              ("missing", missing, 0)]
    reading = dict(window=window, profile=win.profile, checks=checks,
                   attempted=len(in_window),
                   failed=len(in_window) - len(done),
                   memory_peak_bytes=win.memory_peak_bytes,
                   notes=dict(retired_in_window=len(in_window),
                              compared=len(results), submitted=len(submitted),
                              check_s=clock() - t_check),
                   shape={"stacked_count_stats": (
                       int(mix["slots"]), int(mix["max_n"]),
                       num_words(int(mix["max_n"])), int(cfg["lanes"]))})
    if ctx.control:
        proofless = {i: ref.optimum(pool[i], slack=1) for i in optima}
        ctl = sum(int(proofless[instance[r]] != optima[instance[r]])
                  for r in results)
        reading["control_checks"] = [("wrong_answers", ctl, 0)]
    return reading

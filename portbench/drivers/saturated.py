"""One hard instance searched at full lanes: the steady state of a long
solve.

Set-up runs ``Solver.solve``'s first rounds until every lane holds work
(or ``fill_max_rounds``), then ``settle_rounds`` more, past the first
rounds at full lanes that still visit more nodes than the steady state;
the window continues the same solve and is closed by the facade's own
``on_event`` "round" listener (the progress callback of a long solve; it
costs the facade one incumbent readback a round) once ``--seconds`` have
passed.  A traced run profiles the rounds right after the window.

Check: the reference follows three rounds of the program (PERF.md):
round 1 from its own root, one window round drawn from the seed and the
window's last round, each from the program's state before it, and must
give the program's state after it field for field; and the incumbent
must be a solution of the size reported.
"""

from __future__ import annotations

import time

from portbench import generate
from portbench.drivers import common
from portbench.lanes import to_numpy
from portbench.reference import engine, problem_module


class _Closed(Exception):
    """Raised by the listener to end the solve at the window's close."""


def run(ctx) -> dict:
    from repro_torch.solver import Solver

    cfg, mix = ctx.config, ctx.mix
    lanes_n, steps = int(cfg["lanes"]), int(cfg["steps_per_round"])
    dense = generate.graph(mix["graph"], generate.instance_seed(ctx.seed, 0))
    ref = problem_module(cfg["problem"])
    leaves = ref.NODE.leaves
    handle = common.handle(cfg["problem"], dense, f"seed{ctx.seed}")
    win = ctx.window()
    pick = generate.stream(ctx.seed, 1)
    held = {"first": None, "sample": None, "last": None}
    st = {"phase": "fill", "prev": None}

    def on_event(ev):
        if ev.kind == "done" and st["phase"] != "fill":
            if st["phase"] == "window":
                win.close()
            win.profile_stop()
            raise _Closed          # the tree ended
        if ev.kind != "round":
            return
        lanes = ev.lanes
        if ev.round == 1:
            held["first"] = lanes
        if st["phase"] == "fill":
            if "full_round" not in st and (
                    bool(lanes.active.all())
                    or ev.round >= int(mix["fill_max_rounds"])):
                st["full_round"] = ev.round
            if "full_round" in st and ev.round >= (
                    st["full_round"] + int(mix["settle_rounds"])):
                st.update(phase="window", prev=lanes,
                          busy_at_open=int(lanes.active.sum()),
                          nodes0=int(lanes.nodes.sum()),
                          steps0=int(lanes.steps))
                win.open()
            return
        if st["phase"] == "trace":
            if win.profile_tick():
                raise _Closed
            return
        pre, st["prev"] = st["prev"], lanes
        win.tick()
        if pick.random() * win.rounds < 1.0:        # reservoir of one
            held["sample"] = (pre, lanes)
        held["last"] = (pre, lanes)
        if win.expired():
            win.close()
            if not win.traced_rounds:
                raise _Closed
            st["phase"] = "trace"
            win.profile_start()

    solver = Solver(ctx.solver_config(), on_event=on_event)
    try:
        solver.solve(handle)
    except _Closed:
        pass
    if held["last"] is None:
        raise RuntimeError("the solve ended before its window opened")

    final = held["last"][1]
    nodes = int(final.nodes.sum()) - st["nodes0"]
    window = dict(seconds=win.elapsed_s, rounds=win.rounds, nodes=nodes,
                  lane_steps=lanes_n * (int(final.steps) - st["steps0"]))
    best = int(final.best.min())
    payload = common.words(final.best_payload[0])
    notes = dict(full_round=st["full_round"],
                 lanes_busy_at_open=st["busy_at_open"],
                 lanes_busy_at_close=int(final.active.sum()),
                 window_rounds=win.rounds, incumbent=best)
    first = to_numpy(held["first"], leaves)
    pairs = [tuple(to_numpy(x, leaves) for x in held[k])
             for k in ("sample", "last")]
    held.clear()
    st.clear()
    del final, solver

    t_check = time.perf_counter()
    node = ref.NODE(dense)
    start, _ = engine.round_(node, engine.init_lanes(node, lanes_n), steps)
    rounds = [(start, first)] + [(engine.round_(node, pre, steps)[0], post)
                                 for pre, post in pairs]
    mism = sum(sum(engine.mismatches(want, got).values())
               for want, got in rounds)
    checks = [("round_mismatch", mism, 0),
              ("payload_faults", ref.payload_faults(dense, payload, best), 0)]
    notes["check_s"] = time.perf_counter() - t_check
    reading = dict(window=window, profile=win.profile, checks=checks,
                   attempted=win.rounds, failed=0,
                   memory_peak_bytes=win.memory_peak_bytes, notes=notes,
                   shape={"count_stats": (dense.shape[0],
                                          node.payload_shape[0], lanes_n)})
    if ctx.control:
        # The reference with its proof dropped (slack 1) in the program's
        # place, judged by the same comparison.
        ctl = sum(sum(engine.mismatches(
            engine.round_(node, pre, steps)[0],
            engine.round_(node, pre, steps, slack=1)[0]).values())
            for pre, _ in pairs)
        reading["control_checks"] = [("round_mismatch", ctl, 0)]
    return reading

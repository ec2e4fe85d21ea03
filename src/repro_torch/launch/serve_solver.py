"""Multi-tenant solver service launcher of the port (counterpart of
``repro.launch.serve_solver``): many instances, one lane pool.

  PYTHONPATH=src python -m repro_torch.launch.serve_solver \\
      --instances vc:gnp:20:30:5@prio=2,ds:gnp:16:30:7@deadline=60 \\
      --lanes 32 --slots 4 [--scheduler sjf] [--device cpu] \\
      [--devices 4] [--max-ship 16] [--autoscale 8] \\
      [--ckpt svc.ckpt] [--ckpt-every 10] [--resume] \\
      [--trace svc.jsonl] [--metrics]

Each instance spec is ``<family>:<instance>[@<attr>=<v>...]`` where
``<family>`` is any *servable* registered problem family and
``<instance>`` uses that family's registered parser
(``gnp:<n>:<p*100>:<seed>``, ``reg:<n>:<k>:<seed>``, ``cell60``).
Lifecycle attributes ride after ``@``: ``prio=<int>`` (admission
priority), ``deadline=<rounds>`` (expire that many service rounds after
submission) and ``budget=<nodes>`` (evict after that many search nodes).
``--repeat R`` replays the whole mix R times with distinct request ids.

``--device`` takes the place of the reference's ``--backend``: ``cuda``
(the default; fails without a card) launches the CUDA kernels, ``cpu``
runs the plain PyTorch path.  The per-request lines and the final
``drained ... in R rounds`` line have the reference's format, and so have
``--trace`` (the JSONL trace ``tools/trace_report.py`` reads) and
``--metrics`` (the ``metrics:`` line).  ``--devices N`` shards the lane
pool over ``make_mesh(N, --device)`` (``--lanes`` is PER SHARD: the first
N cards, or N shards of the CPU) and ``--autoscale MAXDEV`` lets the
service grow and shrink its mesh with the admission queue depth.
"""

from __future__ import annotations

import argparse
import time

from repro_torch import registry
from repro_torch.core.api import resolve_device
from repro_torch.core.distributed import make_mesh
from repro_torch.service import (SCHEDULERS, AutoscalePolicy, SolveRequest,
                                 SolverService)
from repro_torch.solver import Solver, SolverConfig

_ATTRS = {"prio": "priority", "deadline": "deadline_rounds",
          "budget": "node_budget"}


def parse_workload(spec: str, repeat: int):
    """-> list of (family, instance, lifecycle-kwargs) over the mix."""
    out = []
    for item in spec.split(","):
        body, *attrs = item.split("@")
        family, _, inst = body.partition(":")
        if not inst:
            raise SystemExit(
                f"bad instance spec {item!r}: want <family>:<instance>")
        try:
            pspec = registry.get(family)
        except registry.UnknownProblemError as e:
            raise SystemExit(f"bad instance spec {item!r}: {e}")
        if not pspec.servable:
            raise SystemExit(
                f"bad instance spec {item!r}: family {family!r} is not "
                f"servable (no service packing registered)")
        kwargs = {}
        for attr in attrs:
            key, _, val = attr.partition("=")
            if key not in _ATTRS or not val:
                raise SystemExit(
                    f"bad instance spec {item!r}: want @<attr>=<int> with "
                    f"attr in {sorted(_ATTRS)}, got {attr!r}")
            try:
                kwargs[_ATTRS[key]] = int(val)
            except ValueError:
                raise SystemExit(
                    f"bad instance spec {item!r}: {attr!r} is not an int")
        try:
            out.append((family, pspec.parse(inst), kwargs))
        except ValueError as e:
            raise SystemExit(f"bad instance spec {item!r}: {e}")
    return out * repeat


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--instances",
                    default="vc:gnp:20:30:5,ds:gnp:16:30:7,vc:reg:24:4:1,"
                            "ds:gnp:14:25:2")
    ap.add_argument("--repeat", type=int, default=1)
    ap.add_argument("--lanes", type=int, default=32)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--scheduler", choices=sorted(SCHEDULERS), default=None,
                    help="admission policy (default: priority, or the "
                         "checkpointed policy with --resume)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the CUDA kernels) or cpu (plain PyTorch)")
    ap.add_argument("--steps-per-round", type=int, default=64)
    ap.add_argument("--devices", type=int, default=1,
                    help="shard the lane pool over N devices of --device "
                         "(--lanes is PER SHARD)")
    ap.add_argument("--max-ship", type=int, default=16,
                    help="cross-device tasks shipped per shard per round")
    ap.add_argument("--autoscale", type=int, default=0, metavar="MAXDEV",
                    help="grow/shrink the mesh elastically up to MAXDEV "
                         "shards, keyed on admission queue depth "
                         "(starts at --devices)")
    ap.add_argument("--ckpt", default=None,
                    help="service checkpoint path (written every "
                         "--ckpt-every rounds and after the drain)")
    ap.add_argument("--ckpt-every", type=int, default=10,
                    help="rounds between mid-run checkpoints (0 = final only)")
    ap.add_argument("--resume", action="store_true",
                    help="restore the service from --ckpt before serving")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write a JSONL service trace (repro_torch.obs "
                         "schema; summarize with tools/trace_report.py)")
    ap.add_argument("--metrics", action="store_true",
                    help="collect in-process metrics and print a summary")
    args = ap.parse_args()

    if args.resume and not args.ckpt:
        ap.error("--resume requires --ckpt")
    try:
        device_type = resolve_device(args.device).type
        mesh = (make_mesh(args.devices, device_type)
                if args.devices > 1 else None)
    except (ValueError, RuntimeError) as e:
        ap.error(str(e))
    autoscale = (AutoscalePolicy(max_devices=args.autoscale)
                 if args.autoscale > 1 else None)

    workload = parse_workload(args.instances, args.repeat)
    if args.resume:
        svc = SolverService.restore(args.ckpt, num_lanes=args.lanes,
                                    steps_per_round=args.steps_per_round,
                                    device=args.device,
                                    scheduler=args.scheduler,
                                    mesh=mesh, max_ship=args.max_ship,
                                    trace_path=args.trace,
                                    metrics=args.metrics)
        svc.autoscale = autoscale
        print(f"restored service: slots={svc.slot_rid} "
              f"queue={len(svc.queue)} pool={len(svc.pool)} "
              f"rounds={svc.rounds} scheduler={svc.sched.policy.name}")
        # The restored slots and queue finish under their checkpointed
        # rids; the --instances workload is submitted as NEW requests with
        # rids past everything the checkpoint issued.
        rid0 = 1 + max(list(svc.tickets)
                       + [r for r in svc.slot_rid if r >= 0] + [-1])
    else:
        max_n = max(registry.get(fam).size(g) for fam, g, _ in workload)
        config = SolverConfig(lanes=args.lanes,
                              steps_per_round=args.steps_per_round,
                              device=args.device,
                              scheduler=args.scheduler or "priority",
                              mesh=mesh, max_ship=args.max_ship,
                              autoscale=autoscale,
                              trace_path=args.trace, metrics=args.metrics)
        svc = Solver(config).serve(max_n=max_n, slots=args.slots)
        rid0 = 0
    reqs = [SolveRequest(rid=rid0 + i, graph=g, family=fam, **kwargs)
            for i, (fam, g, kwargs) in enumerate(workload)]
    for r in reqs:
        svc.submit(r)

    print(f"serving {len(reqs)} requests over {svc.num_lanes} lanes "
          f"({svc.n_devices} device(s) x {svc.lanes_per_device}) / "
          f"{svc.spec.k} slots (padded n={svc.spec.n}, "
          f"device={svc.device}, scheduler={svc.sched.policy.name})")
    t0 = time.time()
    while svc._has_work():
        svc.step_round()
        if (args.ckpt and args.ckpt_every
                and svc.rounds % args.ckpt_every == 0):
            svc.save(args.ckpt)
    wall = time.time() - t0
    svc.finalize_trace()          # manual step loop: write the summary row
    by_rid = {q.rid: q for q in reqs}
    # Report over tickets AND results (checkpoints without a ticket table
    # restore in-flight slots without tickets).
    served = sorted(set(svc.tickets) | set(svc.results))
    for rid in served:
        ticket = svc.tickets.get(rid)
        req = by_rid.get(rid)
        label = (f"{req.family}[{req.graph.name}]" if req is not None
                 else "(restored)")
        res = svc.results.get(rid)
        shown = ("cancelled" if res is None
                 else f"optimum={res.optimum}" if res.status == "done"
                 else f"{res.status} anytime={res.optimum}")
        span = (f"rounds={ticket.submitted_round}..{ticket.finished_round} "
                f"latency={ticket.finished_round - ticket.submitted_round}"
                if ticket is not None and ticket.finished_round is not None
                else f"rounds=..{res.retired_round}" if res is not None
                else "")
        print(f"  rid={rid:3d} {label} {shown} {span}")
    done = sum(1 for r in svc.results.values() if r.status == "done")
    print(f"drained {len(served)} requests ({done} exact) in "
          f"{svc.rounds} rounds, {wall:.2f}s -> "
          f"{done / max(wall, 1e-9):.2f} instances/s")
    if args.metrics:
        snap = svc.metrics()
        util = snap.value("lane_utilization")
        steals = snap.value("steal_received", scope="intra")
        print(f"metrics: nodes={snap.value('engine_nodes')} "
              f"dispatches={snap.value('engine_dispatches')} "
              f"util={util:.3f} steals intra={steals} "
              f"queue_depth={snap.value('service_queue_depth')}")
    if args.trace:
        print(f"trace -> {args.trace}")
    if args.ckpt:
        svc.save(args.ckpt)
        print(f"service checkpoint -> {args.ckpt}")


if __name__ == "__main__":
    main()

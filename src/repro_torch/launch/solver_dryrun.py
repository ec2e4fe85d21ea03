"""Dry run of the paper's own technique on the production mesh
(counterpart of ``repro.launch.solver_dryrun``).

Runs one distributed steal round (expand R nodes -> intra-device steal
-> cross-device steal -> incumbent min -> open-work sum) of a 512-vertex
Vertex Cover instance over ``launch.mesh.make_production_mesh``'s 256
(or 512) placeholder shards on ``meta`` under ``roofline.analyze``, the
LM cells' counter.  Nothing is allocated and nothing needs a card.

It puts the paper's central claim in numbers at pod scale: tasks are
O(d) index vectors, so the bytes a shard sends in a round (the task rows
and counts of the cross-device steal, the incumbent and the open work)
are tiny against the round's compute and memory terms.

The expand phase is a Python loop of ``steps_per_round`` engine steps,
each dispatching the same operations on the same shapes (no shape
depends on the data), and a meta operation costs the host about 0.2 ms:
256 shards x 256 steps would be millions of them.  So the round is
traced with one step, and one more engine step of one shard is traced
alone; the round's counts are the first plus ``steps_per_round - 1``
times the shards times the second, exactly those of a trace of every
step (``tests/test_torch_dryrun.py`` holds the two equal).  What remains
is each shard's replay of its received tasks, one ``apply`` per index
position (512 at n = 512): about 8 s of host time a shard.

Per-device figures are those of a shard on a card of its own: a
placeholder shard replays its received tasks alone
(``core.distributed.Mesh.groups``), so every shard runs the same
operations on the same shapes, and each figure is the round's total
over the shards divided by their number.  (Shard 0 also runs the quota
arithmetic, which the reference runs on every device.)  The memory
figure is the round's live peak over all shards, shared evenly.

  PYTHONPATH=src python -m repro_torch.launch.solver_dryrun [--multi-pod]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Any, Dict, Optional

from repro_torch import registry, roofline
from repro_torch.core.distributed import (Mesh, ShardedLanes,
                                          _shard_lanes,
                                          make_distributed_round)
from repro_torch.core.engine import init_lanes, make_expand
from repro_torch.launch.dryrun import ARTIFACT_DIR
from repro_torch.launch.mesh import (HBM_BW, LINK_BW, PEAK_FLOPS_BF16,
                                     make_production_mesh)


#: Task rows a shard ships a round at most (the reference's ``max_ship``).
MAX_SHIP = 16


def run(multi_pod: bool = False, lanes_per_device: int = 8,
        steps_per_round: int = 256, problem: str = "vc",
        instance: str = "reg:512:4:1", mesh: Optional[Mesh] = None,
        tag: str = "") -> Dict[str, Any]:
    """One distributed round of any registered problem family over the
    production mesh (or ``mesh``) on its devices: its JSON, also written
    to ``dryrun_out/solver__round__<sp|mp>[__tag].json``."""
    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    n_dev = mesh.size
    spec = registry.get(problem)
    g = spec.parse(instance)
    prob = spec.build(g, device=mesh.device_type)

    fn = make_distributed_round(prob, mesh, 1, max_ship=MAX_SHIP)
    lanes = _shard_lanes(init_lanes(prob, lanes_per_device * n_dev,
                                    seed_root=False), mesh)

    def round_of(shards):
        out, open_work = fn(ShardedLanes(shards))
        return out.shards, open_work

    t0 = time.perf_counter()
    one, mem, _ = roofline.analyze(round_of, lanes.shards)
    step, _, _ = roofline.analyze(make_expand(prob, 1), lanes.shards[0])
    trace_s = time.perf_counter() - t0
    counts = _linear(one, step, lambda r, s: r + (steps_per_round - 1)
                     * n_dev * s)
    per = _linear(counts, counts, lambda x, _: x / n_dev)
    terms = per.terms(PEAK_FLOPS_BF16, HBM_BW, LINK_BW)
    out = {
        "mesh": f"{n_dev} x {mesh.device_type}",
        "devices": n_dev,
        "lanes_total": lanes_per_device * n_dev,
        "steps_per_round": steps_per_round,
        "max_ship": MAX_SHIP,
        "problem": problem,
        "instance": spec.label(g),
        "trace_s": trace_s,
        "peak_bytes": mem.peak_bytes // n_dev,
        "collective_bytes_per_round_per_dev": per.collective_bytes,
        "collective_bytes_per_round": counts.collective_bytes,
        "per_collective": per.per_collective,
        "hbm_bytes_per_dev": per.hbm_bytes,
        "flops_per_dev": per.flops,
        "kernel_launches_per_dev": per.kernels,
        "compute_s": terms["compute_s"],
        "memory_s": terms["memory_s"],
        "collective_s": terms["collective_s"],
    }
    ARTIFACT_DIR.mkdir(parents=True, exist_ok=True)
    suffix = f"__{tag}" if tag else ""
    path = ARTIFACT_DIR / (f"solver__round__{'mp' if multi_pod else 'sp'}"
                           f"{suffix}.json")
    path.write_text(json.dumps(out, indent=1))
    return out


def _linear(a: roofline.RooflineCounts, b: roofline.RooflineCounts,
            f) -> roofline.RooflineCounts:
    """``f(a.x, b.x)`` for every count x of two rounds' counts (each
    key of a dict of counts)."""
    out = {}
    for field in dataclasses.fields(a):
        x, y = getattr(a, field.name), getattr(b, field.name)
        out[field.name] = ({k: f(x.get(k, 0), y.get(k, 0))
                            for k in sorted(x.keys() | y.keys())}
                           if isinstance(x, dict) else f(x, y))
    return roofline.RooflineCounts(**out)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both", action="store_true")
    ap.add_argument("--problem", default="vc",
                    help="registered problem family (repro_torch.registry)")
    ap.add_argument("--instance", default="reg:512:4:1")
    args = ap.parse_args(argv)
    for mp in ([False, True] if args.both else [args.multi_pod]):
        print(json.dumps(run(mp, problem=args.problem,
                             instance=args.instance), indent=1), flush=True)


if __name__ == "__main__":
    main()

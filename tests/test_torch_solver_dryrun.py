"""The solver's dry run (``repro_torch.launch.solver_dryrun``): one
distributed round over placeholder shards on ``meta``.

Over 8 placeholder shards with ``vc reg:64:4:1``, 8 lanes a shard and 16
steps a round: the run writes the reference's keys; the bytes a shard
sends a round equal the hand count (an all-gather of its [K, 2] counts
and of its ``min(W, max_ship)`` task rows of ``IDX_LEN + 4`` int32, an
all-reduce of the incumbent and of the open work, [K] int32 each); the
counts extrapolated from a one-step round and one shard's step equal a
trace of every step; the same round on an 8-shard CPU mesh sends the
same bytes (its HBM bytes differ: CPU tensors run the kernels' plain
versions).
"""

import json

import pytest
import torch

from repro_torch import registry, roofline
from repro_torch.core.distributed import (Mesh, ShardedLanes, _shard_lanes,
                                          make_distributed_round,
                                          make_mesh)
from repro_torch.core.engine import idx_len, init_lanes
from repro_torch.launch import mesh as pmesh
from repro_torch.launch import solver_dryrun

SHARDS, LANES, STEPS = 8, 8, 16
MAX_SHIP = solver_dryrun.MAX_SHIP
INSTANCE = "reg:64:4:1"


def traced_round(device, steps=STEPS):
    """``analyze`` of one round of every step over 8 shards of
    ``device``."""
    mesh = make_mesh(SHARDS, device)
    spec = registry.get("vc")
    prob = spec.build(spec.parse(INSTANCE), device=device)
    fn = make_distributed_round(prob, mesh, steps, max_ship=MAX_SHIP)
    lanes = _shard_lanes(init_lanes(prob, LANES * SHARDS, seed_root=False),
                         mesh)
    counts, mem, _ = roofline.analyze(
        lambda shards: fn(ShardedLanes(shards))[0].shards, lanes.shards)
    return counts, mem, prob


@pytest.fixture(scope="module")
def dry():
    res = solver_dryrun.run(mesh=Mesh(["meta"] * SHARDS),
                            lanes_per_device=LANES, steps_per_round=STEPS,
                            instance=INSTANCE, tag="test")
    path = solver_dryrun.ARTIFACT_DIR / "solver__round__sp__test.json"
    assert json.loads(path.read_text()) == json.loads(json.dumps(res))
    path.unlink()
    return res


@pytest.fixture(scope="module")
def full():
    return traced_round("meta")


def test_keys(dry):
    for key in ("mesh", "devices", "lanes_total", "steps_per_round",
                "problem", "instance", "peak_bytes",
                "collective_bytes_per_round_per_dev", "per_collective",
                "hbm_bytes_per_dev", "compute_s", "memory_s",
                "collective_s"):
        assert key in dry, key
    assert dry["devices"] == SHARDS and dry["lanes_total"] == 64
    assert dry["mesh"] == "8 x meta"
    assert dry["kernel_launches_per_dev"]["count_stats"] > STEPS
    assert dry["collective_s"] == (dry["collective_bytes_per_round_per_dev"]
                                   / pmesh.LINK_BW)


def test_collective_bytes_hand_count(dry, full):
    prob = full[2]
    k = prob.num_instances
    rows = min(LANES, MAX_SHIP)
    gather = 4 * (2 * k + rows * (idx_len(prob) + 4))
    reduce = 4 * (k + k)
    assert dry["per_collective"] == {"all-gather": gather,
                                     "all-reduce": reduce}
    assert dry["collective_bytes_per_round_per_dev"] == gather + reduce
    assert dry["collective_bytes_per_round"] == SHARDS * (gather + reduce)


def test_extrapolation_equals_full_trace(dry, full):
    counts, mem, _ = full
    assert dry["hbm_bytes_per_dev"] == counts.hbm_bytes / SHARDS
    assert dry["kernel_launches_per_dev"] == {
        k: v / SHARDS for k, v in counts.kernels.items()}
    assert dry["collective_bytes_per_round"] == counts.collective_bytes
    assert dry["peak_bytes"] == mem.peak_bytes // SHARDS


def test_cpu_mesh_sends_the_same_bytes(full):
    counts, _, _ = traced_round("cpu", steps=1)
    assert counts.collective_bytes == full[0].collective_bytes
    assert counts.per_collective == full[0].per_collective
    assert counts.kernels == {}          # the plain versions ran


def test_production_mesh_is_placeholders():
    mesh = pmesh.make_production_mesh()
    assert mesh.size == 256 and mesh.device_type == "meta"
    assert pmesh.make_production_mesh(multi_pod=True).size == 512
    assert mesh.groups() == tuple((d,) for d in range(256))
    cpu = Mesh(["cpu"] * 4)
    assert cpu.groups() == ((0, 1, 2, 3),)
    assert torch.device("meta") in mesh.distinct()

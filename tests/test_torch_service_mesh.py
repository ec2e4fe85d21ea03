"""The port's sharded, elastic service.

* Its round on 8 CPU shards against the reference's sharded service round,
  bitwise: ``make_round`` over the stacked problem under ``shard_map``,
  built by hand as ``tests/test_service.py`` builds the cross-device steal
  (the reference's ``SolverService(mesh=...)`` fails at its first
  admission on this JAX: its stack rebuild vmaps over lanes that are
  already sharded).  The reference runs once, in a module-scoped
  subprocess with 8 forced host devices.
* The driver: a one-shard mesh is the unsharded service bitwise; on 4
  shards every result is ``serial_rb``'s; ``resize`` 1 -> 2 -> 4 -> 2
  mid-drain keeps every ticket; save/restore across shard counts; node
  budgets count across shards; ``AutoscalePolicy.decide`` decides as the
  reference's and ``maybe_autoscale`` grows and shrinks a CPU mesh.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.service.scheduler import AutoscalePolicy as JAutoscale
from repro_torch import registry
from repro_torch.core import distributed as dist
from repro_torch.core.api import tree_leaves
from repro_torch.core.engine import init_lanes
from repro_torch.core.serial import serial_rb
from repro_torch.obs.trace import read_trace
from repro_torch.problems.graphs import parse_graph_instance
from repro_torch.service import (AutoscalePolicy, SolveRequest,
                                 SolverService, StackedTables)
from repro_torch.solver import Solver, SolverConfig
from test_torch_distributed import (assert_leaves_equal, from_leaves,
                                    ref_leaves)

_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from repro import compat, registry
from repro.core import distributed as dist
from repro.core.checkpoint import rebuild_stacks
from repro.core.engine import init_lanes
from repro.problems.graphs import parse_graph_instance
from repro.service.batch_problem import StackedSpec, StackedTables

out_dir, steps, rounds = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
assert len(jax.devices()) == 8, jax.devices()
mesh = jax.make_mesh((8,), ("workers",))
arrays = {}


def put(prefix, tree):
    for j, leaf in enumerate(jax.tree_util.tree_leaves(tree)):
        arrays[f"{prefix}/{j}"] = np.asarray(leaf)


SLOTS = [("vc", "gnp:20:30:5"), ("ds", "gnp:16:30:7"), ("vc", "reg:18:3:2")]
spec = StackedSpec(n=20, k=3)
tables = spec.empty_tables()
for slot, (family, inst) in enumerate(SLOTS):
    tables.adj[slot], tables.fullm[slot], tables.family[slot] = \
        registry.get(family).pack(parse_graph_instance(inst), 20)
put("tables", tables)
tables = StackedTables(*(jnp.asarray(t) for t in tables))
prob = spec.bind(tables)

# The service's placement: a root per slot on lanes 0, 5 and 10, every
# other lane idle and bound round-robin to the live slots.
W = 16
lanes = init_lanes(prob, W, seed_root=False, bind_instance=False)
inst = np.arange(W, dtype=np.int32) % 3
active = np.zeros(W, bool)
t_s = np.zeros(W, np.int32)
for slot, lane in enumerate((0, 5, 10)):
    inst[lane], active[lane], t_s[lane] = slot, True, 1
lanes = rebuild_stacks(prob, lanes._replace(
    inst=jnp.asarray(inst), active=jnp.asarray(active),
    t_s=jnp.asarray(t_s)))
put("in", lanes)

for max_ship in (16, 1):
    def round_fn(lanes, tables):
        return dist.make_round(spec.bind(tables), steps, ("workers",),
                               max_ship)(lanes)

    lane_specs = dist.lane_partition_specs(prob, ("workers",))
    fn = jax.jit(compat.shard_map(
        round_fn, mesh=mesh, in_specs=(lane_specs, StackedTables(P(), P(),
                                                                 P())),
        out_specs=(lane_specs, P()), check=False))
    cur = dist._shard_lanes(lanes, mesh)
    for r in range(rounds):
        cur, open_work = fn(cur, tables)
        put(f"ship{max_ship}/round{r}", cur)
        arrays[f"ship{max_ship}/open{r}"] = np.asarray(open_work)
np.savez(os.path.join(out_dir, "ref.npz"), **arrays)
print("RESULT ok")
"""

STEPS, ROUNDS = 6, 5
CPU8 = dist.Mesh(["cpu"] * 8)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("svc_mesh_ref")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(os.path.dirname(__file__), "..", "src")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", _SCRIPT, str(out),
                           str(STEPS), str(ROUNDS)], env=env,
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(out / "ref.npz") as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("max_ship", [16, 1])
def test_sharded_service_round_equals_reference(ref, max_ship):
    """The port's service on 8 CPU shards, loaded with the reference's
    tables and lanes, runs its own round ``ROUNDS`` times: lanes and
    open-work vectors equal the reference's ``shard_map`` round's."""
    svc = Solver(SolverConfig(lanes=2, steps_per_round=STEPS, device="cpu",
                              mesh=CPU8, max_ship=max_ship)).serve(
        max_n=20, slots=3)
    adj, fullm, family = ref_leaves(ref, "tables")
    svc.tables = StackedTables(adj=adj.copy(), fullm=fullm.copy(),
                               family=family.copy())
    svc._write_tables()
    svc._set_lanes(from_leaves(init_lanes(svc.problem, 16),
                               ref_leaves(ref, "in")))
    crossed = 0
    for r in range(ROUNDS):
        svc.lanes, open_work = svc._round(svc.lanes)
        assert_leaves_equal(svc.lanes.gather(),
                            ref_leaves(ref, f"ship{max_ship}/round{r}"),
                            f"round {r}")
        np.testing.assert_array_equal(open_work.numpy(),
                                      ref[f"ship{max_ship}/open{r}"])
        crossed = int(svc.lanes.t_c.sum())
    assert crossed > 0


# -- the driver -------------------------------------------------------------

MIX = [("vc", "gnp:20:30:5", {}),
       ("ds", "gnp:16:30:7", {}),
       ("vc", "reg:18:3:2", {"priority": 3}),
       ("ds", "gnp:18:25:4", {"node_budget": 40}),        # budget evicts
       ("vc", "gnp:16:35:9", {}),
       ("ds", "gnp:14:25:2", {})]


def optimum(family, spec):
    return serial_rb(registry.problem(family, spec).oracle())[0]


def service(mesh, lanes=4, **cfg):
    return Solver(SolverConfig(lanes=lanes, steps_per_round=6,
                               device="cpu", mesh=mesh, **cfg)).serve(
        max_n=20, slots=3)


def submit(svc):
    return [svc.submit(SolveRequest(rid=i, graph=parse_graph_instance(s),
                                    family=f, **kw))
            for i, (f, s, kw) in enumerate(MIX)]


def check_results(svc):
    status = {r.rid: r.status for r in svc.results.values()
              if r.rid < len(MIX)}
    assert status == {0: "done", 1: "done", 2: "done", 3: "expired",
                      4: "done", 5: "done"}
    for rid, (family, spec, _) in enumerate(MIX):
        got = svc.results[rid].optimum
        want = optimum(family, spec)
        assert got == want if status[rid] == "done" else got >= want
    assert svc.tickets[3].nodes_used >= 40


def test_one_shard_mesh_service_equals_unsharded():
    a, b = service(dist.make_mesh(1, "cpu"), lanes=8), service(None, lanes=8)
    submit(a), submit(b)
    while b._has_work():
        np.testing.assert_array_equal(a.step_round(), b.step_round())
        for x, y in zip(tree_leaves(a.lanes.gather()), tree_leaves(b.lanes)):
            assert torch.equal(x, y)
        assert (a.slot_rid, a.rounds) == (b.slot_rid, b.rounds)
    assert not a._has_work()
    assert {r: v.optimum for r, v in a.results.items()} == {
        r: v.optimum for r, v in b.results.items()}
    check_results(a)


def test_four_shards_drain_to_the_serial_optima(tmp_path):
    """On 4 CPU shards every request gets ``serial_rb``'s optimum, the
    budget request is evicted on the nodes counted over all shards, and
    the trace's per-device records split each round's nodes."""
    path = tmp_path / "s.jsonl"
    svc = service(dist.make_mesh(4, "cpu"), trace_path=str(path))
    submit(svc)
    svc.drain()
    check_results(svc)
    assert int(svc.lanes.t_c.sum()) > 0
    recs = read_trace(str(path))
    assert recs[0]["devices"] == 4
    rounds = [r for r in recs if r["t"] == "round"]
    assert rounds and all(sum(r["dev_nodes"]) == r["nodes"] and
                          len(r["dev_active"]) == 4 for r in rounds)
    summary = recs[-1]
    assert summary["nodes"] == sum(summary["lane_nodes"]) == int(
        svc.lanes.nodes.sum())


def test_resize_mid_drain_keeps_every_ticket(tmp_path):
    """``resize`` 1 -> 2 -> 4 -> 2 shards (and a new lane count) between
    rounds: tickets stay live, every result is the serial optimum, the
    collector's ledger stays exact and each resize is traced and emitted
    with the reference's reason text."""
    path = tmp_path / "r.jsonl"
    events = []
    svc = service(None, trace_path=str(path))
    svc.on_event = events.append
    tickets = submit(svc)
    plan = {2: (2, None), 4: (4, 3), 6: (2, None)}
    while svc._has_work():
        if svc.rounds in plan:
            n, lanes = plan.pop(svc.rounds)
            svc.resize(mesh=dist.make_mesh(n, "cpu"), num_lanes=lanes)
            assert svc.n_devices == n
        svc.step_round()
    svc.finalize_trace()
    assert not plan
    assert all(t.done() for t in tickets)
    check_results(svc)
    reasons = [e.reason for e in events if e.kind == "resize"]
    assert reasons == ["devices 1->2, lanes 4->8",
                       "devices 2->4, lanes 8->12",
                       "devices 4->2, lanes 12->6"]
    recs = read_trace(str(path))
    assert [(r["devices"], r["lanes"]) for r in recs
            if r["t"] == "resize"] == [(2, 8), (4, 12), (2, 6)]
    summary = recs[-1]
    assert summary["nodes"] == sum(summary["lane_nodes"]) == int(
        svc.lanes.nodes.sum())
    with pytest.raises(ValueError):
        svc.resize(num_lanes=0)


@pytest.mark.parametrize("restore_on", [2, 1])
def test_save_restore_across_shard_counts(tmp_path, restore_on):
    """A service saved mid-drain on 4 shards restores onto 2 shards or one
    device, and drains to the same results."""
    svc = service(dist.make_mesh(4, "cpu"))
    submit(svc)
    for _ in range(3):
        svc.step_round()
    path = str(tmp_path / "svc.ckpt")
    svc.save(path)
    mesh = dist.make_mesh(restore_on, "cpu") if restore_on > 1 else None
    back = SolverService.restore(path, num_lanes=4, steps_per_round=6,
                                 device="cpu", mesh=mesh)
    assert back.n_devices == restore_on and back.rounds == 3
    assert back.slot_rid == svc.slot_rid
    back.drain()
    check_results(back)


def test_autoscale_decides_as_the_reference():
    """The same policy fed the same table of (queue depth, devices, round,
    busy) decides as the reference's, cooldown state included."""
    rng = np.random.RandomState(3)
    for policy in (dict(), dict(grow_at=1, max_devices=8, cooldown_rounds=2),
                   dict(shrink_below=2, min_devices=2, max_devices=4,
                        cooldown_rounds=0)):
        ours, theirs = AutoscalePolicy(**policy), JAutoscale(**policy)
        for now in range(60):
            kw = dict(queue_depth=int(rng.randint(0, 5)),
                      devices=int(rng.choice([1, 2, 4, 8])), now_round=now,
                      busy=bool(rng.rand() < 0.5))
            assert ours.decide(**kw) == theirs.decide(**kw), (policy, kw)


def test_maybe_autoscale_grows_and_shrinks_a_cpu_mesh():
    """Queue depth >= 2 grows the CPU mesh (1 -> 2 -> 4, capped at
    ``max_devices``); an idle service shrinks it again."""
    svc = service(None, autoscale=AutoscalePolicy(max_devices=4,
                                                  cooldown_rounds=1))
    sizes = []
    submit(svc)
    svc.submit(SolveRequest(rid=6, graph=parse_graph_instance("gnp:12:30:1"),
                            family="vc"))
    while svc._has_work():
        svc.step_round()
        sizes.append(svc.n_devices)
    for _ in range(4):                      # idle rounds: shrink
        svc.step_round()
        sizes.append(svc.n_devices)
    assert max(sizes) == 4 and sizes[-1] == 1
    assert sizes[:2] == [2, 4]
    check_results(svc)
    assert svc.results[6].optimum == optimum("vc", "gnp:12:30:1")
    assert dist.available_devices("cpu", 3) == [torch.device("cpu")] * 3

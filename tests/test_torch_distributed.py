"""The port's mesh (``repro_torch.core.distributed``) against the JAX
reference's, bitwise.

The reference runs once, in a module-scoped subprocess with 8 forced host
devices (jax fixes its device count at first use; the rest of the suite
sees one device), and writes its arrays to a ``.npz``:

* sharded solves on its 2x4 and flat-8 meshes (vc, ds and ss), the
  gathered ``Lanes`` after every round, the final lanes, ``SolveStats``
  and payload; the port solves on 8 CPU shards and must match each;
* a traced sharded solve: the port's trace equals it record for record
  (less ``meta.backend`` and ``meta.config``);
* an 8-shard checkpoint resumed onto 4 shards and onto one device, from
  either package's file;
* its ``cross_device_steal`` under ``shard_map`` on the cases of
  ``tests/test_service.py`` (instance scoping, budget starvation at
  ``max_ship=1``) and ``tests/test_steal_quota.py`` (the quota matrix),
  and ``extract_tasks`` / ``claim_tasks`` on random inputs.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import registry
from repro_torch.convert import tensor
from repro_torch.core import distributed as dist
from repro_torch.core import steal
from repro_torch.core.api import BinaryProblem, NodeEval, tree_leaves, tree_map
from repro_torch.core.engine import init_lanes
from repro_torch.service.batch_problem import StackedSpec
from repro_torch.solver import ConfigError, Solver, SolverConfig
from test_torch_obs import records

_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json
import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from repro import compat, registry
from repro.core import distributed as dist
from repro.core import steal
from repro.core.api import BinaryProblem
from repro.core.checkpoint import rebuild_stacks
from repro.core.engine import Lanes, init_lanes
from repro.problems import gnp_graph
from repro.service.batch_problem import StackedSpec, pack_instance
from repro.solver import Solver, SolverConfig

out_dir = sys.argv[1]
assert len(jax.devices()) == 8, jax.devices()
arrays, meta = {}, {}


def put(prefix, tree):
    for j, leaf in enumerate(jax.tree_util.tree_leaves(tree)):
        arrays[f"{prefix}/{j}"] = np.asarray(leaf)


MESHES = {"2x4": jax.make_mesh((2, 4), ("data", "model")),
          "8": jax.make_mesh((8,), ("workers",)),
          "4": jax.make_mesh((4,), ("workers",), devices=jax.devices()[:4]),
          "1": None}


def solve(case, family, spec, mesh, **cfg):
    rounds = []

    def on_event(ev):
        if ev.kind == "round":
            put(f"{case}/round{ev.round}", ev.lanes)
            rounds.append(ev.round)

    res = Solver(SolverConfig(mesh=MESHES[mesh], **cfg),
                 on_event=on_event).solve(registry.problem(family, spec))
    put(f"{case}/final", res.lanes)
    put(f"{case}/payload", res.payload)
    meta[case] = {"stats": list(res.stats), "rounds": rounds}


BOOT = dict(bootstrap_rounds=3, bootstrap_steps=4)
solve("vc_2x4", "vc", "gnp:16:35:5", "2x4", lanes=4, steps_per_round=32,
      trace_path=os.path.join(out_dir, "vc_2x4.jsonl"), metrics=True, **BOOT)
solve("vc_8", "vc", "gnp:16:35:5", "8", lanes=4, steps_per_round=32, **BOOT)
solve("ds_2x4", "ds", "gnp:12:30:9", "2x4", lanes=2, steps_per_round=32)
solve("ss_8", "ss", "ss:16:3", "8", lanes=2, steps_per_round=16)
CKPT = os.path.join(out_dir, "ref.ckpt")
solve("ckpt_8", "vc", "gnp:40:20:3", "8", lanes=4, steps_per_round=16,
      max_rounds=4, checkpoint_every=2, checkpoint_path=CKPT, **BOOT)
solve("resume_4", "vc", "gnp:40:20:3", "4", lanes=4, steps_per_round=16,
      resume_from=CKPT)
solve("resume_1", "vc", "gnp:40:20:3", "1", lanes=16, steps_per_round=16,
      resume_from=CKPT)


def steal_fn(prob, max_ship):
    def f(lanes):
        return dist.cross_device_steal(prob, lanes, ("workers",), max_ship)

    specs = dist.lane_partition_specs(prob, ("workers",))
    return jax.jit(compat.shard_map(f, mesh=MESHES["8"], in_specs=(specs,),
                                    out_specs=specs, check=False))


def steal_case(case, prob, fn, w, idx, depth, active, inst):
    lanes = init_lanes(prob, 8 * w, seed_root=False)
    lanes = lanes._replace(idx=jnp.asarray(idx), depth=jnp.asarray(depth),
                           active=jnp.asarray(active),
                           inst=jnp.asarray(inst))
    lanes = rebuild_stacks(prob, lanes)
    put(f"{case}/in", lanes)
    put(f"{case}/out", fn(dist._shard_lanes(lanes, MESHES["8"])))


# The instance-scoping cases of tests/test_service.py (K = 2 stacked).
spec = StackedSpec(n=12, k=2)
tables = spec.empty_tables()
for slot, g in enumerate([gnp_graph(12, 0.4, seed=1),
                          gnp_graph(10, 0.4, seed=2)]):
    tables.adj[slot], tables.fullm[slot], tables.family[slot] = \
        pack_instance(g, 0, 12)
prob = spec.bind(type(tables)(*(jnp.asarray(t) for t in tables)))
arrays["stacked/adj"], arrays["stacked/fullm"] = tables.adj, tables.fullm
arrays["stacked/family"] = tables.family
W = 2
for case, max_ship, donors, thieves in (
        ("scoped", 16, ((0, 0), (1, 0)), ((4, 1), (6, 1), (10, 0))),
        ("starve", 1, ((0, 0), (1, 1)), ((4, 1), (5, 1)))):
    idx = np.asarray(init_lanes(prob, 8 * W, seed_root=False).idx).copy()
    inst = np.full(8 * W, -1, np.int32)
    active = np.zeros(8 * W, bool)
    depth = np.zeros(8 * W, np.int32)
    for lane, i in donors:                 # donors with open LEFTs
        idx[lane, :4] = 0
        depth[lane], active[lane], inst[lane] = 4, True, i
    for lane, i in thieves:
        inst[lane] = i
    steal_case(case, prob, steal_fn(prob, max_ship), W, idx, depth, active,
               inst)


# The quota matrix of tests/test_steal_quota.py (a full binary tree).
DEPTH = 12


def full_tree(depth):
    return BinaryProblem.from_callbacks(
        name="full", max_depth=depth,
        root=lambda: (jnp.int32(0), jnp.int32(0)),
        apply=lambda s, b: (s[0] + 1, s[1] * 2 + b.astype(jnp.int32)),
        leaf_value=lambda s: (s[0] == depth, s[1] + 1),
        lower_bound=lambda s: jnp.int32(0),
        solution_payload=lambda s: s[1], payload_zero=lambda: jnp.int32(0))


tree = full_tree(DEPTH)
tree_steal = steal_fn(tree, 16)
W = 4
for case, donor_lanes, idle_lanes in (
        ("scattered", {0, 1, 2, 3}, {5, 6, 8, 10, 11}),
        ("surplus", {0, 1, 2, 3}, {5}),
        ("two_donors", {0, 1, 16, 17}, {6, 9, 11, 26}),
        ("no_demand", {0, 1}, set())):
    il = DEPTH + 1
    idx = np.full((8 * W, il), -2, np.int8)
    depth = np.zeros(8 * W, np.int32)
    active = np.zeros(8 * W, bool)
    for k in range(8 * W):
        if k in idle_lanes:
            continue
        active[k] = True
        if k in donor_lanes:
            idx[k, :k % W] = 1
            idx[k, k % W:6] = 0
            depth[k] = 6
        else:
            idx[k, 0] = 1
            depth[k] = 1
    steal_case(case, tree, tree_steal, W, idx, depth, active,
               np.zeros(8 * W, np.int32))

# extract_tasks and claim_tasks on random lane states.
rng = np.random.RandomState(7)
lanes0 = init_lanes(prob, 24, seed_root=False)
il = lanes0.idx.shape[1]
for t in range(2):
    depth = rng.randint(0, il, 24).astype(np.int32)
    base = np.minimum(rng.randint(0, 4, 24), depth).astype(np.int32)
    idx = rng.choice([-1, 0, 0, 1], size=(24, il)).astype(np.int8)
    idx[np.arange(il)[None, :] >= depth[:, None]] = -2
    lanes = lanes0._replace(
        idx=jnp.asarray(idx), depth=jnp.asarray(depth),
        base=jnp.asarray(base), active=jnp.asarray(rng.rand(24) < 0.7),
        inst=jnp.asarray(rng.randint(-1, 2, 24).astype(np.int32)))
    quota = rng.randint(0, 6, 2).astype(np.int32)
    max_tasks = (3, 40)[t]
    put(f"extract{t}/in", lanes)
    arrays[f"extract{t}/quota"] = quota
    arrays[f"extract{t}/max_tasks"] = np.int32(max_tasks)
    put(f"extract{t}/out", steal.extract_tasks(lanes, jnp.asarray(quota),
                                               max_tasks))
    rows = 40
    claim_in = (rng.rand(24) < 0.5, rng.randint(0, 2, 24).astype(np.int32),
                rng.randint(0, 8, 24).astype(np.int32),
                rng.randint(0, 2, rows).astype(np.int32),
                rng.randint(0, 8, rows).astype(np.int32),
                rng.rand(rows) < 0.6)
    put(f"claim{t}/in", claim_in)
    put(f"claim{t}/out", steal.claim_tasks(*(jnp.asarray(a)
                                             for a in claim_in)))

np.savez(os.path.join(out_dir, "ref.npz"), **arrays)
with open(os.path.join(out_dir, "ref.json"), "w") as f:
    json.dump(meta, f)
print("RESULT ok")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh_ref")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(os.path.dirname(__file__), "..", "src")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", _SCRIPT, str(out)], env=env,
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(out / "ref.npz") as z:
        arrays = {k: z[k] for k in z.files}
    return arrays, json.loads((out / "ref.json").read_text()), out


def ref_leaves(arrays, prefix):
    out = []
    while f"{prefix}/{len(out)}" in arrays:
        out.append(arrays[f"{prefix}/{len(out)}"])
    assert out, prefix
    return out


def assert_leaves_equal(port_tree, want, where):
    """The port tree's tensor leaves equal the reference's arrays, dtype
    and bits (the port's int32 bitsets against uint32)."""
    got = [t.detach().cpu().numpy() for t in tree_leaves(port_tree)]
    assert len(got) == len(want), where
    for j, (g, w) in enumerate(zip(got, want)):
        if w.dtype == np.uint32:
            assert g.dtype == np.int32, (where, j)
            g = g.view(np.uint32)
        assert g.dtype == w.dtype, (where, j, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=f"{where} leaf {j}")


def from_leaves(like, leaves):
    """The reference's leaves as a port tree shaped like ``like``."""
    it = iter(leaves)
    return tree_map(lambda _: tensor(next(it)), like)


CPU8 = dist.Mesh(["cpu"] * 8)
MESHES = {"2x4": CPU8, "8": CPU8, "4": dist.Mesh(["cpu"] * 4), "1": None}
BOOT = dict(bootstrap_rounds=3, bootstrap_steps=4)
SOLVES = {
    "vc_2x4": ("vc", "gnp:16:35:5", "2x4",
               dict(lanes=4, steps_per_round=32, **BOOT)),
    "vc_8": ("vc", "gnp:16:35:5", "8",
             dict(lanes=4, steps_per_round=32, **BOOT)),
    "ds_2x4": ("ds", "gnp:12:30:9", "2x4", dict(lanes=2, steps_per_round=32)),
    "ss_8": ("ss", "ss:16:3", "8", dict(lanes=2, steps_per_round=16)),
}


def port_solve(family, spec, mesh, **cfg):
    rounds = {}

    def on_event(ev):
        if ev.kind == "round":
            rounds[ev.round] = dist._gather_lanes(ev.lanes)

    solver = Solver(SolverConfig(device="cpu", mesh=MESHES[mesh], **cfg),
                    on_event=on_event)
    return solver, solver.solve(registry.problem(family, spec)), rounds


def assert_solve_equal(arrays, meta, case, res, rounds):
    assert list(res.stats) == meta[case]["stats"], case
    assert sorted(rounds) == meta[case]["rounds"], case
    for r, lanes in rounds.items():
        assert_leaves_equal(lanes, ref_leaves(arrays, f"{case}/round{r}"),
                            f"{case} round {r}")
    assert_leaves_equal(dist._gather_lanes(res.lanes),
                        ref_leaves(arrays, f"{case}/final"), f"{case} final")
    assert_leaves_equal(res.payload, ref_leaves(arrays, f"{case}/payload"),
                        f"{case} payload")


@pytest.mark.parametrize("case", sorted(SOLVES))
def test_sharded_solve_equals_reference(ref, case):
    """8 CPU shards against the reference's 2x4 or flat-8 mesh: the
    gathered lanes after every round, the final lanes, ``SolveStats`` and
    payload, bitwise; the optimum is the serial oracle's."""
    arrays, meta, _ = ref
    family, spec, mesh, cfg = SOLVES[case]
    solver, res, rounds = port_solve(family, spec, mesh, **cfg)
    assert_solve_equal(arrays, meta, case, res, rounds)
    assert res.stats.lanes == 8 * cfg["lanes"]
    assert res.stats.best == solver.oracle(
        registry.problem(family, spec)).best
    if family == "vc":
        assert res.stats.t_c > 0


def test_sharded_trace_equals_reference(ref, tmp_path):
    arrays, meta, out = ref
    family, spec, mesh, cfg = SOLVES["vc_2x4"]
    path = tmp_path / "t.jsonl"
    solver, res, _ = port_solve(family, spec, mesh, trace_path=str(path),
                                metrics=True, **cfg)
    got = records(path)
    assert got == records(out / "vc_2x4.jsonl")
    assert sum(r.get("steal_recv_cross", 0) for r in got
               if r["t"] == "round") == res.stats.t_c > 0
    assert solver.metrics().value("steal_received", scope="cross") == \
        res.stats.t_c


@pytest.mark.parametrize("case,mesh,lanes", [("resume_4", "4", 4),
                                             ("resume_1", "1", 16)])
def test_checkpoint_resumes_on_other_shard_counts(ref, tmp_path, case, mesh,
                                                  lanes):
    """An 8-shard solve checkpointed at round 4 (the port's file equals
    the reference's, array for array) resumes onto 4 shards (from the
    reference's file) and onto one device (from the port's) as the
    reference resumes."""
    arrays, meta, out = ref
    t_ckpt = str(tmp_path / "t.ckpt")
    _, res, rounds = port_solve(
        "vc", "gnp:40:20:3", "8", lanes=4, steps_per_round=16, max_rounds=4,
        checkpoint_every=2, checkpoint_path=t_ckpt, **BOOT)
    assert_solve_equal(arrays, meta, "ckpt_8", res, rounds)
    with np.load(t_ckpt) as t, np.load(out / "ref.ckpt") as j:
        assert sorted(t.files) == sorted(j.files)
        for key in j.files:
            np.testing.assert_array_equal(t[key], j[key], err_msg=key)
    path = str(out / "ref.ckpt") if mesh == "4" else t_ckpt
    _, res, rounds = port_solve("vc", "gnp:40:20:3", mesh, lanes=lanes,
                                steps_per_round=16, resume_from=path)
    assert_solve_equal(arrays, meta, case, res, rounds)


STEALS = {"scoped": (16, 2), "starve": (1, 2), "scattered": (16, 4),
          "surplus": (16, 4), "two_donors": (16, 4), "no_demand": (16, 4)}


def full_tree(depth):
    """The reference's ``from_callbacks`` full binary tree of the quota
    tests: state (depth, code); leaves at ``depth`` with value code + 1."""
    from typing import NamedTuple

    class S(NamedTuple):
        d: torch.Tensor
        c: torch.Tensor

    def evaluate_batch(s, best):
        def child(bit):
            return S(s.d + 1, s.c * 2 + bit)
        return NodeEval(is_solution=s.d == depth, value=s.c + 1,
                        lower_bound=torch.zeros_like(s.d), left=child(0),
                        right=child(1), payload=s.c)

    zero = torch.zeros((), dtype=torch.int32)
    return BinaryProblem(name="full", max_depth=depth,
                         root=lambda: S(zero, zero),
                         evaluate_batch=evaluate_batch,
                         payload_zero=lambda: zero)


def steal_problem(arrays, case):
    if case in ("scoped", "starve"):
        from repro_torch.service.batch_problem import StackedTables
        spec = StackedSpec(n=12, k=2)
        tables = StackedTables(
            adj=tensor(arrays["stacked/adj"]),
            fullm=tensor(arrays["stacked/fullm"]),
            family=tensor(arrays["stacked/family"]))
        return spec.bind(tables, "cpu")
    return full_tree(12)


@pytest.mark.parametrize("case", sorted(STEALS))
def test_cross_device_steal_equals_reference(ref, case):
    """One cross-device steal over 8 CPU shards from the reference's input
    lanes: every output array is the reference's ``shard_map`` output."""
    arrays, _, _ = ref
    max_ship, w = STEALS[case]
    problem = steal_problem(arrays, case)
    lanes = from_leaves(init_lanes(problem, 8 * w, seed_root=False),
                        ref_leaves(arrays, f"{case}/in"))
    shards = dist._shard_lanes(lanes, CPU8).shards
    out = dist.ShardedLanes(dist.cross_device_steal(
        [problem] * 8, shards, max_ship)).gather()
    assert_leaves_equal(out, ref_leaves(arrays, f"{case}/out"), case)
    newly = torch.nonzero(out.active & ~lanes.active).flatten().tolist()
    moved = int((out.donated - lanes.donated).sum())
    assert int((out.t_c - lanes.t_c).sum()) == len(newly) == moved
    if case == "scoped":      # only the inst-0 thief is fed
        assert (moved, newly, out.inst[10].item()) == (1, [10], 0)
    if case == "starve":      # a zero-demand instance does not crowd out
        assert moved == 1 and [out.inst[x].item() for x in newly] == [1]
    if case in ("scattered", "two_donors"):
        assert moved == 4
    if case in ("surplus", "no_demand"):
        assert moved == {"surplus": 1, "no_demand": 0}[case]


@pytest.mark.parametrize("t", range(2))
def test_extract_and_claim_tasks_equal_reference(ref, t):
    arrays, _, _ = ref
    problem = steal_problem(arrays, "scoped")
    lanes = from_leaves(init_lanes(problem, 24, seed_root=False),
                        ref_leaves(arrays, f"extract{t}/in"))
    got = steal.extract_tasks(lanes, tensor(arrays[f"extract{t}/quota"]),
                              int(arrays[f"extract{t}/max_tasks"]))
    assert_leaves_equal(got, ref_leaves(arrays, f"extract{t}/out"),
                        f"extract_tasks {t}")
    claim_in = [tensor(a) for a in ref_leaves(arrays, f"claim{t}/in")]
    src, claim = steal.claim_tasks(*claim_in)
    want_src, want_claim = ref_leaves(arrays, f"claim{t}/out")
    np.testing.assert_array_equal(claim.numpy(), want_claim)
    np.testing.assert_array_equal(src.numpy(), want_src.astype(np.int32))


# -- the mesh itself (no reference needed) ----------------------------------


def test_mesh_layout_and_round_trip():
    """``make_mesh``, the layout and shard/gather: lane fields split in
    rank order, replicated fields copied, and gathering gives the lanes
    back; a mismatched device type is a config error."""
    mesh = dist.make_mesh(3, "cpu")
    assert (mesh.size, mesh.device_type, mesh.axis_names) == (
        3, "cpu", ("workers",))
    assert mesh.distinct() == (torch.device("cpu"),)
    with pytest.raises(ValueError):
        dist.make_mesh(0, "cpu")
    with pytest.raises(ValueError):
        dist.Mesh([])
    problem = registry.problem("vc", "gnp:16:35:5").build(device="cpu")
    specs = dist.lane_partition_specs(problem)
    assert (specs.idx, specs.best, specs.steps) == (
        "split", "replicated", "replicated")
    assert set(tree_leaves(specs.stack)) == {"split"}
    lanes = init_lanes(problem, 6)
    sharded = dist._shard_lanes(lanes, mesh)
    assert [s.idx.shape[0] for s in sharded.shards] == [2, 2, 2]
    assert bool(sharded.shards[0].active[0])
    assert not any(bool(s.active.any()) for s in sharded.shards[1:])
    back = sharded.gather()
    for a, b in zip(tree_leaves(back), tree_leaves(lanes)):
        assert torch.equal(a, b)
    assert torch.equal(sharded.nodes, lanes.nodes)
    with pytest.raises(ValueError):
        dist._shard_lanes(init_lanes(problem, 7), mesh)
    with pytest.raises(ConfigError, match="mesh"):
        SolverConfig(device="cuda", mesh=mesh)
    with pytest.raises(ConfigError, match="max_ship"):
        SolverConfig(device="cpu", mesh=mesh, max_ship=0)


def test_one_shard_mesh_is_the_single_device_solve():
    """A mesh of one shard has nobody to steal from: its solve is the
    unsharded solve, bitwise (``t_c`` stays 0)."""
    handle = registry.problem("vc", "gnp:30:20:3")
    cfg = dict(device="cpu", lanes=8, steps_per_round=16, **BOOT)
    one = Solver(SolverConfig(mesh=dist.make_mesh(1, "cpu"), **cfg)).solve(
        handle)
    plain = Solver(SolverConfig(**cfg)).solve(handle)
    assert one.stats == plain.stats and one.stats.t_c == 0
    for a, b in zip(tree_leaves(one.lanes.gather()),
                    tree_leaves(plain.lanes)):
        assert torch.equal(a, b)

"""The port's engine, steal round and single-device round against the JAX
reference, array for array.

Both packages start from one ``Lanes`` state, carried across by
``repro_torch.convert``; then each advances on its own and every ``Lanes``
array is compared after each ``make_expand`` and after each ``make_round``
(and ``balance_device``).  The reference runs its "jnp" backend here: the
node evaluation of both of its backends is held against the port in
``test_torch_node_eval.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distributed as jdist
from repro.core import engine as jengine
from repro.core import indexing as jindexing
from repro.core import steal as jsteal
from repro.problems import graphs as jgraphs
from repro.problems.dominating_set import make_dominating_set as j_make_ds
from repro.problems.vertex_cover import make_vertex_cover as j_make_vc
from repro_torch.convert import lanes_from_numpy, to_numpy, to_torch
from repro_torch.core import distributed as tdist
from repro_torch.core import engine as tengine
from repro_torch.core import indexing as tindexing
from repro_torch.core import steal as tsteal
from repro_torch.core.api import DELEGATED, LEFT, RIGHT, UNVISITED
from repro_torch.problems.dominating_set import make_dominating_set
from repro_torch.problems.graphs import parse_graph_instance
from repro_torch.problems.vertex_cover import make_vertex_cover

FAMILIES = {"vc": (j_make_vc, make_vertex_cover),
            "ds": (j_make_ds, make_dominating_set)}


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def assert_lanes_equal(port_lanes, ref_lanes, where):
    """Every array of the port's Lanes equals the reference's, dtype and
    all (uint32 bitsets compared as the same bits)."""
    ref_np = numpy_tree(ref_lanes)
    got = to_numpy(port_lanes, like=ref_np)
    for leaf_g, leaf_r, path in zip(jax.tree_util.tree_leaves(got),
                                    jax.tree_util.tree_leaves(ref_np),
                                    _paths(ref_np)):
        assert leaf_g.dtype == leaf_r.dtype, (where, path)
        np.testing.assert_array_equal(leaf_g, leaf_r,
                                      err_msg=f"{where}: {path}")


def _paths(lanes):
    out = []
    for field in lanes._fields:
        value = getattr(lanes, field)
        if isinstance(value, tuple):
            out += [f"{field}.{sub}" for sub in value._fields]
        else:
            out.append(field)
    return out


def build(family, spec):
    j_make, t_make = FAMILIES[family]
    return (j_make(jgraphs.parse_graph_instance(spec)),
            t_make(parse_graph_instance(spec), device="cpu"))


@pytest.mark.parametrize("family,spec,lanes,warm", [
    ("vc", "reg:36:4:3", 16, 0),
    ("ds", "gnp:14:30:2", 8, 0),
    ("vc", "gnp:40:20:3", 6, 2),
])
def test_lanes_equal_after_every_expand_and_balance(family, spec, lanes,
                                                    warm):
    """Expand and steal alternately; with ``warm`` the start is a
    mid-solve reference state carried across by ``convert``."""
    jp, tp = build(family, spec)
    jl = jengine.init_lanes(jp, lanes)
    j_round = jax.jit(jdist.make_round(jp, 8))
    for _ in range(warm):
        jl, _ = j_round(jl)
    tl = lanes_from_numpy(numpy_tree(jl), tp)
    assert_lanes_equal(tl, jl, "carried across")

    j_balance = jax.jit(lambda l: jsteal.balance_device(jp, l))
    for i, steps in enumerate([8, 8, 16, 64]):
        jl = jax.jit(jengine.make_expand(jp, steps))(jl)
        tl = tengine.make_expand(tp, steps)(tl)
        assert_lanes_equal(tl, jl, f"expand {i}")
        jl = j_balance(jl)
        tl = tsteal.balance_device(tp, tl)
        assert_lanes_equal(tl, jl, f"balance {i}")


@pytest.mark.parametrize("family,spec,lanes,fused", [
    ("vc", "gnp:30:25:4", 8, 1),
    ("ds", "gnp:40:15:3", 12, 3),
])
def test_lanes_and_open_work_equal_after_every_round(family, spec, lanes,
                                                     fused):
    """``make_round`` until the solve drains: the steps counter stays equal
    even when a round's lanes go idle mid-expand (the port predicates
    steps instead of leaving its loop early).  The reference's round
    groups its steps by ``fused``; the port's one round equals it for
    every value."""
    jp, tp = build(family, spec)
    jl = jengine.init_lanes(jp, lanes)
    tl = tengine.init_lanes(tp, lanes)
    assert_lanes_equal(tl, jl, "init")
    j_round = jax.jit(jdist.make_round(jp, 16, fused_steps=fused))
    t_round = tdist.make_round(tp, 16)
    for r in range(60):
        jl, j_open = j_round(jl)
        tl, t_open = t_round(tl)
        assert_lanes_equal(tl, jl, f"round {r}")
        np.testing.assert_array_equal(t_open.numpy(), np.asarray(j_open))
        if int(t_open.sum()) == 0:
            break
    else:
        pytest.fail("did not drain in 60 rounds")
    assert r > 2


# -- indexing and steal helpers on random lane states -------------------------

def random_control(rng, w, il, k):
    idx = rng.choice([UNVISITED, DELEGATED, LEFT, RIGHT],
                     size=(w, il)).astype(np.int8)
    depth = rng.randint(0, il, size=w).astype(np.int32)
    base = np.minimum(rng.randint(0, il, size=w), depth).astype(np.int32)
    active = rng.rand(w) < 0.5
    inst = rng.randint(-1, k, size=w).astype(np.int32)
    return idx, depth, base, active, inst


@pytest.mark.parametrize("seed", range(4))
def test_indexing_helpers_equal_reference(seed):
    rng = np.random.RandomState(seed)
    idx, depth, base, _, _ = random_control(rng, 24, 13, 1)
    slots = jax.vmap(jindexing.heaviest_open_slot)(
        jnp.asarray(idx), jnp.asarray(base), jnp.asarray(depth))
    got = tindexing.heaviest_open_slot(torch.from_numpy(idx),
                                       torch.from_numpy(base),
                                       torch.from_numpy(depth))
    np.testing.assert_array_equal(got.numpy(), np.asarray(slots))
    assert got.dtype == torch.int32
    j_idx, j_bits = jax.vmap(jindexing.extract_task)(jnp.asarray(idx), slots)
    t_idx, t_bits = tindexing.extract_task(torch.from_numpy(idx), got)
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(t_bits.numpy(), np.asarray(j_bits))
    assert t_idx.dtype == t_bits.dtype == torch.int8
    np.testing.assert_array_equal(
        tindexing.task_weight(got).numpy(),
        np.asarray(jindexing.task_weight(slots)))


@pytest.mark.parametrize("seed,k", [(0, 1), (1, 3), (2, 2), (3, 4)])
def test_matching_equals_reference_and_is_a_bijection(seed, k):
    """Instance-scoped ranked matching on random lane states (unbound
    lanes included), against the reference; every matched thief draws
    from a distinct donor of its own instance."""
    rng = np.random.RandomState(seed)
    w, il = 32, 11
    idx, depth, base, active, inst = random_control(rng, w, il, k)
    _, tp = build("vc", "gnp:10:30:1")
    template = tengine.init_lanes(tp, w)
    ref = to_numpy(template)._replace(idx=idx, depth=depth, base=base,
                                      active=active, inst=inst)
    port = to_torch(ref, template)
    jref = jengine.Lanes(*jax.tree_util.tree_map(jnp.asarray, ref))

    j_slots = jsteal.donor_slots(jref)
    t_slots = tsteal.donor_slots(port)
    np.testing.assert_array_equal(t_slots.numpy(), np.asarray(j_slots))
    np.testing.assert_array_equal(tsteal.donor_mask(port, t_slots).numpy(),
                                  np.asarray(jsteal.donor_mask(jref,
                                                               j_slots)))
    np.testing.assert_array_equal(tsteal.thief_mask(port).numpy(),
                                  np.asarray(jsteal.thief_mask(jref)))
    j_src, j_matched, j_donor = jsteal.match_thieves_to_donors(jref, j_slots)
    t_src, t_matched, t_donor = tsteal.match_thieves_to_donors(port, t_slots)
    np.testing.assert_array_equal(t_src.numpy(), np.asarray(j_src))
    np.testing.assert_array_equal(t_matched.numpy(), np.asarray(j_matched))
    np.testing.assert_array_equal(t_donor.numpy(), np.asarray(j_donor))
    src = t_src.numpy()[t_matched.numpy()]
    assert len(set(src.tolist())) == len(src) == int(t_donor.sum())
    assert (inst[src] == inst[t_matched.numpy()]).all()

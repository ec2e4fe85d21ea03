"""``NodeEval`` of the port's problems, field for field, against the JAX
reference's ``make_vertex_cover`` / ``make_dominating_set`` under both of
its backends ("jnp", and "pallas" in interpret mode) on random states made
with numpy, dead and infeasible states included."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.api import INF_VALUE as J_INF
from repro.problems import graphs as jgraphs
from repro.problems.dominating_set import DSState as JDS
from repro.problems.dominating_set import make_dominating_set as j_make_ds
from repro.problems.vertex_cover import VCState as JVC
from repro.problems.vertex_cover import make_vertex_cover as j_make_vc
from repro_torch.convert import to_numpy, to_torch
from repro_torch.core.api import INF_VALUE, NodeEval
from repro_torch.problems.dominating_set import DSState, make_dominating_set
from repro_torch.problems.graphs import full_mask, parse_graph_instance
from repro_torch.problems.vertex_cover import VCState, make_vertex_cover


def random_words(rng, shape):
    return rng.randint(0, 2 ** 32, size=shape, dtype=np.uint64).astype(
        np.uint32)


def vc_states(rng, n, lanes):
    full = full_mask(n)
    alive = random_words(rng, (lanes, full.size)) & full
    alive[0] = 0                                  # dead: nothing alive
    alive[1] = full                               # the root
    cover = random_words(rng, (lanes, full.size)) & full & ~alive
    size = rng.randint(0, n, size=lanes).astype(np.int32)
    return JVC(alive=alive, cover=cover, size=size)


def ds_states(rng, n, lanes):
    full = full_mask(n)
    dominated = random_words(rng, (lanes, full.size)) & full
    cand = random_words(rng, (lanes, full.size)) & full
    dominated[0] = full                           # a solution
    cand[1] = 0                                   # infeasible: no candidate
    dominated[2], cand[2] = 0, full               # the root
    chosen = random_words(rng, (lanes, full.size)) & full
    size = rng.randint(0, n, size=lanes).astype(np.int32)
    return JDS(dominated=dominated, cand=cand, chosen=chosen, size=size)


def reference_evals(make, graph, states, best):
    """The reference's NodeEval per backend, as numpy trees."""
    jstates = jax.tree_util.tree_map(jnp.asarray, states)
    jbest = jnp.asarray(best)
    out = {"jnp": jax.vmap(make(graph).evaluate)(jstates, jbest)}
    pallas = make(graph, backend="pallas", tile=32, interpret=True)
    out["pallas"] = pallas.evaluate_batch(jstates, jbest)
    return {k: jax.tree_util.tree_map(np.asarray, v) for k, v in out.items()}


def assert_node_eval_equal(got: NodeEval, want, state_type):
    got = to_numpy(got, like=want)
    for field in NodeEval._fields:
        a, b = getattr(got, field), getattr(want, field)
        if field in ("left", "right"):
            assert isinstance(a, state_type)
            for sub in a._fields:
                np.testing.assert_array_equal(
                    getattr(a, sub), getattr(b, sub), err_msg=f"{field}.{sub}")
                assert getattr(a, sub).dtype == getattr(b, sub).dtype
        else:
            np.testing.assert_array_equal(a, b, err_msg=field)
            assert a.dtype == b.dtype, field


@pytest.mark.parametrize("spec,lanes", [("gnp:40:20:3", 12),
                                        ("gnp:70:10:1", 9),
                                        ("reg:36:4:3", 8)])
def test_vertex_cover_node_eval_equals_reference(spec, lanes):
    rng = np.random.RandomState(lanes)
    jg = jgraphs.parse_graph_instance(spec)
    states = vc_states(rng, jg.n, lanes)
    best = rng.randint(0, jg.n, size=lanes).astype(np.int32)
    best[:2] = J_INF
    want = reference_evals(j_make_vc, jg, states, best)
    port = make_vertex_cover(parse_graph_instance(spec), device="cpu")
    got = port.evaluate_batch(to_torch(states, VCState(0, 0, 0)),
                              torch.from_numpy(best))
    for backend in ("jnp", "pallas"):
        assert_node_eval_equal(got, want[backend], VCState)


@pytest.mark.parametrize("spec,lanes", [("gnp:14:30:2", 8),
                                        ("gnp:40:15:3", 10),
                                        ("gnp:60:10:5", 7)])
def test_dominating_set_node_eval_equals_reference(spec, lanes):
    rng = np.random.RandomState(lanes + 100)
    jg = jgraphs.parse_graph_instance(spec)
    states = ds_states(rng, jg.n, lanes)
    best = np.full(lanes, int(J_INF), np.int32)
    want = reference_evals(j_make_ds, jg, states, best)
    port = make_dominating_set(parse_graph_instance(spec), device="cpu")
    got = port.evaluate_batch(to_torch(states, DSState(0, 0, 0, 0)),
                              torch.from_numpy(best))
    assert int(got.lower_bound[1]) == INF_VALUE     # infeasible state
    for backend in ("jnp", "pallas"):
        assert_node_eval_equal(got, want[backend], DSState)


def test_apply_and_arity_follow_evaluate():
    g = parse_graph_instance("gnp:30:25:4")
    prob = make_vertex_cover(g, device="cpu")
    rng = np.random.RandomState(4)
    states = to_torch(vc_states(rng, g.n, 6), VCState(0, 0, 0))
    ev = prob.evaluate_batch(states, torch.full((6,), INF_VALUE,
                                                dtype=torch.int32))
    bit = torch.tensor([0, 1, 0, 1, 1, 0], dtype=torch.int32)
    child = prob.apply(states, bit)
    for a, l, r in zip(child, ev.left, ev.right):
        want = torch.where((bit == 0).reshape((-1,) + (1,) * (l.dim() - 1)),
                           l, r)
        assert torch.equal(a, want)
    best = torch.full((6,), 3, dtype=torch.int32)
    ev = prob.evaluate_batch(states, best)
    want = torch.where(ev.is_solution | (ev.lower_bound >= best), 0, 2)
    assert torch.equal(prob.arity(states, best), want.to(torch.int32))


def test_problem_tables_follow_the_device():
    g = parse_graph_instance("gnp:20:30:1")
    assert make_vertex_cover(g, device="cpu").root().alive.device.type == \
        "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_vertex_cover(g)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_dominating_set(g, device="cuda")

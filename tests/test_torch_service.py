"""The port's multi-tenant service against the JAX reference's, bitwise.

* ``StackedSpec.bind(...).evaluate_batch`` against the reference's
  ``vmap(evaluate)`` under ``backend="jnp"`` and its ``evaluate_batch``
  under ``"pallas"`` (interpret mode), on a mix of vc/ds roots and
  children and on lanes of no instance (``inst = -1``);
* a service of 3 slots and 16 lanes driven in lockstep with
  ``repro.solver.Solver(SolverConfig(backend="jnp")).serve``: after every
  ``step_round`` the two have equal ``Lanes``, open-work vectors,
  ``slot_rid``, ticket statuses and results; the mix has a ``@prio``, a
  ``@deadline`` that expires, a ``@budget`` that evicts and a ``cancel()``
  of a running request;
* admission writes the preallocated device tables in place, and the next
  round sees the write (a table replaced under the round would serve a
  stale instance);
* ``submit`` rejects what the reference rejects.

Both services are built through ``Solver.serve`` (``pytest.ini`` turns the
direct-construction deprecation into an error).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.serial import serial_rb as j_serial_rb
from repro.problems import graphs as jgraphs
from repro.problems.dominating_set import make_dominating_set_py as j_ds_py
from repro.problems.vertex_cover import make_vertex_cover_py as j_vc_py
from repro.service import SolveRequest as JRequest
from repro.service.batch_problem import StackedSpec as JSpec
from repro.service.batch_problem import StackedTables as JTables
from repro.solver import Solver as JSolver
from repro.solver import SolverConfig as JConfig
from repro_torch import convert
from repro_torch.problems import graphs as tgraphs
from repro_torch.problems.graphs import parse_graph_instance
from repro_torch.service import (FAMILY_DS, FAMILY_VC, AdmissionError,
                                 SolveRequest, StackedSpec)
from repro_torch.service.batch_problem import pack_instance
from repro_torch.solver import ConfigError, Solver, SolverConfig
from test_torch_engine import assert_lanes_equal, numpy_tree

FAMILY = {"vc": FAMILY_VC, "ds": FAMILY_DS}


def oracle(family, spec):
    make = {"vc": j_vc_py, "ds": j_ds_py}[family]
    return j_serial_rb(make(jgraphs.parse_graph_instance(spec)))[0]


# -- evaluate_batch ---------------------------------------------------------

SLOTS = [("vc", "gnp:20:30:5"), ("ds", "gnp:16:30:7"), ("vc", "reg:18:3:2")]


def host_tables(spec_n, slots):
    adj, fm, fam = zip(*(pack_instance(parse_graph_instance(s), FAMILY[f],
                                       spec_n) for f, s in slots))
    return np.stack(adj), np.stack(fm), np.asarray(fam, np.int32)


def reference_states(jproblem, k, depth, rng):
    """Roots of every slot and children down to ``depth`` along random
    bits, plus copies of some with ``inst = -1``, as one batch."""
    states = [jproblem.instance_root(jnp.int32(i)) for i in range(k)]
    frontier = list(states)
    for _ in range(depth):
        nxt = []
        for s in frontier:
            ev = jproblem.evaluate(s, jnp.int32(2 ** 30))
            nxt.append(ev.left if rng.rand() < 0.5 else ev.right)
            nxt.append(ev.right)
        states += nxt
        frontier = nxt[::2]
    batch = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *states)
    unbound = jax.tree_util.tree_map(lambda x: x[1::4], batch)
    unbound = unbound._replace(inst=jnp.full_like(unbound.inst, -1))
    return jax.tree_util.tree_map(lambda a, b: jnp.concatenate([a, b]),
                                  batch, unbound)


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
def test_evaluate_batch_equals_reference(backend):
    n, k = 20, len(SLOTS)
    adj, fm, fam = host_tables(n, SLOTS)
    jprob = JSpec(n=n, k=k).bind(JTables(jnp.asarray(adj), jnp.asarray(fm),
                                         jnp.asarray(fam)),
                                 backend, interpret=True, tile=8)
    tprob = StackedSpec(n=n, k=k).bind(
        convert.stacked_tables(JTables(adj, fm, fam)), "cpu")
    jstates = reference_states(jprob, k, 4, np.random.RandomState(3))
    w = jstates.inst.shape[0]
    best = np.random.RandomState(4).randint(2, 20, size=w).astype(np.int32)
    if backend == "jnp":
        want = jax.vmap(jprob.evaluate)(jstates, jnp.asarray(best))
    else:
        want = jprob.evaluate_batch(jstates, jnp.asarray(best))
    tstates = convert.to_torch(numpy_tree(jstates), tprob.root())
    got = tprob.evaluate_batch(tstates, torch.from_numpy(best))
    want_np = numpy_tree(want)
    got_np = convert.to_numpy(got, like=want_np)
    for g, r, path in zip(jax.tree_util.tree_leaves(got_np),
                          jax.tree_util.tree_leaves(want_np),
                          range(100)):
        assert g.dtype == r.dtype, path
        np.testing.assert_array_equal(g, r, err_msg=f"leaf {path}")
    assert (np.asarray(jstates.inst) < 0).sum() > 0


# -- the service in lockstep --------------------------------------------------

#: (family, spec, lifecycle attrs) — mixed families, n <= 20.
MIX = [
    ("vc", "gnp:20:30:5", {}),
    ("ds", "gnp:16:30:7", {"deadline_rounds": 2}),        # expires running
    ("vc", "reg:18:3:2", {"priority": 3}),                 # admitted first
    ("ds", "gnp:18:25:4", {"node_budget": 40}),            # budget evicts
    ("vc", "gnp:16:35:9", {}),                             # cancelled
    ("ds", "gnp:14:25:2", {}),
]
CANCEL = (4, 9)          # cancel rid 4 before round 10, while it runs


def services(lanes=16, slots=3, steps=6):
    jsvc = JSolver(JConfig(lanes=lanes, steps_per_round=steps,
                           backend="jnp")).serve(max_n=20, slots=slots)
    tsvc = Solver(SolverConfig(lanes=lanes, steps_per_round=steps,
                               device="cpu")).serve(max_n=20, slots=slots)
    return jsvc, tsvc


def submit_mix(svc, request_type, graphs_mod):
    return [svc.submit(request_type(rid=i, graph=graphs_mod.
                                    parse_graph_instance(s), family=f, **kw))
            for i, (f, s, kw) in enumerate(MIX)]


def assert_services_equal(tsvc, jsvc, where):
    assert_lanes_equal(tsvc.lanes, jsvc.lanes, where)
    assert tsvc.slot_rid == jsvc.slot_rid, where
    assert tsvc.rounds == jsvc.rounds, where
    assert ({r: t.status.value for r, t in tsvc.tickets.items()}
            == {r: t.status.value for r, t in jsvc.tickets.items()}), where
    assert ({r: t.nodes_used for r, t in tsvc.tickets.items()}
            == {r: t.nodes_used for r, t in jsvc.tickets.items()}), where
    assert sorted(tsvc.results) == sorted(jsvc.results), where
    for rid, res in jsvc.results.items():
        got = tsvc.results[rid]
        assert (got.optimum, got.admitted_round, got.retired_round,
                got.status) == (res.optimum, res.admitted_round,
                                res.retired_round, res.status), (where, rid)
        assert got.payload.dtype == np.asarray(res.payload).dtype
        np.testing.assert_array_equal(got.payload, np.asarray(res.payload))


def test_service_equals_reference_after_every_round():
    jsvc, tsvc = services()
    jt = submit_mix(jsvc, JRequest, jgraphs)
    tt = submit_mix(tsvc, SolveRequest, tgraphs)
    assert [t.rid for t in tt] == [t.rid for t in jt]
    assert_services_equal(tsvc, jsvc, "submitted")
    rounds = 0
    while jsvc._has_work():
        assert tsvc._has_work()
        if rounds == CANCEL[1]:
            assert tt[CANCEL[0]].status.value == "running"
            assert jt[CANCEL[0]].cancel() and tt[CANCEL[0]].cancel()
            assert_services_equal(tsvc, jsvc, "after cancel")
        j_open = jsvc.step_round()
        t_open = tsvc.step_round()
        rounds += 1
        np.testing.assert_array_equal(t_open, np.asarray(j_open))
        assert_services_equal(tsvc, jsvc, f"round {rounds}")
        assert rounds < 200
    assert not tsvc._has_work()
    status = {r.rid: r.status for r in tsvc.results.values()}
    assert status == {0: "done", 1: "expired", 2: "done", 3: "expired",
                      4: "cancelled", 5: "done"}
    for rid, (family, spec, _) in enumerate(MIX):
        want = oracle(family, spec)
        got = tsvc.results[rid].optimum
        assert got == want if status[rid] == "done" else got >= want


def test_admission_writes_the_round_tables_in_place():
    """One slot, three requests of both families: each admission after
    the first reuses slot 0.  The round and the bound problem hold the
    same table tensors all along, and every optimum is the oracle's (a
    round that kept the first table would solve the first instance
    again)."""
    mix = [("vc", "gnp:14:30:1"), ("ds", "gnp:15:30:2"), ("vc", "reg:16:3:4")]
    svc = Solver(SolverConfig(lanes=8, steps_per_round=8, device="cpu")
                 ).serve(max_n=16, slots=1)
    tables = svc._tables_dev
    ptrs = [t.data_ptr() for t in tables]
    for rid, (f, s) in enumerate(mix):
        svc.submit(SolveRequest(rid=rid, graph=parse_graph_instance(s),
                                family=f))
    seen = []
    while svc._has_work():
        svc.step_round()
        if svc.slot_rid[0] >= 0:
            seen.append(int(svc._tables_dev.family[0]))
        assert [t.data_ptr() for t in svc._tables_dev] == ptrs
        assert svc._tables_dev is tables
    assert FAMILY_DS in seen and FAMILY_VC in seen
    for rid, (f, s) in enumerate(mix):
        assert svc.results[rid].optimum == oracle(f, s), (f, s)

    # The bound problem sees a write made after it was built.
    prob = StackedSpec(n=16, k=1).bind(tables, "cpu")
    before = prob.instance_root(torch.zeros(1, dtype=torch.int32))
    adj, fm, fam = pack_instance(parse_graph_instance("gnp:12:40:3"),
                                 FAMILY_DS, 16)
    svc.tables.adj[0], svc.tables.fullm[0], svc.tables.family[0] = adj, fm, fam
    svc._write_slot(0)
    after = prob.instance_root(torch.zeros(1, dtype=torch.int32))
    assert not torch.equal(before.b, after.b)
    np.testing.assert_array_equal(after.b.numpy().view(np.uint32)[0], fm)


def test_round_from_carried_reference_state():
    """A reference service's tables and lanes after two rounds, carried
    into a port service: one more round gives the same lanes."""
    jsvc, tsvc = services(slots=2)
    for i, (f, s, _) in enumerate(MIX[:3]):
        jsvc.submit(JRequest(rid=i, graph=jgraphs.parse_graph_instance(s),
                             family=f))
    jsvc.step_round()
    jsvc.step_round()
    convert.load_service_state(tsvc, numpy_tree(jsvc.lanes), jsvc.tables)
    assert_lanes_equal(tsvc.lanes, jsvc.lanes, "carried")
    jl, j_open = jsvc._round(jsvc.lanes, jsvc._tables_jnp())
    tl, t_open = tsvc._round(tsvc.lanes)
    assert_lanes_equal(tl, jl, "round after carry")
    np.testing.assert_array_equal(t_open.numpy(), np.asarray(j_open))


def test_submit_rejects_what_the_reference_rejects():
    jsvc, tsvc = services()
    events = []
    tsvc.on_event = events.append
    g = parse_graph_instance("gnp:12:30:1")
    jg = jgraphs.parse_graph_instance("gnp:12:30:1")
    big = parse_graph_instance("gnp:24:30:1")
    jbig = jgraphs.parse_graph_instance("gnp:24:30:1")
    tsvc.submit(SolveRequest(rid=0, graph=g, family="vc"))
    jsvc.submit(JRequest(rid=0, graph=jg, family="vc"))
    bad = [dict(family="nope"), dict(family="vc", big=True),
           dict(family="ds", rid=0), dict(family="vc", deadline_rounds=0),
           dict(family="ds", node_budget=0)]
    for kw in bad:
        kw = dict(kw)
        rid = kw.pop("rid", 7)
        use_big = kw.pop("big", False)
        with pytest.raises(AdmissionError) as t_err:
            tsvc.submit(SolveRequest(rid=rid, graph=big if use_big else g,
                                     **kw))
        with pytest.raises(Exception) as j_err:
            jsvc.submit(JRequest(rid=rid, graph=jbig if use_big else jg,
                                 **kw))
        assert type(j_err.value).__name__ == "AdmissionError"
        if kw["family"] != "nope":
            assert str(t_err.value) == str(j_err.value)
    assert [e.kind for e in events] == ["reject"] * len(bad)
    assert len(tsvc.queue) == 1

    with pytest.raises(ConfigError):
        Solver(SolverConfig(device="cpu", checkpoint_every=2,
                            checkpoint_path="x.ckpt")).serve(max_n=8, slots=1)
    with pytest.raises(ConfigError):
        Solver(SolverConfig(device="cpu", scheduler="lifo")).serve(
            max_n=8, slots=1)
    for unported in (dict(mesh=object()), dict(trace_path="t.jsonl"),
                     dict(metrics=True), dict(autoscale=object()),
                     dict(max_ship=4)):
        with pytest.raises(ConfigError, match="not ported"):
            SolverConfig(device="cpu", **unported)


def test_tickets_resolve_through_the_port():
    """Ticket.result() drives the port's rounds; a cancelled ticket
    raises; the deprecated Ticket-as-int lookup warns as the reference's
    does."""
    from repro_torch.service import TicketCancelled
    svc = Solver(SolverConfig(lanes=8, steps_per_round=8, device="cpu",
                              scheduler="sjf")).serve(max_n=16, slots=1)
    a = svc.submit(SolveRequest(rid=0, graph=parse_graph_instance(
        "gnp:16:30:5"), family="vc"))
    b = svc.submit(SolveRequest(rid=1, graph=parse_graph_instance(
        "gnp:12:30:5"), family="ds"))
    c = svc.submit(SolveRequest(rid=2, graph=parse_graph_instance(
        "gnp:14:30:5"), family="vc"))
    assert [r.rid for r in svc.queue] == [1, 2, 0]          # smallest first
    assert c.cancel() and not c.cancel()
    with pytest.raises(TicketCancelled):
        c.result()
    res = a.result()
    assert res.optimum == oracle("vc", "gnp:16:30:5")
    assert b.done() and svc.results[1].optimum == oracle("ds", "gnp:12:30:5")
    with pytest.warns(DeprecationWarning, match="treating a Ticket"):
        assert svc.results[a].rid == 0

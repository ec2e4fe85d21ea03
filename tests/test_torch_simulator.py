"""The port's simulator of PARALLEL-RB (``core.serial``) and the scalar
half of ``core.indexing`` against the JAX reference's, on the cases of
``tests/test_indexing.py`` and ``tests/test_serial_protocol.py``."""

import dataclasses

import numpy as np
import pytest

from repro import registry as jregistry
from repro.core import indexing as jindexing
from repro.core import serial as jserial
from repro_torch import registry
from repro_torch.core import indexing as tindexing
from repro_torch.core import serial as tserial

PROBLEMS = [("vc", "gnp:16:30:3"), ("vc", "reg:20:3:1"),
            ("ds", "gnp:14:30:2"), ("ss", "ss:12:3"), ("ss", "ss:14:5")]


@pytest.mark.parametrize("family,spec", PROBLEMS)
@pytest.mark.parametrize("cores", [1, 3, 8, 33])
def test_simulator_equals_reference(family, spec, cores):
    """Makespan, nodes, best and per-core T_S / T_R equal the reference's;
    the optimum is the serial oracle's."""
    got = tserial.ParallelRBSimulator(
        registry.problem(family, spec).oracle(), c=cores).run()
    want = jserial.ParallelRBSimulator(
        jregistry.problem(family, spec).oracle(), c=cores).run()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.avg_t_s, got.avg_t_r) == (want.avg_t_s, want.avg_t_r)
    best, _, _ = tserial.serial_rb(registry.problem(family, spec).oracle())
    assert got.best == best


@pytest.mark.parametrize("cores", [2, 5, 16])
def test_delayed_bound_sharing_equals_reference(cores):
    py = registry.problem("vc", "gnp:16:30:3").oracle()
    jpy = jregistry.problem("vc", "gnp:16:30:3").oracle()
    got = tserial.ParallelRBSimulator(py, c=cores,
                                      instant_bound_share=False).run()
    want = jserial.ParallelRBSimulator(jpy, c=cores,
                                       instant_bound_share=False).run()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("c", [1, 2, 5, 8, 13, 64])
def test_virtual_topology_equals_reference(c):
    assert [tserial.get_parent(r, c) for r in range(c)] == \
        [jserial.get_parent(r, c) for r in range(c)]
    for r in range(c):
        for parent in range(c):
            for passes in range(3):
                assert tserial.get_next_parent(parent, r, c, passes) == \
                    jserial.get_next_parent(parent, r, c, passes)


def test_simulator_refuses_to_run_forever():
    sim = tserial.ParallelRBSimulator(
        registry.problem("vc", "gnp:16:30:3").oracle(), c=4)
    with pytest.raises(RuntimeError, match="did not terminate"):
        sim.run(max_ticks=3)


# -- the scalar half of core/indexing ---------------------------------------


def test_paper_worked_example():
    """§IV-A worked example: current_idx={1,0,1,0} at N_{3,2}."""
    for mod in (tindexing, jindexing):
        cur = [1, 0, 1, 0]
        got = mod.get_heaviest_task_index(cur)
        assert got == [1, -1] and cur == [1, -1, 1, 0]
        assert mod.fix_index(got) == [1, 1]
        got2 = mod.get_heaviest_task_index(cur)
        assert got2 == [1, -1, 1, -1] and cur == [1, -1, 1, -1]
        assert mod.fix_index(got2) == [1, 0, 1, 1]


@pytest.mark.parametrize("bits", [[1, 1, 1], [1, -1, 1], []])
def test_get_heaviest_none_when_all_explored(bits):
    assert tindexing.get_heaviest_task_index(list(bits)) is None
    assert jindexing.get_heaviest_task_index(list(bits)) is None


@pytest.mark.parametrize("seed", range(4))
def test_scalar_extract_equals_reference(seed):
    """Random paths: the same extracted prefix, the same marks left in
    place, the same FIXINDEX result and position."""
    rng = np.random.RandomState(seed)
    for _ in range(50):
        bits = [1] + [int(b) for b in rng.choice(
            [0, 1, -1], size=rng.randint(1, 13))]
        mine, ref = list(bits), list(bits)
        got = tindexing.get_heaviest_task_index(mine)
        assert got == jindexing.get_heaviest_task_index(ref)
        assert mine == ref
        if got is not None:
            assert tindexing.fix_index(got) == jindexing.fix_index(got)
        assert tindexing.index_to_position([max(b, 0) for b in bits]) == \
            jindexing.index_to_position([max(b, 0) for b in bits])


def test_index_to_position():
    for bits in ([], [0, 1], [1, 1], [1, 0, 1, 1]):
        assert tindexing.index_to_position(bits) == \
            jindexing.index_to_position(bits)
    assert tindexing.index_to_position([1, 1]) == (2, 3)


def _arbitrary_script(mod):
    """The §IV-C cases of tests/test_indexing.py, as one trace."""
    out = []
    a = mod.ArbitraryIndex(8)
    for k in (0, 1, 0):
        a.push_child(k, 2)
    out.append(a.heaviest_depth())
    path, first, s = a.steal()
    out += [list(path), first, s, a.heaviest_depth()]
    b = mod.ArbitraryIndex(4)
    b.push_child(1, 5)
    for take in (2, 5):
        path, first, s = b.steal(take=take)
        out += [list(path), first, s, b.idx2.tolist()]
    out.append(b.heaviest_depth())
    c = mod.ArbitraryIndex(4)
    c.push_child(0, 3)
    out += [c.advance_sibling(), c.idx1.tolist(), c.idx2.tolist()]
    c.steal()
    out.append(c.advance_sibling())
    c.pop()
    out += [c.depth, c.idx1.tolist(), c.idx2.tolist(), c.steal()]
    return out


def test_arbitrary_index_equals_reference():
    got = _arbitrary_script(tindexing)
    assert got == _arbitrary_script(jindexing)
    assert got[0] == 0 and got[1:4] == [[0], 1, 1] and got[4] == 2

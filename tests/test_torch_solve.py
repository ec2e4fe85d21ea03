"""``Solver.solve`` of the port on the CPU gives the same ``SolveStats`` as
the JAX reference's, field for field, and the optimum of the serial
oracle."""

import pytest

from repro import registry as jregistry
from repro.solver import Solver as JSolver
from repro.solver import SolverConfig as JConfig
from repro_torch import registry
from repro_torch.solver import Solver, SolverConfig

BOOT = dict(bootstrap_rounds=4, bootstrap_steps=8, steps_per_round=64)


@pytest.mark.parametrize("family,spec,lanes,optimum", [
    ("vc", "reg:36:4:3", 16, 21),
    ("ds", "gnp:14:30:2", 8, 3),
    ("vc", "gnp:60:15:7", 4, 42),
    ("vc", "gnp:60:15:7", 16, 42),
])
def test_solve_stats_equal_reference(family, spec, lanes, optimum):
    want = JSolver(JConfig(lanes=lanes, **BOOT)).solve(
        jregistry.problem(family, spec)).stats
    res = Solver(SolverConfig(lanes=lanes, device="cpu", **BOOT)).solve(
        registry.problem(family, spec))
    assert res.stats == want
    assert res.stats._fields == want._fields
    assert res.stats.best == optimum
    # The incumbent payload is a solution of that size.
    from repro_torch.kernels.ref import popcount
    assert int(popcount(res.payload).sum()) == optimum

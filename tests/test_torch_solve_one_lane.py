"""With one lane nothing is stolen, so the port's ``Solver.solve`` walks
exactly the serial oracle's tree: its ``SolveStats`` equal the JAX
reference's and its node count equals ``serial_rb``'s."""

from repro import registry as jregistry
from repro.solver import Solver as JSolver
from repro.solver import SolverConfig as JConfig
from repro_torch import registry
from repro_torch.solver import Solver, SolverConfig

BOOT = dict(bootstrap_rounds=4, bootstrap_steps=8, steps_per_round=64)


def test_one_lane_solve_walks_the_serial_tree():
    handle = registry.problem("vc", "gnp:60:15:7")
    want = JSolver(JConfig(lanes=1, **BOOT)).solve(
        jregistry.problem("vc", "gnp:60:15:7")).stats
    solver = Solver(SolverConfig(lanes=1, device="cpu", **BOOT))
    got = solver.solve(handle).stats
    assert got == want
    oracle = solver.oracle(handle)
    assert (got.best, got.nodes) == (oracle.best, oracle.nodes) == (42, 3987)
    assert (got.t_s, got.t_r, got.donated) == (1, 1, 0)

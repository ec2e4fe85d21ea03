"""The port's serial oracle, ``Solver`` facade and CLI against the JAX
reference's."""

import sys

import numpy as np
import pytest
import torch

from repro.core.serial import serial_rb as j_serial_rb
from repro.launch import solve as j_solve
from repro.problems import graphs as jgraphs
from repro.problems.dominating_set import make_dominating_set_py as j_ds_py
from repro.problems.vertex_cover import make_vertex_cover_py as j_vc_py
from repro_torch import registry
from repro_torch.core.serial import serial_rb
from repro_torch.launch import solve
from repro_torch.problems.dominating_set import make_dominating_set_py
from repro_torch.problems.graphs import parse_graph_instance
from repro_torch.problems.vertex_cover import make_vertex_cover_py
from repro_torch.solver import (EVENT_KINDS, ConfigError, ProgressEvent,
                                Solver, SolverConfig, emit)


@pytest.mark.parametrize("family,spec", [
    ("vc", "reg:36:4:3"), ("vc", "gnp:30:25:4"), ("ds", "gnp:14:30:2"),
    ("ds", "gnp:25:20:6"),
])
def test_serial_rb_equals_reference(family, spec):
    port_py, ref_py = {"vc": (make_vertex_cover_py, j_vc_py),
                       "ds": (make_dominating_set_py, j_ds_py)}[family]
    got = serial_rb(port_py(parse_graph_instance(spec)), record_visits=True)
    want = j_serial_rb(ref_py(jgraphs.parse_graph_instance(spec)),
                       record_visits=True)
    assert got == want
    oracle = Solver(SolverConfig(device="cpu")).oracle(
        registry.problem(family, spec))
    assert (oracle.best, oracle.nodes) == got[:2]


def result_line(out: str) -> str:
    line = [l for l in out.splitlines() if l.startswith("optimum=")][0]
    return line.rsplit(" wall=", 1)[0]


def run_main(module, argv, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["solve"] + argv)
    module.main()
    return capsys.readouterr().out


@pytest.mark.parametrize("argv", [
    ["--problem", "vc", "--instance", "reg:36:4:3", "--lanes", "16"],
    ["--problem", "ds", "--instance", "gnp:14:30:2", "--lanes", "8",
     "--steps-per-round", "16"],
])
def test_cli_prints_the_reference_result_line(argv, monkeypatch, capsys):
    want = result_line(run_main(j_solve, argv, monkeypatch, capsys))
    got = result_line(run_main(solve, argv + ["--device", "cpu"],
                               monkeypatch, capsys))
    assert got == want
    assert got.startswith("optimum=") and " T_R=" in got


def test_cli_refuses_cuda_without_a_card(monkeypatch, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    monkeypatch.setattr(sys, "argv", ["solve", "--instance", "gnp:12:30:1"])
    with pytest.raises(SystemExit) as e:
        solve.main()
    assert e.value.code != 0
    assert "CUDA is not available" in capsys.readouterr().err
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Solver(SolverConfig()).solve(registry.problem("vc", "gnp:12:30:1"))


def test_config_validation_and_events():
    for bad in (dict(lanes=0), dict(steps_per_round=0),
                dict(bootstrap_rounds=-1), dict(bootstrap_steps=0),
                dict(fused_steps=0), dict(device="gpu0")):
        with pytest.raises(ConfigError):
            SolverConfig(**bad)
    assert SolverConfig().device == "cuda"
    with pytest.raises(ValueError):
        emit(None, "rounds", round=1)
    with pytest.raises(ValueError):
        ProgressEvent(kind="nope", round=0)
    assert "round" in EVENT_KINDS and "done" in EVENT_KINDS

    events = []
    cfg = SolverConfig(lanes=4, steps_per_round=16, device="cpu")
    res = Solver(cfg, on_event=events.append).solve(
        registry.problem("vc", "gnp:16:30:2"))
    kinds = [e.kind for e in events]
    assert kinds[-1] == "done" and set(kinds[:-1]) == {"round"}
    assert len(kinds) - 1 == res.stats.rounds
    assert events[-2].open_work == 0
    assert events[-1].best == res.stats.best
    # A round budget stops the solve early.
    capped = Solver(SolverConfig(lanes=2, steps_per_round=1, max_rounds=3,
                                 device="cpu")).solve(
        registry.problem("vc", "gnp:16:30:2"))
    assert capped.stats.rounds == 3


def test_registry_surface():
    assert registry.names() == ("ds", "vc")
    handle = registry.problem("vc", "gnp:20:30:1")
    assert handle.label == "vc:gnp_20_0.3_1"
    assert registry.get("ds").size(handle.instance) == 20
    with pytest.raises(registry.UnknownProblemError):
        registry.get("ss")
    with pytest.raises(ValueError):
        registry.problem("vc", "gnp:bad")
    prob = handle.build(device="cpu")
    assert prob.max_depth == 20 and prob.num_instances == 1
    assert np.array_equal(prob.root().alive.numpy(),
                          np.array([(1 << 20) - 1], np.int32))

"""The port's serial oracle, ``Solver`` facade and CLI against the JAX
reference's."""

import sys

import numpy as np
import pytest
import torch

from repro.core.serial import serial_rb as j_serial_rb
from repro.launch import serve_solver as j_serve_solver
from repro.launch import solve as j_solve
from repro.problems import graphs as jgraphs
from repro.problems.dominating_set import make_dominating_set_py as j_ds_py
from repro.problems.vertex_cover import make_vertex_cover_py as j_vc_py
from repro_torch import registry
from repro_torch.core.serial import serial_rb
from repro_torch.launch import serve_solver, solve
from repro_torch.problems.dominating_set import make_dominating_set_py
from repro_torch.problems.graphs import parse_graph_instance
from repro_torch.problems.vertex_cover import make_vertex_cover_py
from repro_torch.solver import (EVENT_KINDS, ConfigError, ProgressEvent,
                                Solver, SolverConfig, emit)
from test_torch_obs import records


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
    ["--problem", "vc", "--instance", "gnp:20:30:2", "--lanes", "8",
     "--metrics"],
])
def test_cli_prints_the_reference_result_line(argv, monkeypatch, capsys):
    j_out = run_main(j_solve, argv, monkeypatch, capsys)
    t_out = run_main(solve, argv + ["--device", "cpu"], monkeypatch, capsys)
    got, want = result_line(t_out), result_line(j_out)
    assert got == want
    assert got.startswith("optimum=") and " T_R=" in got
    metrics = [[l for l in out.splitlines() if l.startswith("metrics:")]
               for out in (t_out, j_out)]
    assert metrics[0] == metrics[1]
    assert len(metrics[0]) == ("--metrics" in argv)


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
    assert registry.names() == ("ds", "ss", "vc")
    handle = registry.problem("vc", "gnp:20:30:1")
    assert handle.label == "vc:gnp_20_0.3_1"
    assert registry.get("ds").size(handle.instance) == 20
    with pytest.raises(registry.UnknownProblemError):
        registry.get("nope")
    ss = registry.problem("ss", "ss:12:3")
    assert ss.label == "ss:ss_12_3" and not ss.spec.servable
    assert ss.build(device="cpu").max_depth == 12
    with pytest.raises(ValueError):
        registry.problem("vc", "gnp:bad")
    prob = handle.build(device="cpu")
    assert prob.max_depth == 20 and prob.num_instances == 1
    assert np.array_equal(prob.root().alive.numpy(),
                          np.array([(1 << 20) - 1], np.int32))


def service_lines(out: str):
    """The per-request lines and the round count of the drained line
    (wall time and rate aside)."""
    lines = [l for l in out.splitlines() if l.startswith("  rid=")]
    drained = [l for l in out.splitlines() if l.startswith("drained ")]
    assert len(drained) == 1, out
    return lines, drained[0].split(",")[0]


@pytest.mark.parametrize("argv", [
    ["--instances", "vc:gnp:16:30:5,ds:gnp:14:30:7", "--lanes", "16",
     "--slots", "2"],
    ["--instances", "vc:gnp:20:30:5@prio=2,ds:gnp:16:30:7@deadline=3,"
     "vc:reg:18:3:2@budget=40,ds:gnp:14:25:2", "--lanes", "12", "--slots",
     "2", "--steps-per-round", "6", "--scheduler", "sjf"],
])
def test_serve_cli_prints_the_reference_lines(argv, monkeypatch, capsys):
    want = service_lines(run_main(j_serve_solver, argv, monkeypatch, capsys))
    got = service_lines(run_main(serve_solver, argv + ["--device", "cpu"],
                                 monkeypatch, capsys))
    assert got == want
    assert len(got[0]) == argv[1].count(",") + 1
    assert got[1].startswith("drained ") and " rounds" in got[1]


@pytest.mark.parametrize("flag", [["--devices", "2"], ["--autoscale", "4"]])
def test_serve_cli_refuses_what_is_not_ported(flag, tmp_path, monkeypatch,
                                              capsys):
    """The mesh flags, once refused, now run: ``--devices 2`` shards the
    pool over two CPU shards and ``--autoscale 4`` grows it while two
    requests queue (the trace holds the ``resize``); each request gets the
    result it gets on one device."""
    argv = ["--device", "cpu", "--lanes", "8", "--slots", "2",
            "--trace", str(tmp_path / "t.jsonl")]

    def results(out):
        return [l.split(" rounds=")[0] for l in service_lines(out)[0]]

    want = results(run_main(serve_solver, argv + ["--devices", "1"],
                            monkeypatch, capsys))
    assert [r["t"] for r in records(tmp_path / "t.jsonl")].count(
        "resize") == 0
    out = run_main(serve_solver, argv + flag, monkeypatch, capsys)
    assert results(out) == want and len(want) == 4
    resizes = [r for r in records(tmp_path / "t.jsonl")
               if r["t"] == "resize"]
    if flag[0] == "--devices":
        assert "over 16 lanes (2 device(s) x 8)" in out and not resizes
    else:
        assert "over 8 lanes (1 device(s) x 8)" in out
        assert [(r["devices"], r["lanes"]) for r in resizes][0] == (2, 16)


@pytest.mark.parametrize("flag", ["--trace", "--metrics"])
def test_serve_cli_telemetry_equals_the_reference(flag, tmp_path,
                                                  monkeypatch, capsys):
    """``--trace`` writes the reference's records; ``--metrics`` prints its
    ``metrics:`` line; the per-request lines do not move."""
    argv = ["--instances", "vc:gnp:16:30:5,ds:gnp:14:30:7,vc:gnp:14:25:2",
            "--lanes", "16", "--slots", "2"]
    extra = {}
    for pkg in ("j", "t"):
        extra[pkg] = ([flag, str(tmp_path / f"{pkg}.jsonl")]
                      if flag == "--trace" else [flag])
    j_out = run_main(j_serve_solver, argv + extra["j"], monkeypatch, capsys)
    t_out = run_main(serve_solver, argv + extra["t"] + ["--device", "cpu"],
                     monkeypatch, capsys)
    assert service_lines(t_out) == service_lines(j_out)
    if flag == "--trace":
        got = records(tmp_path / "t.jsonl")
        assert got == records(tmp_path / "j.jsonl")
        assert [r["t"] for r in got].count("retire") == 3
    else:
        metrics = [[l for l in out.splitlines() if l.startswith("metrics:")]
                   for out in (t_out, j_out)]
        assert metrics[0] == metrics[1] and len(metrics[0]) == 1


def test_solve_cli_checkpoint_and_resume(tmp_path, monkeypatch, capsys):
    """--ckpt writes the reference's file; --resume at another lane count
    prints the reference's result line, from either package's file."""
    base = ["--problem", "vc", "--instance", "gnp:30:25:4",
            "--steps-per-round", "8", "--ckpt-every", "2"]
    j_ckpt, t_ckpt = str(tmp_path / "j.ckpt"), str(tmp_path / "t.ckpt")
    first = base + ["--lanes", "8"]
    want = result_line(run_main(j_solve, first + ["--ckpt", j_ckpt],
                                monkeypatch, capsys))
    got = result_line(run_main(solve, first + ["--ckpt", t_ckpt, "--device",
                                               "cpu"], monkeypatch, capsys))
    assert got == want
    resume = base + ["--lanes", "5", "--resume"]
    want = result_line(run_main(j_solve, resume + ["--ckpt", j_ckpt],
                                monkeypatch, capsys))
    for path in (j_ckpt, t_ckpt):
        got = result_line(run_main(solve, resume + ["--ckpt", path,
                                                    "--device", "cpu"],
                                   monkeypatch, capsys))
        assert got == want

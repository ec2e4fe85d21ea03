"""CLI tests of the port's trace report (``repro_torch.obs.report``), one
for each case of ``tests/test_trace_report.py``: exit 0 on a clean trace,
exit 2 on every reconciliation or schema failure.  One more case holds
the port's report equal to ``tools/trace_report.py``'s on a trace the
port writes on the CPU."""
import json
import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tools"))

from repro_torch.obs import report  # noqa: E402
from repro_torch.obs.trace import TRACE_SCHEMA_VERSION, TraceWriter  # noqa: E402


def _write_trace(path, *, lane_nodes=(6, 4), inst_nodes=(10,), nodes=10,
                 schema=TRACE_SCHEMA_VERSION, summary=True):
    w = TraceWriter(str(path))
    w.write("meta", schema=schema, mode="solve", lanes=len(lane_nodes),
            slots=1)
    w.write("round", round=0, open=3, active=2, nodes=nodes, steal_req=1,
            steal_recv=1, donated=1, inst_nodes=list(inst_nodes))
    if summary:
        w.write("summary", rounds=1, nodes=nodes,
                lane_nodes=list(lane_nodes), inst_nodes=list(inst_nodes))
    w.close()
    return str(path)


def test_clean_trace_exits_zero(tmp_path, capsys):
    trace = _write_trace(tmp_path / "t.jsonl")
    assert report.main([trace]) == 0
    out = capsys.readouterr().out
    assert "trace report" in out
    assert "nodes=10" in out


def test_clean_trace_json_mode(tmp_path, capsys):
    trace = _write_trace(tmp_path / "t.jsonl")
    assert report.main([trace, "--json"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert got["nodes"] == 10
    assert got["lane_nodes"] == [6, 4]


def test_lane_total_mismatch_exits_two(tmp_path, capsys):
    trace = _write_trace(tmp_path / "t.jsonl", lane_nodes=(6, 5))
    assert report.main([trace]) == 2
    assert "per-lane node totals sum to 11" in capsys.readouterr().err


def test_instance_total_mismatch_exits_two(tmp_path, capsys):
    trace = _write_trace(tmp_path / "t.jsonl", inst_nodes=(9,))
    assert report.main([trace]) == 2
    assert "per-instance node totals sum to 9" in capsys.readouterr().err


def test_missing_summary_exits_two(tmp_path, capsys):
    trace = _write_trace(tmp_path / "t.jsonl", summary=False)
    assert report.main([trace]) == 2
    assert "no 'summary' record" in capsys.readouterr().err


def test_schema_version_mismatch_exits_two(tmp_path, capsys):
    trace = _write_trace(tmp_path / "t.jsonl",
                         schema=TRACE_SCHEMA_VERSION + 1)
    assert report.main([trace]) == 2
    assert "schema" in capsys.readouterr().err


def test_malformed_record_exits_two(tmp_path, capsys):
    path = tmp_path / "t.jsonl"
    path.write_text('{"t":"warp","round":1}\n')
    assert report.main([str(path)]) == 2
    assert "unknown trace record kind 'warp'" in capsys.readouterr().err


def test_meta_not_first_exits_two(tmp_path, capsys):
    path = tmp_path / "t.jsonl"
    w = TraceWriter(str(path))
    w.write("summary", rounds=0, nodes=0, lane_nodes=[0], inst_nodes=[0])
    w.close()
    assert report.main([str(path)]) == 2
    assert "first record must be 'meta'" in capsys.readouterr().err


def test_empty_trace_exits_two(tmp_path, capsys):
    path = tmp_path / "t.jsonl"
    path.write_text("")
    assert report.main([str(path)]) == 2
    assert "empty trace" in capsys.readouterr().err


def test_missing_file_exits_two(tmp_path, capsys):
    assert report.main([str(tmp_path / "nope.jsonl")]) == 2
    assert capsys.readouterr().err.startswith("trace_report:")


@pytest.mark.parametrize("values,expected", [
    ([5, 5, 5, 5], 0.0),
    ([], 0.0),
    ([0, 0, 0], 0.0),
])
def test_gini_degenerate_cases(values, expected):
    assert report.gini(values) == pytest.approx(expected)


@pytest.mark.parametrize("mode", ["solve", "service"])
def test_port_report_equals_the_tool_on_a_port_trace(tmp_path, capsys, mode):
    """A trace the port writes on the CPU reads the same through the
    port's report and through ``tools/trace_report.py``: report dicts
    and printed text alike."""
    import trace_report
    from repro_torch import registry
    from repro_torch.problems.graphs import parse_graph_instance
    from repro_torch.service import SolveRequest
    from repro_torch.solver import Solver, SolverConfig
    path = tmp_path / "t.jsonl"
    cfg = SolverConfig(lanes=8, steps_per_round=6, device="cpu",
                       trace_path=str(path), metrics=True)
    if mode == "solve":
        Solver(cfg).solve(registry.problem("vc", "gnp:20:30:2"))
    else:
        svc = Solver(cfg).serve(max_n=20, slots=2)
        for rid, (family, spec) in enumerate(
                [("vc", "gnp:16:30:5"), ("ds", "gnp:14:30:7"),
                 ("vc", "reg:12:3:2")]):
            svc.submit(SolveRequest(rid=rid, family=family,
                                    graph=parse_graph_instance(spec)))
        svc.drain()
    records = report.read_trace(str(path))
    got = report.analyze(records)
    assert got == trace_report.analyze(trace_report.read_trace(str(path)))
    assert got["mode"] == mode and got["nodes"] > 0
    assert report.main([str(path)]) == 0
    mine = capsys.readouterr().out
    assert trace_report.main([str(path)]) == 0
    assert capsys.readouterr().out == mine

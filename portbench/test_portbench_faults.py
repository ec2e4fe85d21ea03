"""``correct`` must come out false when the timed path is broken
underneath: the harness drives a whole run on the CPU (its look for a
card skipped) with one fault planted in the program for each fault the
cells can have.  (One card: no exchange between chips to leave out.)
Also the control: the reference with its proof dropped, in the program's
place, fails the comparison."""

from __future__ import annotations

import json
import pathlib

import pytest
import torch

from portbench import harness
from portbench.conftest import tiny_copy

CELLS = ["vc-hard-saturated", "ds-drain-stream", "vc-service-closed"]


def _unchanged(real):
    def make_step(problem):
        return lambda lanes: lanes
    return make_step


def _half_batch(real):
    """Only the even lanes take the step; the odd half keeps its state
    (odd lanes are among the first to receive work)."""
    def make_step(problem):
        step = real(problem)

        def half(lanes):
            out = step(lanes)
            w = lanes.idx.shape[0]
            keep = torch.arange(w, device=lanes.idx.device) % 2 == 1

            def mix(new, old):
                k = keep.reshape((w,) + (1,) * (new.dim() - 1))
                return torch.where(k, old, new)

            fields = {}
            for f in ("idx", "depth", "base", "inst", "active", "nodes",
                      "t_s", "t_r", "donated", "t_c"):
                fields[f] = mix(getattr(out, f), getattr(lanes, f))
            fields["stack"] = type(out.stack)(*[
                mix(n, o) for n, o in zip(out.stack, lanes.stack)])
            return out._replace(**fields)
        return half
    return make_step


def _answer_altered(real):
    """The incumbent's payload altered where the step elects a new one."""
    def make_step(problem):
        step = real(problem)

        def altered(lanes):
            out = step(lanes)
            new = (out.best < lanes.best)[:, None]
            return out._replace(best_payload=torch.where(
                new, out.best_payload ^ 1, out.best_payload))
        return altered
    return make_step


FAULTS = {"state_unchanged": _unchanged, "half_batch": _half_batch,
          "answer_altered": _answer_altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", CELLS)
def test_a_broken_timed_path_reads_not_correct(tmp_path, monkeypatch,
                                               workload, fault):
    from repro_torch.core import engine
    # A broken search may never end: wait 2 s past the close, not 20.
    tiny_root = tiny_copy(tmp_path, late_s=2)
    monkeypatch.setattr(engine, "make_step", FAULTS[fault](engine.make_step))
    result = harness.run_cell(tiny_root, workload, 2 ** 31 + 77, 0.5,
                              False, device="cpu")
    assert result["correct"] is False, result["checks"]


@pytest.mark.parametrize("workload", ["vc-hard-saturated",
                                      "ds-drain-stream"])
def test_the_control_reads_not_correct(tiny_root, workload):
    result = harness.run_cell(tiny_root, workload, 2 ** 31 + 5, 0.5, False,
                              device="cpu", control=True)
    assert result["correct"] is True
    assert any(c["value"] > c["limit"]
               for c in result["control_checks"].values())


def test_the_service_control_reads_not_correct_at_the_cells_size():
    # The service's control is the reference's serial solver with its
    # proof dropped, over requests of the cell's own mix.
    from portbench.drivers.closed_loop import pool_graph
    from portbench.reference import vc
    mix = json.loads((pathlib.Path(__file__).resolve().parent / "traffic" /
                      "service-closed.json").read_text())
    wrong = sum(vc.optimum(d) != vc.optimum(d, slack=1)
                for d in (pool_graph(mix, i) for i in range(mix["pool"])))
    assert wrong > 0

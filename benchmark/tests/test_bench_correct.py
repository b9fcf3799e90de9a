"""The comparison that decides ``correct``, driven through the rest of a
run on the CPU (the harness's look for a card skipped): sound runs pass
under each cell's own limits, the control (the reference in bfloat16 in
the program's place) fails them, and so does each fault a cell can
have, planted in the timed path (``faults.py``)."""

from __future__ import annotations

import json

import pytest
import torch

from conftest import small_cell

from benchmark import faults, harness, readings

CPU = torch.device("cpu")
SEED = 2**31 + 77  # seeds may exceed 32 signed bits


def _run(name, trace=False, fault=None):
    cell = small_cell(name)
    return cell, harness.run_cell(cell, SEED, 0.3, trace, "cpu",
                                  hooks=faults.hooks(fault) if fault else None)


@pytest.mark.parametrize("name", ["serve-mip360avg3m-orbit",
                                  "train-mip360avg3m-1297x840"])
@pytest.mark.parametrize("trace", [False, True])
def test_a_sound_run_is_correct(name, trace):
    cell, line = _run(name, trace)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["checks"]) == set(cell.limits)
    for c in line["checks"].values():
        assert c["value"] < 1e-3 * c["limit"]
    want = ({m["name"] for m in cell.per_layer} if trace
            else {m["name"] for m in cell.e2e})
    if trace:  # no device here: only the readers of host quantities read
        assert set(line["metrics"]) <= want
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(line["metrics"]) == want
    json.dumps(line)  # one JSON line


def test_the_checkpoint_cell_runs_correct():
    _, line = _run("serve-ckpt120k-orbit")
    assert line["correct"] is True, line["checks"]


def test_a_frame_altered_where_it_is_produced_is_caught():
    _, line = _run("serve-mip360avg3m-orbit", fault="altered")
    assert line["correct"] is False
    assert line["checks"]["frame_max_abs"]["value"] > \
        line["checks"]["frame_max_abs"]["limit"]


def test_a_step_that_returns_its_state_unchanged_is_caught():
    _, line = _run("train-mip360avg3m-1297x840", fault="unchanged")
    assert line["correct"] is False
    assert line["checks"]["grad_norm_gap"]["value"] == pytest.approx(1.0)
    assert line["checks"]["delta_norm_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("name", ["serve-mip360avg3m-orbit",
                                  "serve-ckpt120k-orbit",
                                  "train-mip360avg3m-1297x840"])
def test_the_control_fails(name):
    cell = small_cell(name)
    fn = (readings.control_serve if cell.mix["kind"] == "serve"
          else readings.control_train)
    numbers = fn(cell, SEED, CPU)
    assert any(numbers[k] > lim for k, lim in cell.limits.items()), numbers

"""A configuration that brings its own model, found by name with no edit
to any file of the benchmark: the fixture ``gs3d_mip.py`` (gs3d with the
port's Mip filter, and a driver of a made-up traffic kind) is copied into
a benchmark folder of its own, beside a configuration that names it. Run
through both drivers at a CPU test's size it is correct; with gs3d's
reference in the place of its own the same runs are not; and a traffic
kind that only the model names is dispatched to the model's driver."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

from conftest import ROOT, small_cell

from benchmark import harness

TESTS = Path(__file__).resolve().parent
BENCH = ROOT / "benchmark"
SEED = 2**31 + 91
CONFIG = "mip360avg3m-mip"
# The fixture's cells: (traffic mix, the cell of BENCHMARK.json whose
# limits and end-to-end metrics it takes, if any).
CELLS = {"serve-mip": ("drift-1080p", "serve-mip360avg3m-orbit"),
         "train-mip": ("views8-1297x840", "train-mip360avg3m-1297x840"),
         "still-mip": ("still-1080p", None),
         "nosuch-mip": ("nosuch-1080p", None)}


@pytest.fixture
def here(tmp_path):
    """A benchmark folder of the fixture's own: its model under
    ``models/``, its configuration, the benchmark's traffic mixes with
    two of made-up kinds, and the limits of the 3 M-gaussian cells."""
    here = tmp_path / "benchmark"
    (here / "models").mkdir(parents=True)
    shutil.copy(TESTS / "gs3d_mip.py", here / "models")
    shutil.copytree(BENCH / "traffic", here / "traffic")
    drift = json.loads((BENCH / "traffic" / "drift-1080p.json").read_text())
    for kind in ("still", "nosuch"):
        (here / "traffic" / f"{kind}-1080p.json").write_text(
            json.dumps(dict(drift, kind=kind)))
    (here / "limits").mkdir()
    for name, (_, like) in CELLS.items():
        shutil.copy(BENCH / "limits" / f"{like or 'serve-mip360avg3m-orbit'}"
                    ".json", here / "limits" / f"{name}.json")
    config = json.loads((BENCH / "configs" / "mip360avg3m.json").read_text())
    config = dict(config, name=CONFIG, model="gs3d_mip",
                  render=dict(config["render"], aa_mode="mip",
                              aa_dilation=0.3))
    (here / "configs").mkdir()
    (here / "configs" / f"{CONFIG}.json").write_text(json.dumps(config))
    return here


def _cell(here, name):
    real = json.loads((ROOT / "BENCHMARK.json").read_text())

    def renamed(m):
        if "workloads" not in m:
            return m
        return dict(m, workloads=[n for n, (_, like) in CELLS.items()
                                  if like in m["workloads"]])

    bench = {
        "configs": [{"name": CONFIG,
                     "file": str(here / "configs" / f"{CONFIG}.json")}],
        "workloads": [{"name": n, "config": CONFIG, "traffic": t, "chips": 1}
                      for n, (t, _) in CELLS.items()],
        "end_to_end": [renamed(m) for m in real["end_to_end"]],
        "per_layer": [renamed(m) for m in real["per_layer"]],
    }
    return small_cell(name, bench=bench, here=here)


@pytest.mark.parametrize("name", ["serve-mip", "train-mip"])
def test_a_model_found_by_name_runs_correct(here, name):
    cell = _cell(here, name)
    assert Path(cell.model.__file__) == here / "models" / "gs3d_mip.py"
    line = harness.run_cell(cell, SEED, 0.3, False, "cpu")
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    for c in line["checks"].values():  # float32 rounding, as gs3d reads
        assert c["value"] < 1e-2 * c["limit"]
    assert set(line["metrics"]) == {m["name"] for m in cell.e2e}


@pytest.mark.parametrize("name", ["serve-mip", "train-mip"])
def test_gs3d_reference_in_its_place_is_not_correct(here, name):
    cell = _cell(here, name)
    gs3d = harness.load_model("gs3d")
    cell.model.frame = gs3d.frame
    cell.model.loss_grad = gs3d.loss_grad
    line = harness.run_cell(cell, SEED, 0.3, False, "cpu")
    assert line["correct"] is False
    assert any(c["value"] > c["limit"] for c in line["checks"].values())


def test_a_kind_the_model_names_gets_its_driver(here):
    line = harness.run_cell(_cell(here, "still-mip"), SEED, 0.3, False,
                            "cpu")
    assert line["info"]["driver"] == "still"
    assert line["correct"] is True, line["checks"]
    assert set(line["metrics"]) == {"setup_s"}
    with pytest.raises(KeyError, match="nosuch"):
        harness.run_cell(_cell(here, "nosuch-mip"), SEED, 0.3, False, "cpu")

"""On the card only: one short run of a cell through the benchmark's
command, its last line and its limits."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from conftest import ROOT


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [0, 1])
def test_a_cell_runs_correct_on_the_card(card, trace):
    r = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "serve-ckpt120k-orbit", "--seed", str(2**31 + 5), "--seconds", "2",
         "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-2000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu"
    assert line["device"]["count"] == 1
    assert line["device"]["memory_peak_bytes"] > 0
    if trace:
        assert line["device"]["busy_s"] > 0
        bench = json.loads((ROOT / "BENCHMARK.json").read_text())
        named = {m["name"] for m in bench["per_layer"]
                 if "serve-ckpt120k-orbit" in m.get("workloads", [])}
        assert named <= set(line["metrics"]), named - set(line["metrics"])
        assert "k1_roofline.serve" in line["metrics"]
        assert line["metrics"]["k1_roofline.serve"]["value"] <= 100
    else:
        assert line["metrics"]["frames_per_s"]["value"] > 0

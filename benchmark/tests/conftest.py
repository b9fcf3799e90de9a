"""Shared helpers of the benchmark's CPU tests: the repository root on the
import path, and cells cut to a size the CPU renders in seconds (the
program's plain PyTorch path, the reference, the cell's own limits)."""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def small_cell(name: str, gaussians: int = 3000, width: int = 64,
               height: int = 48, bench: dict | None = None, here=None):
    """The cell ``name`` of ``BENCHMARK.json`` (or of ``bench``, its files
    found under ``here``) at a CPU test's size: the garden scene cut to
    ``gaussians``, the image to ``width`` x ``height``, six poses or four
    views, two traced units."""
    from benchmark import harness

    if bench is None:
        bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = harness.Cell(bench, name, here or harness.HERE)
    if cell.config["scene"]["kind"] == "garden":
        cell.config = dict(cell.config, gaussians=gaussians)
    mix = dict(cell.mix, width=width, height=height, trace_units=2)
    if "path" in mix:
        mix["path"] = dict(mix["path"], poses=6)
        mix["compare_frames"] = 2
    if "views" in mix:
        mix["views"] = dict(mix["views"], count=4)
    cell.mix = mix
    return cell


@pytest.fixture(autouse=True)
def _few_threads():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)

"""The 2D Gaussian Splatting cell (``train-gs2d3m-1297x840``, model
``models/gs2d.py``) on the CPU at ``conftest.small_cell``'s size: a sound
run is correct, and ``correct`` turns false with the bfloat16 control,
with a step that returns its state unchanged, and with each of four
faults planted in the program (the low-pass filter left out, the
distortion term left out, the normal term left out, the normals turned
away from the camera). The counts match a hand count on a one-surfel
scene, the new readers' shares stay under 100 %, and the new model,
reference and counts import nothing of the program outside the model's
program side."""

from __future__ import annotations

import ast
import sys

import numpy as np
import pytest
import torch

from conftest import ROOT, small_cell

from benchmark import faults, harness, readings
from benchmark.counts import gs2d as gcounts
from benchmark.reference import gs2d as ref2d
from benchmark.reference import render as rref

CELL = "train-gs2d3m-1297x840"
SEED = 2**31 + 91
CPU = torch.device("cpu")
CHECKS = {"loss_rel_gap", "grad_norm_gap", "delta_norm_gap", "maps_max_gap",
          "q_grad_max_gap"}


def _run(cell=None, fault=None, trace=False):
    cell = cell or small_cell(CELL)
    return harness.run_cell(cell, SEED, 0.3, trace, "cpu",
                            hooks=faults.hooks(fault) if fault else None)


def _caught(line):
    bad = [k for k, c in line["checks"].items() if c["value"] > c["limit"]]
    return line["correct"] is False and bool(bad)


def test_a_sound_surfel_run_is_correct():
    cell = small_cell(CELL)
    line = _run(cell, trace=True)
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["checks"]) == set(cell.limits) == CHECKS
    for c in line["checks"].values():
        assert c["value"] < 0.2 * c["limit"], line["checks"]
    c = line["info"]["traced"]["counts"]
    assert c["surfel_units"] == line["info"]["traced"]["units"] == 2
    assert "gs2d_step_mfu.train" in line["metrics"]


def test_the_control_fails():
    cell = small_cell(CELL)
    numbers = readings.control_train(cell, SEED, CPU)
    assert set(numbers) == CHECKS
    assert any(numbers[k] > lim for k, lim in cell.limits.items()), numbers
    assert numbers["maps_max_gap"] > cell.limits["maps_max_gap"], numbers


def test_a_step_that_returns_its_state_unchanged_is_caught():
    line = _run(fault="unchanged")
    assert line["correct"] is False
    assert line["checks"]["grad_norm_gap"]["value"] == pytest.approx(1.0)
    assert line["checks"]["q_grad_max_gap"]["value"] == pytest.approx(1.0)


def test_leaving_out_the_low_pass_filter_is_caught(monkeypatch):
    """S1 and S2's plain versions with the low-pass term gone (its 1 /
    sigma^2 so large that the intersection always wins)."""
    from gsplat_tpu_torch.ops import raster_surfel

    consts = raster_surfel._consts
    monkeypatch.setattr(raster_surfel, "_consts",
                        lambda cfg, sc: dict(consts(cfg, sc), F=1e30))
    line = _run()
    assert _caught(line), line["checks"]


@pytest.mark.parametrize("term", ["dist", "normal"])
def test_leaving_out_a_geometric_term_is_caught(monkeypatch, term):
    from gsplat_tpu_torch.train import trainer

    geo = trainer.geometry_loss

    def without(aux, fx, fy, cx, cy, surfel):
        _, parts = geo(aux, fx, fy, cx, cy, surfel)
        keep = "normal" if term == "dist" else "dist"
        weight = {"dist": surfel.lambda_dist,
                  "normal": surfel.lambda_normal}[keep]
        return weight * parts[keep], parts

    monkeypatch.setattr(trainer, "geometry_loss", without)
    line = _run()
    assert _caught(line), line["checks"]


def test_normals_turned_away_from_the_camera_are_caught(monkeypatch):
    from gsplat_tpu_torch.ops import rasterize

    plain = rasterize.rasterize_surfels

    def flipped(proj, rows, cfg, sc):
        return plain(proj, torch.cat([rows[:, :15], -rows[:, 15:]], dim=1),
                     cfg, sc)

    monkeypatch.setattr(sys.modules["gsplat_tpu_torch.render"],
                        "rasterize_surfels", flipped)
    line = _run()
    assert _caught(line), line["checks"]


def test_the_counts_match_a_hand_count_on_one_surfel():
    """One surfel facing the camera at depth 4: the reference's counts
    against a per-pixel loop of the alpha rule, and each work term from
    those counts."""
    H, W, f = 32, 48, 40.0
    p = {"pos": torch.tensor([[0.7, -0.05, 4.0]]),
         "scale_raw": torch.log(torch.tensor([[0.2, 0.1]])),
         "q_raw": torch.tensor([[0.0, 0.0, 0.0, 1.0]]),
         "opacity_raw": torch.tensor([1.0]),
         "f_dc": torch.zeros(1, 3), "f_rest": torch.zeros(1, 45)}
    cam = rref.Camera(np.eye(4, dtype=np.float32), f, f, W / 2, H / 2, H, W)
    rnd, sf = rref.Renderer(), ref2d.Surfels()
    _, c = ref2d.render(p, None, cam, rnd, sf, count_work=True)
    op = float(torch.sigmoid(torch.tensor(1.0)))
    u0, v0 = f * 0.7 / 4.0 + W / 2, f * -0.05 / 4.0 + H / 2
    su, sv = f * 0.2 / 4.0, f * 0.1 / 4.0  # the disc's pixel radii
    hits = 0
    for y in range(H):
        for x in range(W):
            rho3 = ((x - u0) / su) ** 2 + ((y - v0) / sv) ** 2
            rho2 = 2.0 * ((x - u0) ** 2 + (y - v0) ** 2)
            hits += min(op * np.exp(-0.5 * min(rho3, rho2)), 0.99) \
                >= rnd.alpha_cutoff
    r = np.ceil(max(3 * su, 3 * sv, 3 / np.sqrt(2)))  # the square footprint
    tiles = {(x // 16, y // 16)
             for y in range(int(np.floor(v0 - r)), int(np.floor(v0 + r)) + 1)
             for x in range(int(np.floor(u0 - r)), int(np.floor(u0 + r)) + 1)}
    assert c["gaussians"] == 1 and c["pairs"] == len(tiles) == 4
    assert c["pair_pixels"] == hits and c["contrib_pairs"] == 4
    assert c["live_pairs"] == 4 and c["pixels"] == H * W
    c = dict(c, slots=1, surfel_units=1)
    ops, nbytes = gcounts.s1_work(c)
    assert ops == 77 * hits
    assert nbytes == 4 * (12 * 4 + 6 * 4 + 12 * H * W)
    ops, nbytes = gcounts.s2_work(c)
    assert ops == 163 * hits
    assert nbytes == 4 * (12 * 4 + 24 * 4 + 21 * H * W)
    ops, nbytes = gcounts.step_work_2d(c)
    assert ops == (1200 + 240 * hits + 3 * 2 * 121 * 5 * 3 * H * W
                   + 160 * H * W + 12 * 58)
    assert nbytes == 4 * (58 + 6 * H * W + 58 + 7 * 58)


def _ctx(units=3, unit_s=0.1):
    """A traced stretch's context with a 3 M surfel view's counts and a
    device time for S1 and S2."""
    view = {"gaussians": 1095896, "pairs": 36821227, "live_pairs": 864961,
            "contrib_pairs": 370809, "pair_pixels": 72238897,
            "pixels": 1089480, "slots": 2959677, "surfel_units": 1}
    counts = {k: v * units for k, v in view.items()}

    class Tr:
        kernels = [("surfel_fwd_kernel", 0.0, 0.0006 * units),
                   ("surfel_bwd_kernel", 1.0, 0.0025 * units)]

        def kernel_time(self, match):
            return sum(d for n, _, d in self.kernels if match(n))
    return {"kind": "train", "units": units, "unit_s": unit_s,
            "counts": counts, "trace": Tr()}


@pytest.mark.parametrize("name", ["gs2d_s1_roofline.train",
                                  "gs2d_s2_roofline.train",
                                  "gs2d_step_mfu.train"])
def test_the_shares_stay_under_100(name):
    read = harness.load_reader(name).read
    got = read(_ctx())
    assert 0 < got["value"] < 100, got
    assert got["bound"] in ("operations", "bytes")
    plain = _ctx()
    plain["counts"] = {k: v for k, v in plain["counts"].items()
                       if k != "surfel_units"}
    assert read(plain) is None  # not a surfel cell
    assert read(dict(_ctx(), kind="serve")) is None


def test_the_new_files_import_nothing_of_the_program():
    import test_bench_isolation as iso

    model = ROOT / "benchmark" / "models" / "gs2d.py"
    assert model in iso.MODELS
    for path in (model, ROOT / "benchmark" / "reference" / "gs2d.py",
                 ROOT / "benchmark" / "counts" / "gs2d.py"):
        assert not iso._loads_the_program(iso._top_level_imports(path)), path
    ref = ROOT / "benchmark" / "reference" / "gs2d.py"
    for node in ast.walk(ast.parse(ref.read_text())):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            for m in iso._imported(ref, node):
                assert m.split(".")[0] in ("torch", "math", "dataclasses",
                                           "__future__") \
                    or m.startswith("benchmark.reference"), m

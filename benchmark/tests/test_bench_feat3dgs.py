"""The Feature 3DGS cell (``train-feat3dgs3m-1297x840``, model
``models/feat3dgs.py``) on the CPU at ``conftest.small_cell``'s size: a
sound run is correct, and ``correct`` turns false with gs3d's reference
in the model's place, with the bfloat16 control, with a step that
returns its state unchanged, and with two faults planted in the
program's feature compositors (the features' part of the alpha gradient
dropped; features read from the wrong gaussian). The new model,
reference and counts import nothing of the program outside the model's
program side, and the new readers' shares stay under 100 %."""

from __future__ import annotations

import ast

import pytest
import torch

from conftest import ROOT, small_cell

from benchmark import faults, harness, readings
from benchmark.counts import feat3dgs as fcounts
from benchmark.reference import render as rref

CELL = "train-feat3dgs3m-1297x840"
SEED = 2**31 + 77
CPU = torch.device("cpu")


def _run(cell=None, fault=None, trace=False):
    cell = cell or small_cell(CELL)
    return harness.run_cell(cell, SEED, 0.3, trace, "cpu",
                            hooks=faults.hooks(fault) if fault else None)


def _caught(line):
    bad = [k for k, c in line["checks"].items() if c["value"] > c["limit"]]
    return line["correct"] is False and bool(bad)


@pytest.mark.parametrize("trace", [False, True])
def test_a_sound_feature_run_is_correct(trace):
    cell = small_cell(CELL)
    line = _run(cell, trace=trace)
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["checks"]) == set(cell.limits) == {
        "loss_rel_gap", "grad_norm_gap", "delta_norm_gap",
        "fsem_grad_max_gap"}
    for c in line["checks"].values():
        assert c["value"] < 0.2 * c["limit"], line["checks"]
    if trace:
        c = line["info"]["traced"]["counts"]
        assert c["channels"] == 128 * line["info"]["traced"]["units"]
        assert {"teacher_pixels", "decoder_params", "pair_pixels"} <= set(c)
        assert "feat_step_mfu.train" in line["metrics"]


def test_gs3d_reference_in_its_place_fails(monkeypatch):
    """gs3d's reference (the frame's L1 + D-SSIM alone, no features) in
    place of the model's loss and gradients."""
    cell = small_cell(CELL)
    model = cell.model

    def gs3d_loss_grad(cell, params, alive, cam, target, dtype=torch.float32):
        t = cell.mix["train"]
        g6 = {k: v for k, v in params.items()
              if k not in ("f_sem", "dec_w", "dec_b")}
        loss, grads = rref.render_grad(
            g6, alive, cam, rref.Renderer.from_config(cell.config["render"]),
            rref.photo_loss(target[0], t["lambda_l1"], t["lambda_ssim"]),
            dtype=dtype)
        grads.update({k: torch.zeros_like(params[k])
                      for k in ("f_sem", "dec_w", "dec_b")})
        return loss, grads

    monkeypatch.setattr(model, "loss_grad", gs3d_loss_grad)
    line = _run(cell)
    assert _caught(line), line["checks"]
    assert line["checks"]["loss_rel_gap"]["value"] > 0.01


def test_the_control_fails():
    cell = small_cell(CELL)
    numbers = readings.control_train(cell, SEED, CPU)
    assert any(numbers[k] > lim for k, lim in cell.limits.items()), numbers


def test_a_step_that_returns_its_state_unchanged_is_caught():
    line = _run(fault="unchanged")
    assert line["correct"] is False
    assert line["checks"]["grad_norm_gap"]["value"] == pytest.approx(1.0)
    assert line["checks"]["fsem_grad_max_gap"]["value"] == pytest.approx(1.0)


def test_dropping_the_features_alpha_term_is_caught(monkeypatch):
    """F2 without its geometry part: the features' alpha gradient never
    reaches u, v, the conic and the opacity."""
    from gsplat_tpu_torch.ops import raster_feat

    plain = raster_feat.composite_features_bwd_plain

    def dropped(*args):
        *head, dgeo, cfg = args
        return plain(*head, dgeo.clone(), cfg)

    monkeypatch.setattr(raster_feat, "composite_features_bwd_plain", dropped)
    line = _run()
    assert _caught(line), line["checks"]


def test_features_read_from_the_wrong_gaussian_are_caught(monkeypatch):
    """F1 and F2 read each pair's feature row one gaussian off."""
    from gsplat_tpu_torch.ops import raster_feat

    rows = raster_feat._pair_rows

    def shifted(f_sem, depth_order, pair_slot):
        return rows(f_sem, torch.roll(depth_order, 1), pair_slot)

    monkeypatch.setattr(raster_feat, "_pair_rows", shifted)
    line = _run()
    assert _caught(line), line["checks"]
    assert line["checks"]["fsem_grad_max_gap"]["value"] > 0.1


def test_the_new_files_import_nothing_of_the_program():
    import test_bench_isolation as iso

    model = ROOT / "benchmark" / "models" / "feat3dgs.py"
    assert model in iso.MODELS
    for path in (model, ROOT / "benchmark" / "reference" / "feat3dgs.py",
                 ROOT / "benchmark" / "counts" / "feat3dgs.py"):
        assert not iso._loads_the_program(iso._top_level_imports(path)), path
    ref = ROOT / "benchmark" / "reference" / "feat3dgs.py"
    for node in ast.walk(ast.parse(ref.read_text())):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            for m in iso._imported(ref, node):
                assert m.split(".")[0] in ("torch", "math", "__future__") \
                    or m.startswith("benchmark.reference"), m


def _ctx(units=3, unit_s=0.1):
    """A traced stretch's context with a 3 M training view's counts (as
    the reference counts them at the cell's size) and a device time for
    F1 and F2."""
    view = {"gaussians": 1186614, "pairs": 29017148, "live_pairs": 365482,
            "contrib_pairs": 285515, "pair_pixels": 57274421,
            "pixels": 1089480, "slots": 2959677, "channels": 128,
            "teacher_pixels": 420 * 648, "decoder_params": 512 * 129}
    counts = {k: v * units for k, v in view.items()}

    class Tr:
        kernels = [("feat_fwd_kernel", 0.0, 0.002 * units),
                   ("feat_bwd_kernel", 1.0, 0.005 * units)]

        def kernel_time(self, match):
            return sum(d for n, _, d in self.kernels if match(n))
    return {"kind": "train", "units": units, "unit_s": unit_s,
            "counts": counts, "trace": Tr()}


@pytest.mark.parametrize("name", ["feat_k1_roofline.train",
                                  "feat_k2_roofline.train",
                                  "feat_step_mfu.train"])
def test_the_shares_stay_under_100(name):
    read = harness.load_reader(name).read
    got = read(_ctx())
    assert 0 < got["value"] < 100, got
    assert got["bound"] in ("operations", "bytes")
    plain = _ctx()
    plain["counts"] = {k: v for k, v in plain["counts"].items()
                       if k != "channels"}
    assert read(plain) is None  # a cell without features
    assert read(dict(_ctx(), kind="serve")) is None


def test_the_counts_term_by_term():
    c = _ctx(units=2)["counts"]
    C, D = fcounts._per_unit(c, 2)
    assert (C, D) == (128, 512)
    ops, nbytes = fcounts.f1_work(c, 2)
    assert ops == 2 * 128 * c["pair_pixels"]
    assert nbytes == 4 * 128 * (c["contrib_pairs"] + c["pixels"])
    ops, _ = fcounts.f2_work(c, 2)
    assert ops == 4 * 128 * c["pair_pixels"]
    ops, _ = fcounts.decoder_work(c, 2)
    assert ops == 6 * 128 * 512 * c["teacher_pixels"]
    from benchmark import counts
    assert fcounts.step_work_feat(c, 2)[0] > counts.step_work(c)[0]


def test_the_feature_cells_stages_leave_out_every_compositor():
    """``feat_stages_device_ms.train`` merges every kernel but K1 (with
    its tile order), K2, F1 and F2, a view; without F1 on the path it
    reads nothing."""
    read = harness.load_reader("feat_stages_device_ms.train").read
    ctx = _ctx(units=2)
    ctx["trace"].kernels = ctx["trace"].kernels + [
        ("raster_fwd_kernel", 2.0, 0.5), ("tile_order_kernel", 2.5, 0.5),
        ("raster_bwd_kernel", 3.0, 0.5), ("elementwise_kernel", 4.0, 0.03),
        ("adam_kernel", 5.0, 0.01)]
    assert read(ctx) == pytest.approx(0.04 * 1e3 / 2)
    ctx["trace"].kernels = [k for k in ctx["trace"].kernels
                            if k[0] != "feat_fwd_kernel"]
    assert read(ctx) is None
    assert read(dict(_ctx(), kind="serve")) is None

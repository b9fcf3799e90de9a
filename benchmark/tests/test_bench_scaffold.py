"""The Scaffold-GS cell (``train-scaffold650k-1297x840``, model
``models/scaffold.py``) on the CPU at ``conftest.small_cell``'s size (a few
hundred anchors): a sound run is correct, and ``correct`` turns false with
the bfloat16 control, with a step that returns its state unchanged, and
with the colour head's sigmoid dropped in the program's decode. The
counts match a hand count on a three-anchor scene, the new readers'
shares stay under 100 %, and the new model, reference and counts import
nothing of the program outside the model's program side."""

from __future__ import annotations

import ast

import numpy as np
import pytest
import torch

from conftest import ROOT, small_cell

from benchmark import faults, harness, readings
from benchmark.counts import scaffold as scounts
from benchmark.reference import render as rref
from benchmark.reference import scaffold as refsc

CELL = "train-scaffold650k-1297x840"
SEED = 2**31 + 93
CPU = torch.device("cpu")
ANCHORS = 400
CHECKS = {"loss_rel_gap", "grad_norm_gap", "delta_norm_gap",
          "decode_max_gap", "mlp_grad_max_gap"}


def _cell():
    cell = small_cell(CELL)
    cell.config = dict(cell.config, anchors=ANCHORS)
    return cell


def _run(cell=None, fault=None, trace=False):
    cell = cell or _cell()
    return harness.run_cell(cell, SEED, 0.3, trace, "cpu",
                            hooks=faults.hooks(fault) if fault else None)


def test_a_sound_scaffold_run_is_correct():
    cell = _cell()
    line = _run(cell, trace=True)
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["checks"]) == set(cell.limits) == CHECKS
    for c in line["checks"].values():
        assert c["value"] < 0.2 * c["limit"], line["checks"]
    c = line["info"]["traced"]["counts"]
    assert c["scaffold_units"] == line["info"]["traced"]["units"] == 2
    assert c["anchors"] == 2 * ANCHORS and 0 < c["visible_anchors"]
    assert 0 < c["kept_slots"] <= 10 * c["visible_anchors"]
    assert "scaffold_step_mfu.train" in line["metrics"]


def test_the_control_fails():
    cell = _cell()
    numbers = readings.control_train(cell, SEED, CPU)
    assert set(numbers) == CHECKS
    assert numbers["decode_max_gap"] > cell.limits["decode_max_gap"], numbers


def test_a_step_that_returns_its_state_unchanged_is_caught():
    line = _run(fault="unchanged")
    assert line["correct"] is False
    assert line["checks"]["grad_norm_gap"]["value"] == pytest.approx(1.0)
    assert line["checks"]["mlp_grad_max_gap"]["value"] == pytest.approx(1.0)


def test_dropping_the_colour_heads_sigmoid_is_caught(monkeypatch):
    """The program's plain decode with its colours before the sigmoid:
    ``decode_max_gap`` sees the colour field."""
    from gsplat_tpu_torch.ops import scaffold

    plain = scaffold.decode_plain

    def no_sigmoid(params, visible, cam):
        out = list(plain(params, visible, cam))
        out[4] = torch.logit(out[4])
        return tuple(out)

    monkeypatch.setattr(scaffold, "decode_plain", no_sigmoid)
    line = _run()
    assert line["correct"] is False
    assert line["checks"]["decode_max_gap"]["value"] > \
        line["checks"]["decode_max_gap"]["limit"]


def test_the_counts_match_a_hand_count_on_three_anchors():
    """Three anchors: one in view with every slot forced to opacity
    tanh(1) > 0, one behind the camera, one far to the side. The reference's
    anchor and slot counts against the scene's construction, and each work
    term from those counts."""
    H, W, f = 32, 48, 40.0
    sc = refsc.Scaffold()
    g = torch.Generator().manual_seed(5)
    mlps = refsc.init_mlps(sc, g, "cpu")
    shape = refsc.mlp_shapes(sc)["mlp_opacity"]
    i, h, o = shape
    w = mlps["mlp_opacity"].clone()
    w[h * i + h:h * i + h + o * h] = 0.0  # W2 = 0: every output is b2
    w[h * i + h + o * h:] = 1.0
    mlps["mlp_opacity"] = w
    p = {"pos": torch.tensor([[0.1, 0.0, 4.0], [0.0, 0.0, -4.0],
                              [40.0, 0.0, 4.0]]),
         "offset": 0.1 * torch.randn(3, 30, generator=g),
         "anchor_feat": torch.randn(3, 32, generator=g),
         "scale_raw": torch.full((3, 6), -2.0), **mlps}
    cam = rref.Camera(np.eye(4, dtype=np.float32), f, f, W / 2, H / 2, H, W)
    _, c = refsc.render(p, None, cam, rref.Renderer(), sc, count_work=True)
    assert c["anchors"] == 3 and c["visible_anchors"] == 1
    assert c["kept_slots"] == 10 and c["gaussians"] == 10
    assert c["pixels"] == H * W and c["pair_pixels"] > 0
    c = dict(c, scaffold_units=1)
    ops, nbytes = scounts.d1_work(c)
    assert ops == 13760 + 610
    assert nbytes == 4 * (71 + 140) + 10 + 10 * 2 + 4 * 7086
    ops, nbytes = scounts.d2_work(c)
    assert ops == 2 * 13760
    assert nbytes == 4 * (14 * 10 + 139 + 2 * 7086)
    ops, nbytes = scounts.step_work_scaffold(c)
    params = 68 * 3 + 7086
    assert ops == (13760 + 610 + 2 * 13760 + 3 * 255 * 10
                   + 105 * c["pair_pixels"] + 3 * 2 * 121 * 5 * 3 * H * W
                   + 9 * 10 + 12 * params)
    assert nbytes == 4 * (2 * 71 + 6 * H * W + 7 * params)


def _ctx(units=3, unit_s=0.064):
    """A traced stretch's context with a 650 k anchor view's counts and a
    device time for D1 and D2."""
    view = {"gaussians": 1476767, "pairs": 12518996, "live_pairs": 1045242,
            "contrib_pairs": 833907, "pair_pixels": 141096175,
            "pixels": 1089480, "anchors": 650000, "visible_anchors": 251148,
            "kept_slots": 1545612, "scaffold_units": 1}
    counts = {k: v * units for k, v in view.items()}

    class Tr:
        kernels = [("scaffold_d1_kernel", 0.0, 0.0007 * units),
                   ("scaffold_d2_kernel", 1.0, 0.0025 * units),
                   ("scaffold_reduce_kernel", 2.0, 0.00001 * units)]

        def kernel_time(self, match):
            return sum(d for n, _, d in self.kernels if match(n))
    return {"kind": "train", "units": units, "unit_s": unit_s,
            "counts": counts, "trace": Tr()}


@pytest.mark.parametrize("name", ["scaffold_d1_roofline.train",
                                  "scaffold_d2_roofline.train",
                                  "scaffold_step_mfu.train"])
def test_the_shares_stay_under_100(name):
    read = harness.load_reader(name).read
    got = read(_ctx())
    assert 0 < got["value"] < 100, got
    assert got["bound"] in ("operations", "bytes")
    plain = _ctx()
    plain["counts"] = {k: v for k, v in plain["counts"].items()
                       if k != "scaffold_units"}
    assert read(plain) is None  # not a Scaffold-GS cell
    assert read(dict(_ctx(), kind="serve")) is None


def test_the_new_files_import_nothing_of_the_program():
    import test_bench_isolation as iso

    model = ROOT / "benchmark" / "models" / "scaffold.py"
    assert model in iso.MODELS
    for path in (model, ROOT / "benchmark" / "reference" / "scaffold.py",
                 ROOT / "benchmark" / "counts" / "scaffold.py"):
        assert not iso._loads_the_program(iso._top_level_imports(path)), path
    ref = ROOT / "benchmark" / "reference" / "scaffold.py"
    for node in ast.walk(ast.parse(ref.read_text())):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            for m in iso._imported(ref, node):
                assert m.split(".")[0] in ("torch", "math", "dataclasses",
                                           "__future__") \
                    or m.startswith("benchmark.reference"), m

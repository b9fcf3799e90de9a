"""The plain reference against the program's CPU path at a small size:
the same frame, the same gradients, the same three training steps. The
test imports both; the reference imports nothing of the program."""

from __future__ import annotations

import pytest
import torch

from conftest import ROOT  # noqa: F401

from benchmark import poses, scenes
from benchmark.reference import compare
from benchmark.reference import render as ref

W, H = 64, 48
RND = ref.Renderer()


def _scene(n=2000, seed=3):
    return scenes.garden(n, seed, torch.device("cpu"))


def _cam(c2w):
    return ref.Camera(c2w, 0.85 * W, 0.85 * W, W / 2, H / 2, H, W)


def _port_cfg():
    from gsplat_tpu_torch.config import RenderConfig
    return RenderConfig(height=H, width=W, max_pairs=2**16)


@pytest.mark.parametrize("yaw", [0.0, 0.2])
def test_frame_matches_the_program(yaw):
    from gsplat_tpu_torch.render import render_from_params

    params = _scene()
    c2w = poses.origin_pose(0.1, -0.05, 0.2, yaw)
    with torch.no_grad():
        img, _ = render_from_params(params, c2w, 0.85 * W, 0.85 * W, W / 2,
                                    H / 2, _port_cfg())
    want, c = ref.render(params, None, _cam(c2w), RND, count_work=True)
    assert c["pairs"] > 1000
    assert float((img - want).abs().max()) < 1e-5


def test_gradients_match_the_program():
    from gsplat_tpu_torch.render import render_from_params

    params = _scene()
    c2w = poses.origin_pose(0.0, 0.0, 0.0, 0.1)
    target = torch.rand(H, W, 3, generator=torch.Generator().manual_seed(0))
    loss_fn = ref.photo_loss(target)
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    img, _ = render_from_params(leaves, c2w, 0.85 * W, 0.85 * W, W / 2,
                                H / 2, _port_cfg())
    loss = loss_fn(img)
    loss.backward()
    ref_loss, grads = ref.render_grad(params, None, _cam(c2w), RND, loss_fn)
    assert float(loss.detach()) == pytest.approx(ref_loss, rel=1e-6)
    for k, g in grads.items():
        got = leaves[k].grad
        scale = float(g.abs().max())
        assert scale > 0, k
        assert float((got - g).abs().max()) <= 1e-4 * scale, k


def test_train_numbers_are_zero_for_equal_runs_and_one_for_no_update():
    g = {"a": torch.tensor([1.0, 0.0, 2.0]), "b": torch.tensor([0.5])}
    d = {"a": torch.tensor([0.1, 0.3, -0.2]), "b": torch.tensor([0.4])}
    same = compare.train_numbers([1.0, 2.0], [1.0, 2.0], g, g, d, d)
    assert same == {"loss_rel_gap": 0.0, "grad_norm_gap": 0.0,
                    "delta_norm_gap": 0.0}
    zero = {k: torch.zeros_like(v) for k, v in d.items()}
    none = compare.train_numbers([1.0], [1.0], zero, g, zero, d)
    assert none["grad_norm_gap"] == pytest.approx(1.0)
    assert none["delta_norm_gap"] == pytest.approx(1.0)
    # An element the reference does not move is left out of the change.
    d2 = {"a": torch.tensor([0.1, 9.0, -0.2]), "b": torch.tensor([0.4])}
    assert compare.train_numbers([1.0], [1.0], g, g, d2, d)[
        "delta_norm_gap"] == 0.0


def test_frame_numbers():
    a = torch.zeros(4, 4, 3)
    b = a.clone()
    b[0, 0, 0] = 0.5
    n = compare.frame_numbers([(a, b)])
    assert n["frame_max_abs"] == 0.5
    assert n["frame_mean_abs"] == pytest.approx(0.5 / 48)
    b[1, 1, 1] = float("nan")
    assert compare.frame_numbers([(a, b)])["frame_max_abs"] == float("inf")

"""The work counts on a scene counted by hand: two tiny gaussians, one
behind the other, each covering only the pixel at its centre."""

from __future__ import annotations

import math

import pytest
import torch

from conftest import ROOT  # noqa: F401

from benchmark import counts
from benchmark.reference import render as ref


def _two_dots(opacity=0.5):
    """Gaussians at depth 5 and 6 on the optical axis, scale 1e-3 (0.01 px
    at focal 50): alpha = opacity at pixel (8, 8), zero at every other."""
    raw = math.log(opacity / (1 - opacity))
    n = 2
    return {
        "pos": torch.tensor([[0.0, 0.0, 5.0], [0.0, 0.0, 6.0]]),
        "scale_raw": torch.full((n, 3), math.log(1e-3)),
        "q_raw": torch.tensor([[0.0, 0.0, 0.0, 1.0]] * n),
        "opacity_raw": torch.full((n,), raw),
        "f_dc": torch.tensor([[1.0, 0.0, -1.0], [0.0, 2.0, 0.0]]),
        "f_rest": torch.zeros(n, 45),
    }


CAM = ref.Camera(torch.eye(4), 50.0, 50.0, 8.0, 8.0, 32, 32)
SMALL = ref.Camera(torch.eye(4), 50.0, 50.0, 8.0, 8.0, 16, 16)


def test_counts_of_two_dots():
    p = _two_dots()
    img, c = ref.render(p, None, CAM, ref.Renderer(), count_work=True)
    assert c == {"gaussians": 2, "pairs": 2, "live_pairs": 2,
                 "contrib_pairs": 2, "pair_pixels": 2, "pixels": 32 * 32}
    # The pixel: the front colour at alpha 0.5, the back one at 0.5 x 0.5.
    rgb = torch.sigmoid(ref.SH_C0 * p["f_dc"])
    assert torch.allclose(img[8, 8], 0.5 * rgb[0] + 0.25 * rgb[1])
    assert float(img.sum()) == pytest.approx(float(img[8, 8].sum()))


def test_a_saturated_pixel_stops_the_count():
    # Opacity 0.999 is clamped to alpha 0.99: 3 fronts leave T = 1e-6 <
    # 5e-5 at pixel (8, 8), so a fourth dot behind them adds no weight.
    # Its pair stays live: the tile's other pixels are not saturated.
    p = _two_dots(0.999)
    q = {k: torch.cat([v, v]) for k, v in p.items()}
    q["pos"] = torch.tensor([[0.0, 0.0, z] for z in (5.0, 6.0, 7.0, 8.0)])
    _, c = ref.render(q, None, CAM, ref.Renderer(), count_work=True)
    assert c["pairs"] == 4
    assert c["live_pairs"] == 4 and c["contrib_pairs"] == 3
    assert c["pair_pixels"] == 3


def test_a_saturated_tile_stops_the_live_count():
    # Dots covering every pixel of the only tile, opaque: once the tile
    # saturates, the pairs behind are no longer live.
    n = 6
    p = {
        "pos": torch.tensor([[0.0, 0.0, 5.0 + i] for i in range(n)]),
        "scale_raw": torch.full((n, 3), math.log(10.0)),
        "q_raw": torch.tensor([[0.0, 0.0, 0.0, 1.0]] * n),
        "opacity_raw": torch.full((n,), 10.0),
        "f_dc": torch.zeros(n, 3),
        "f_rest": torch.zeros(n, 45),
    }
    _, c = ref.render(p, None, SMALL, ref.Renderer(), count_work=True)
    assert c["pairs"] == n
    assert c["live_pairs"] == 3 and c["contrib_pairs"] == 3
    assert c["pair_pixels"] == 3 * 256


def test_work_and_speed_of_light():
    c = {"gaussians": 2, "pairs": 2, "live_pairs": 2, "contrib_pairs": 2,
         "pair_pixels": 2, "pixels": 1024, "slots": 2}
    ops, nbytes = counts.k1_work(c)
    assert ops == 26 * 2
    assert nbytes == 4 * (6 * 2 + 4 * 2 + 5 * 1024)
    ops, nbytes = counts.k2_work(c)
    assert ops == 79 * 2
    assert nbytes == 4 * (6 * 2 + 14 * 2 + 9 * 1024)
    ops, nbytes = counts.frame_work(c)
    assert ops == 400 * 2 + 26 * 2
    assert nbytes == 4 * (59 * 2 + 3 * 1024)
    t, bound = counts.sol(67e12, 1.0)
    assert t == pytest.approx(1.0) and bound == "operations"
    t, bound = counts.sol(0.0, 3.35e12)
    assert t == pytest.approx(1.0) and bound == "bytes"
    assert counts.add([c, c])["pairs"] == 4

"""The traffic generator: the same seed gives the same poses, every pose
stays inside its mix's ranges, and the seed moves only the start and the
order."""

from __future__ import annotations

import json

import numpy as np
import pytest

from conftest import ROOT

from benchmark import poses

MIXES = sorted((ROOT / "benchmark" / "traffic").glob("*.json"))


def _mix(path):
    return json.loads(path.read_text())


def _layout(mix, center=np.zeros(3, np.float32), radius=4.0):
    if mix["kind"] == "serve":
        return mix["path"], poses.path_poses(mix["path"], center, radius)
    return mix["views"], poses.view_poses(mix["views"], center, radius)


@pytest.mark.parametrize("path", MIXES, ids=lambda p: p.stem)
def test_layout_is_fixed_by_the_mix(path):
    mix = _mix(path)
    spec, a = _layout(mix)
    _, b = _layout(mix)
    assert np.array_equal(a, b)
    n = spec["poses"] if mix["kind"] == "serve" else spec["count"]
    assert a.shape == (n, 4, 4) and a.dtype == np.float32
    # Rotations stay orthonormal.
    R = a[:, :3, :3].astype(np.float64)
    assert np.allclose(R @ R.transpose(0, 2, 1), np.eye(3), atol=1e-5)


@pytest.mark.parametrize("path", MIXES, ids=lambda p: p.stem)
def test_poses_stay_inside_their_ranges(path):
    mix = _mix(path)
    center, radius = np.array([0.5, -0.2, 3.0], np.float32), 4.0
    spec, c2w = _layout(mix, center, radius)
    t = c2w[:, :3, 3].astype(np.float64)
    eps = 1e-4
    if spec["frame"] == "orbit":
        off = t - center
        dist = np.linalg.norm(off, axis=1) / radius
        elev = np.rad2deg(np.arcsin(-off[:, 1] / np.linalg.norm(off, axis=1)))
        if mix["kind"] == "serve":
            lo = spec["distance"] * (1 - spec["wobble"])
            hi = spec["distance"] * (1 + spec["wobble"])
        else:
            lo, hi = spec["distance"]
        assert np.all(dist >= lo - eps) and np.all(dist <= hi + eps)
        e0, e1 = spec["elev_deg"]
        assert np.all(elev >= e0 - eps) and np.all(elev <= e1 + eps)
        # Each camera looks at the centre.
        fwd = c2w[:, :3, 2]
        to_c = (center - t) / np.linalg.norm(center - t, axis=1)[:, None]
        assert np.allclose(fwd, to_c, atol=1e-5)
    else:
        for k, col in (("x", 0), ("y", 1), ("z", 2)):
            lo, hi = spec[k]
            assert np.all(t[:, col] >= lo - eps) and np.all(t[:, col] <= hi + eps)
        yaw = np.arctan2(c2w[:, 0, 2], c2w[:, 0, 0])
        assert np.all(yaw >= spec["yaw"][0] - eps)
        assert np.all(yaw <= spec["yaw"][1] + eps)


def test_seed_moves_start_order_and_sample_only():
    big = 2**31 + 12345  # seeds may exceed 32 signed bits
    assert poses.start(120, big) == poses.start(120, big)
    assert 0 <= poses.start(120, big) < 120
    starts = {poses.start(120, s) for s in range(50)}
    assert len(starts) > 10
    order = poses.view_order(8, big)
    assert sorted(order.tolist()) == list(range(8))
    assert np.array_equal(order, poses.view_order(8, big))
    s = poses.sample(8, 120, big)
    assert s == poses.sample(8, 120, big)
    assert len(set(s)) == 8 and all(0 <= i < 120 for i in s)
    assert poses.sample(8, 5, big) == [0, 1, 2, 3, 4]


def test_intrinsics_and_scene_center():
    fx, fy, cx, cy = poses.intrinsics({"width": 1920, "height": 1080,
                                       "focal": 0.85})
    assert (fx, fy, cx, cy) == (1632.0, 1632.0, 960.0, 540.0)
    pts = np.random.default_rng(0).normal(size=(1000, 3)) * 0.1 + 7.0
    c, r = poses.scene_center_radius(pts)
    assert np.allclose(c, 7.0, atol=0.05) and r == 3.0  # clamped at 3

"""The general traffic generator: poses and views from a mix's data file
(``traffic/<mix>.json``) and the seed.

A mix gives the image size, the focal length over the width, and a
``path`` (serving: a closed path the viewer follows, frame after frame)
or ``views`` (training: the cameras a step draws from). The path and the
views are drawn once from the mix's own ``layout_seed``, so that every
run's seed gives the same set of poses: the run's seed picks where the
viewer starts on the path (``start``) and the order in which steps cycle
through the views (``view_order``). Each has a ``frame``, which says what
the numbers are relative to:

* ``"orbit"``: a camera looking at the scene centre from ``distance`` x R
  (centre and R from the scene's gaussians, ``scene_center_radius``),
  at an elevation above the scene (towards -y, the scene's up);
* ``"origin"``: the camera at the origin looking down +z, moved by
  (x, y, z) and turned by ``yaw`` about y.

``look_at`` and ``scene_center_radius`` are frozen copies of
``gsplat_tpu_torch/viewer.py``'s ``look_at`` and
``estimate_scene_center_radius`` (positions branch); the orbit's camera
offset is the bench pose's (``gsplat_tpu_torch/profile_stages.py::
bench_pose``: ``center + (0, -0.6R, -4.4R)`` is yaw 0 here).
"""

from __future__ import annotations

import numpy as np


def rng_for(seed: int, stream: str) -> np.random.Generator:
    """An independent generator per use of the seed."""
    return np.random.default_rng([abs(int(seed)) % 2**63,
                                  int.from_bytes(stream.encode(), "little")
                                  % 2**63])


def look_at(position, target, up=(0.0, 1.0, 0.0)) -> np.ndarray:
    position = np.asarray(position, np.float64)
    forward = np.asarray(target, np.float64) - position
    forward = forward / (np.linalg.norm(forward) + 1e-12)
    right = np.cross(forward, np.asarray(up, np.float64))
    right = right / (np.linalg.norm(right) + 1e-12)
    cam_up = np.cross(right, forward)
    c2w = np.eye(4)
    c2w[:3, 0] = right
    c2w[:3, 1] = -cam_up
    c2w[:3, 2] = forward
    c2w[:3, 3] = position
    return c2w.astype(np.float32)


def scene_center_radius(positions: np.ndarray):
    """Median centre and 1.5 x the 90th-percentile distance, clamped to
    [3, 20]."""
    pts = np.asarray(positions, np.float64)
    center = np.median(pts, axis=0)
    r = np.linalg.norm(pts - center, axis=1)
    return center.astype(np.float32), float(
        np.clip(1.5 * np.percentile(r, 90.0), 3.0, 20.0))


def orbit_pose(center, radius, distance, elev_deg, yaw):
    el = np.deg2rad(elev_deg)
    off = distance * radius * np.array(
        [np.cos(el) * np.sin(yaw), -np.sin(el), -np.cos(el) * np.cos(yaw)])
    return look_at(np.asarray(center, np.float64) + off, center)


def origin_pose(x, y, z, yaw):
    c2w = np.eye(4, dtype=np.float32)
    c, s = np.cos(yaw), np.sin(yaw)
    c2w[0, 0] = c2w[2, 2] = c
    c2w[0, 2] = s
    c2w[2, 0] = -s
    c2w[:3, 3] = [x, y, z]
    return c2w


def _lerp(lo_hi, t):
    lo, hi = lo_hi
    return lo + (hi - lo) * t


def path_poses(spec: dict, center=None, radius=None):
    """[n, 4, 4] c2w of a closed path (the last pose leads back to the
    first). ``orbit``: yaw from a seeded start, ``step_deg`` a frame
    (a whole turn over the path), distance ``distance`` x (1 +
    ``wobble`` sin(yaw)), elevation a sinusoid of ``elev_cycles`` periods
    a turn between ``elev_deg`` with a seeded phase. ``origin``: each of
    x, y, z, yaw a sinusoid of one period over the path between its range,
    with a seeded phase (all from ``layout_seed``)."""
    rng = rng_for(spec["layout_seed"], "path")
    n = int(spec["poses"])
    t = np.arange(n) / n
    if spec["frame"] == "orbit":
        yaw = rng.uniform(0, 2 * np.pi) + np.deg2rad(spec["step_deg"]) \
            * np.arange(n)
        ph = rng.uniform(0, 2 * np.pi)
        elev = _lerp(spec["elev_deg"], 0.5 + 0.5 * np.sin(
            2 * np.pi * spec["elev_cycles"] * t + ph))
        dist = spec["distance"] * (1 + spec["wobble"] * np.sin(yaw))
        return np.stack([orbit_pose(center, radius, d, e, y)
                         for d, e, y in zip(dist, elev, yaw)])
    if spec["frame"] == "origin":
        axes = {}
        for k in ("x", "y", "z", "yaw"):
            ph = rng.uniform(0, 2 * np.pi)
            axes[k] = _lerp(spec[k], 0.5 + 0.5 * np.sin(2 * np.pi * t + ph))
        return np.stack([origin_pose(axes["x"][i], axes["y"][i],
                                     axes["z"][i], axes["yaw"][i])
                         for i in range(n)])
    raise ValueError(f"unknown path frame {spec['frame']!r}")


def view_poses(spec: dict, center=None, radius=None):
    """[n, 4, 4] c2w of ``count`` training cameras drawn uniformly in the
    ranges. ``orbit``: ``distance``, ``elev_deg``, yaw over the whole
    turn. ``origin``: x, y, z, yaw (all from ``layout_seed``)."""
    rng = rng_for(spec["layout_seed"], "views")
    n = int(spec["count"])
    if spec["frame"] == "orbit":
        d = rng.uniform(*spec["distance"], n)
        e = rng.uniform(*spec["elev_deg"], n)
        y = rng.uniform(0, 2 * np.pi, n)
        return np.stack([orbit_pose(center, radius, d[i], e[i], y[i])
                         for i in range(n)])
    if spec["frame"] == "origin":
        v = {k: rng.uniform(*spec[k], n) for k in ("x", "y", "z", "yaw")}
        return np.stack([origin_pose(v["x"][i], v["y"][i], v["z"][i],
                                     v["yaw"][i]) for i in range(n)])
    raise ValueError(f"unknown views frame {spec['frame']!r}")


def start(n_poses: int, seed: int) -> int:
    """Where on a closed path of ``n_poses`` the run's viewer starts."""
    return int(rng_for(seed, "start").integers(n_poses))


def view_order(n_views: int, seed: int) -> np.ndarray:
    """The seeded order in which steps cycle through the views."""
    return rng_for(seed, "order").permutation(n_views)


def sample(count: int, population: int, seed: int) -> list:
    """``count`` distinct indices of ``range(population)``, from the seed:
    the frames compared."""
    k = min(count, population)
    return sorted(int(i) for i in rng_for(seed, "compare").choice(
        population, size=k, replace=False))


def intrinsics(mix: dict):
    """(fx, fy, cx, cy) of a mix: fx = fy = ``focal`` x W, centred."""
    W, H = mix["width"], mix["height"]
    f = mix["focal"] * W
    return f, f, W / 2.0, H / 2.0

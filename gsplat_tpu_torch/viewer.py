"""Inference-time rendering: orbit trajectories and a timed serving loop.

Counterpart of ``gsplat_tpu/viewer.py``: ``look_at``,
``create_orbit_trajectory``, ``estimate_scene_center_radius`` (``:25-90``),
``_demand_probe`` and ``make_render_fn`` (``:383-424``) and
``render_trajectory`` (``:225-340``). Camera convention: forward =
normalize(target - pos), right = normalize(forward x up), camera y = -up.

Timing: every timed frame ends in ``torch.cuda.synchronize()`` on a card
(the host clock runs from dispatch to that sync), and frames whose pair
demand exceeds the capacity are counted.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .config import RenderConfig


def look_at(position: np.ndarray, target: np.ndarray,
            up=(0.0, 1.0, 0.0)) -> np.ndarray:
    """c2w [4, 4] for a camera at `position` looking at `target`."""
    position = np.asarray(position, np.float64)
    forward = np.asarray(target, np.float64) - position
    forward = forward / (np.linalg.norm(forward) + 1e-12)
    up = np.asarray(up, np.float64)
    right = np.cross(forward, up)
    right = right / (np.linalg.norm(right) + 1e-12)
    cam_up = np.cross(right, forward)
    c2w = np.eye(4)
    c2w[:3, 0] = right
    c2w[:3, 1] = -cam_up
    c2w[:3, 2] = forward
    c2w[:3, 3] = position
    return c2w.astype(np.float32)


def create_orbit_trajectory(
    center: np.ndarray,
    radius: float,
    num_frames: int = 120,
    elevation_deg: float = 15.0,
    up=(0.0, 1.0, 0.0),
) -> np.ndarray:
    """[K, 4, 4] c2w poses orbiting `center`."""
    center = np.asarray(center, np.float64)
    elev = np.deg2rad(elevation_deg)
    poses = []
    for i in range(num_frames):
        th = 2.0 * np.pi * i / num_frames
        offset = radius * np.array(
            [np.cos(th) * np.cos(elev), np.sin(elev), np.sin(th) * np.cos(elev)]
        )
        poses.append(look_at(center + offset, center, up))
    return np.stack(poses)


def estimate_scene_center_radius(
    c2w_matrices: np.ndarray | None = None,
    positions: np.ndarray | None = None,
    look_distance: float = 5.0,
) -> tuple[np.ndarray, float]:
    """Scene center + orbit radius from training cameras, else from the
    gaussian positions (median center, 1.5 x the 90th-percentile distance,
    clamped to [3, 20])."""
    if c2w_matrices is not None and len(c2w_matrices) > 0:
        c2w = np.asarray(c2w_matrices, np.float64)
        cam_pos = c2w[:, :3, 3]
        forward = c2w[:, :3, 2]
        lookats = cam_pos + forward * look_distance
        center = lookats.mean(axis=0)
        spread = np.linalg.norm(cam_pos - cam_pos.mean(axis=0), axis=1).max()
        radius = float(np.clip(1.2 * spread, 3.0, 20.0))
        return center.astype(np.float32), radius
    if positions is not None and len(positions) > 0:
        pts = np.asarray(positions, np.float64)
        center = np.median(pts, axis=0)
        r = np.linalg.norm(pts - center, axis=1)
        radius = float(np.clip(1.5 * np.percentile(r, 90.0), 3.0, 20.0))
        return center.astype(np.float32), radius
    return np.zeros(3, np.float32), 5.0


def _split_render_out(out):
    """render_fn may return `img` or `(img, probe)` (see _demand_probe)."""
    if isinstance(out, (tuple, list)) and len(out) == 2:
        return out[0], out[1]
    return out, None


def _sync(t: torch.Tensor):
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def _traj_stats(times, n_frames, probes, pair_capacity):
    times_ms = np.asarray(times) * 1e3
    stats = {
        "frames": n_frames,
        "mean_ms": float(times_ms.mean()),
        "median_ms": float(np.median(times_ms)),
        "min_ms": float(times_ms.min()),
        "max_ms": float(times_ms.max()),
        "std_ms": float(times_ms.std()),
        "fps": float(1e3 / times_ms.mean()),
        "frame_ms": [float(t) for t in times_ms],
    }
    if probes:
        pv = np.stack(probes)  # [K, 3]
        stats["frame_mean"] = [float(x) for x in pv[:, 0]]
        stats["frame_pairs"] = [int(x) for x in pv[:, 1]]
        stats["max_pairs_seen"] = int(pv[:, 1].max())
        stats["pair_capacity"] = int(pair_capacity)
        stats["pair_overflow_frames"] = (
            int((pv[:, 1] > pair_capacity).sum()) if pair_capacity else 0
        )
    return stats


def render_trajectory(
    render_fn,
    trajectory: np.ndarray,
    warmup: int = 1,
    keep_frames: bool = True,
    pair_capacity: int = 0,
):
    """Render every pose; returns (frames uint8 list, stats dict).

    `render_fn(c2w) -> [H, W, 3]` image, or `(img, probe)` with probe the
    [3] f32 vector ``[mean(img), num_pairs, num_rows]``
    (``make_render_fn(report_demand=True)``); then the stats track each
    frame's demand and, with `pair_capacity` set, count overflow frames
    (overflow drops the farthest splats, so it must be surfaced).

    Each timed frame runs from dispatch to ``torch.cuda.synchronize()``.
    With ``keep_frames=False`` (benchmark mode) no image is fetched to the
    host, and a second, pipelined pass dispatches every frame with one
    sync at the end.
    """
    frames = []
    times = []
    probes = []

    for i in range(min(warmup, len(trajectory))):
        img, _ = _split_render_out(render_fn(np.asarray(trajectory[i])))
        _sync(img)
    for c2w in trajectory:
        t0 = time.perf_counter()
        img, probe = _split_render_out(render_fn(np.asarray(c2w)))
        _sync(img)
        times.append(time.perf_counter() - t0)
        if probe is not None:
            probes.append(probe.cpu().numpy())
        if keep_frames:
            frames.append(
                (torch.clamp(img, 0, 1).cpu().numpy() * 255.0 + 0.5).astype(
                    np.uint8
                )
            )
    stats = _traj_stats(
        times, len(frames) if keep_frames else len(trajectory), probes,
        pair_capacity,
    ) if times else {}
    if not keep_frames and len(trajectory) > 1:
        # PIPELINED throughput: dispatch every frame, one sync at the end.
        # Only the newest image is kept referenced, so earlier frames'
        # memory is freed as they finish.
        last = None
        t0 = time.perf_counter()
        for c2w in trajectory:
            last = _split_render_out(render_fn(np.asarray(c2w)))[0]
        _sync(last)
        dt = (time.perf_counter() - t0) / len(trajectory)
        stats["fps_pipelined"] = float(1.0 / dt)
        stats["pipelined_ms"] = float(dt * 1e3)
    return frames, stats


def _demand_probe(img, aux):
    """[3] f32 vector [mean(img), num_pairs, num_rows]; mean(img) makes it
    depend on every pixel."""
    rows = (aux.num_rows if aux.num_rows is not None
            else torch.zeros((), dtype=torch.int32, device=img.device))
    return torch.stack(
        [
            torch.mean(img),
            aux.num_pairs.to(torch.float32),
            rows.to(torch.float32),
        ]
    )


def make_render_fn(params: dict, cfg: RenderConfig, fx, fy, cx, cy,
                   alive=None, with_depth: bool = False,
                   report_demand: bool = False):
    """c2w -> image closure over fixed params/intrinsics, run without
    autograd (serving). The pose moves to the parameters' device.

    With ``with_depth`` the closure returns (rgb, depth, alpha) planes.
    With ``report_demand`` it returns (img, probe[3]) — see _demand_probe.
    """
    from .render import render_from_params

    def fn(c2w):
        with torch.no_grad():
            img, aux = render_from_params(
                params, c2w, fx, fy, cx, cy, cfg, alive=alive
            )
        if with_depth:
            return img, aux.depth, aux.alpha
        if report_demand:
            return img, _demand_probe(img, aux)
        return img

    return fn

"""Inference-time rendering: orbit trajectories and a timed serving loop.

Counterpart of ``gsplat_tpu/viewer.py``: ``look_at``,
``create_orbit_trajectory``, ``estimate_scene_center_radius`` (``:25-90``),
``_traj_stats`` (``:102-123``), ``make_bucketed_render_fn``
(``:126-222``), ``render_trajectory`` (``:225-340``, one pose or a batch
of poses per call), ``_demand_probe``, ``make_render_fn`` and
``make_batch_render_fn`` (``:383-452``), ``save_video`` (``:343-380``)
and ``colorize_depth`` (``:455-468``). Camera
convention: forward = normalize(target - pos), right = normalize(forward
x up), camera y = -up.

Timing: every timed frame ends in ``torch.cuda.synchronize()`` on a card
(the host clock runs from dispatch to that sync), and frames whose pair
demand exceeds the capacity are counted.
"""

from __future__ import annotations

import os
import subprocess
import time

import numpy as np
import torch

from .config import RenderConfig
from .utils.profiling import span


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


def _traj_stats(times, n_frames, probes, pair_capacity, extra=None):
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
    if extra:
        stats.update(extra)
    if probes:
        pv = np.stack(probes)  # [K, 3]
        stats["frame_mean"] = [float(x) for x in pv[:, 0]]
        stats["frame_pairs"] = [int(x) for x in pv[:, 1]]
        stats["max_pairs_seen"] = int(pv[:, 1].max())
        stats["max_rows_seen"] = int(pv[:, 2].max())
        stats["pair_capacity"] = int(pair_capacity)
        stats["pair_overflow_frames"] = (
            int((pv[:, 1] > pair_capacity).sum()) if pair_capacity else 0
        )
    return stats


def make_bucketed_render_fn(params: dict, cfg: RenderConfig, fx, fy, cx, cy,
                            alive=None, trajectory=None,
                            num_buckets: int = 4,
                            report_demand: bool = False, verbose=print):
    """Per-frame capacity bucketing for a known trajectory.

    Probes every pose's demand with :func:`render.pair_demand` (projection
    and binning only), builds a ladder of at most ``num_buckets``
    capacities halved down from the top rung (the largest demand + 20 %,
    rounded up to 4,096 and clamped at ``cfg.max_pairs``; no rung below
    the smallest demand's), gives each pose the smallest rung that fits
    (a pose above the top rung takes the top rung: its farthest pairs drop
    and the probe reports it), and sizes each rung's ``trunc_pairs`` (with
    ``tile_rank_cap``) from the truncated demands of the poses it serves.
    Every rung renders once before this returns, so the timed loop meets
    no first call. The closure looks poses up by their float32 bytes; an
    unknown pose takes the top rung. Same contract as
    :func:`make_render_fn`.

    The closure carries the ladder: ``fn.demands`` (per pose,
    ``(num_pairs, num_rows, trunc_demand)``), ``fn.rungs`` (ascending
    ``max_pairs``), ``fn.assign`` (each pose's rung) and ``fn.cfgs`` (each
    rung's config, None where no pose uses it). In ellipse mode each
    rung's ``max_rows`` is sized from the row demands of its poses.
    """
    from .render import pair_demand

    if trajectory is None or len(trajectory) == 0:
        raise ValueError("bucketed rendering needs the trajectory up front")

    with torch.no_grad():
        demands = [tuple(int(x) for x in pair_demand(
            params, np.asarray(c), fx, fy, cx, cy, cfg, alive=alive))
            for c in trajectory]

    def rup(x):
        return max(4096, -(-int(x * 1.2) // 4096) * 4096)

    top = min(rup(max(d[0] for d in demands)), cfg.max_pairs)
    lo = rup(min(d[0] for d in demands))
    rungs = [top]
    while len(rungs) < num_buckets and rungs[-1] // 2 >= lo:
        rungs.append(-(-(rungs[-1] // 2) // 4096) * 4096)
    rungs = sorted(rungs)  # ascending capacities

    def rung_of(d):
        need = rup(d)
        for k, r in enumerate(rungs):
            if r >= need:
                return k
        return len(rungs) - 1  # over the top rung: clamped, reported

    assign = [rung_of(d[0]) for d in demands]
    cfgs, fns = [], []
    for k, r in enumerate(rungs):
        members = [demands[i] for i in range(len(demands)) if assign[i] == k]
        if not members:
            cfgs.append(None)
            fns.append(None)
            continue
        kw = {"max_pairs": r}
        if cfg.cull_mode == "ellipse":
            kw["max_rows"] = rup(max(m[1] for m in members))
        if cfg.tile_rank_cap:
            kw["trunc_pairs"] = rup(max(m[2] for m in members))
        cfgs.append(cfg.with_(**kw))
        fns.append(make_render_fn(params, cfgs[-1], fx, fy, cx, cy,
                                  alive=alive, report_demand=report_demand))
    counts = [sum(1 for a in assign if a == k) for k in range(len(rungs))]
    verbose("bucketed orbit: " + "  ".join(
        f"rung {r} x{c}" for r, c in zip(rungs, counts) if c))

    table = {np.asarray(c2w, np.float32).tobytes(): assign[i]
             for i, c2w in enumerate(trajectory)}
    top_k = max(k for k in range(len(rungs)) if fns[k] is not None)

    # Render every used rung once, outside the timed loop.
    for k in range(len(rungs)):
        if fns[k] is not None:
            img, _ = _split_render_out(
                fns[k](np.asarray(trajectory[assign.index(k)])))
            _sync(img)

    def fn(c2w):
        k = table.get(np.asarray(c2w, np.float32).tobytes(), top_k)
        return (fns[k] or fns[top_k])(c2w)

    fn.demands, fn.rungs, fn.assign, fn.cfgs = demands, rungs, assign, cfgs
    return fn


def _to_uint8(imgs: torch.Tensor) -> np.ndarray:
    return (torch.clamp(imgs, 0, 1).cpu().numpy() * 255.0 + 0.5).astype(
        np.uint8)


def render_trajectory(
    render_fn,
    trajectory: np.ndarray,
    warmup: int = 1,
    batch_size: int = 1,
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

    ``batch_size`` > 1: `render_fn([B, 4, 4]) -> [B, H, W, 3]`
    (:func:`make_batch_render_fn`) renders B poses per call; each frame's
    time is the call's divided by B, and each probe is the batch's (its
    demand against the batch's shared capacity). The last chunk is padded
    by repeating its final pose (the padded frames are dropped). The stats
    gain ``batch_size``; there is no pipelined pass.
    """
    frames = []
    times = []
    probes = []

    if batch_size > 1:
        B, n = batch_size, len(trajectory)
        warm = np.broadcast_to(np.asarray(trajectory[0]), (B, 4, 4)).copy()
        for _ in range(min(warmup, 1)):
            _sync(_split_render_out(render_fn(warm))[0])
        for s in range(0, n, B):
            chunk = np.asarray(trajectory[s:s + B])
            real = chunk.shape[0]
            if real < B:
                chunk = np.concatenate(
                    [chunk, np.repeat(chunk[-1:], B - real, axis=0)])
            t0 = time.perf_counter()
            imgs, probe = _split_render_out(render_fn(chunk))
            _sync(imgs)
            dt = (time.perf_counter() - t0) / B
            times.extend([dt] * real)
            if probe is not None:
                probes.append(probe.cpu().numpy())
            if keep_frames:
                frames.extend(_to_uint8(imgs[:real]))
        stats = _traj_stats(times, len(frames) if keep_frames else n, probes,
                            pair_capacity, extra={"batch_size": B}) \
            if times else {}
        return frames, stats

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
            frames.append(_to_uint8(img))
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
        with span("gs.frame"), torch.no_grad():
            img, aux = render_from_params(
                params, c2w, fx, fy, cx, cy, cfg, alive=alive
            )
            if with_depth:
                return img, aux.depth, aux.alpha
            if report_demand:
                return img, _demand_probe(img, aux)
            return img

    return fn


def make_batch_render_fn(params: dict, cfg: RenderConfig, fx, fy, cx, cy,
                         alive=None, batch: int = 4,
                         report_demand: bool = False):
    """[B, 4, 4] -> [B, H, W, 3] closure over fixed intrinsics, run without
    autograd: one binning and one compositor launch for the B poses
    (``render.render_batch_from_params``). Each image equals the pose
    rendered alone when fed the same projections. ``batch`` is the B the
    caller sends (kept for the JAX signature; the closure takes any B).
    ``report_demand`` as in :func:`make_render_fn`, with the batch's demand
    (``num_pairs`` against the shared ``B * max_pairs``)."""
    from .render import render_batch_from_params

    def fn(c2w_b):
        with span("gs.frame"), torch.no_grad():
            imgs, aux = render_batch_from_params(
                params, np.asarray(c2w_b), fx, fy, cx, cy, cfg, alive=alive)
            if report_demand:
                return imgs, _demand_probe(imgs, aux)
            return imgs

    return fn


def save_video(
    frames: list,
    path: str,
    fps: int = 30,
    frames_dir: str | None = None,
) -> str:
    """Write uint8 frames as PNGs into ``frames_dir`` (default: ``path``
    without its extension + ``_frames``), then as a video at ``path``
    through imageio, else through ffmpeg over the PNGs; where neither
    writes, the PNG directory stands. Returns what was written: ``path``
    or ``frames_dir``."""
    from .data.images import save_image

    if frames_dir is None:
        frames_dir = os.path.splitext(path)[0] + "_frames"
    os.makedirs(frames_dir, exist_ok=True)
    for i, frame in enumerate(frames):
        save_image(os.path.join(frames_dir, f"frame_{i:05d}.png"), frame)

    try:
        import imageio.v2 as imageio

        with imageio.get_writer(path, fps=fps) as writer:
            for frame in frames:
                writer.append_data(frame)
        return path
    except (ImportError, ValueError, RuntimeError, OSError):
        pass  # no imageio, no backend for the format, or a writer error
    try:
        subprocess.run(
            [
                "ffmpeg", "-y", "-framerate", str(fps),
                "-i", os.path.join(frames_dir, "frame_%05d.png"),
                "-pix_fmt", "yuv420p", path,
            ],
            check=True,
            capture_output=True,
        )
        return path
    except (OSError, subprocess.CalledProcessError):
        return frames_dir  # the PNGs remain


def colorize_depth(depth: np.ndarray, alpha: np.ndarray | None = None):
    """Normalize an accumulated-depth plane to a viewable [H, W, 3] image:
    depth over alpha where alpha > 0.05, stretched between its 2nd and
    98th percentiles (numpy only)."""
    d = np.asarray(depth, np.float32)
    if alpha is not None:
        a = np.clip(np.asarray(alpha, np.float32), 1e-3, 1.0)
        d = d / a
        mask = a > 0.05
    else:
        mask = np.isfinite(d) & (d > 0)
    if mask.any():
        lo, hi = np.percentile(d[mask], [2.0, 98.0])
        d = np.clip((d - lo) / max(hi - lo, 1e-6), 0.0, 1.0)
    d = np.where(mask, d, 0.0)
    return np.repeat(d[..., None], 3, axis=-1)

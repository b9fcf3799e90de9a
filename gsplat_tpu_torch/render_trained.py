"""Serve a trained scene: orbit render with per-frame timing and demand.

Counterpart of ``scripts/render_trained.py:78-409``, restricted to what
this slice of the port supports (single-view rendering, rect binning, no
truncation, the default camera without a dataset). Run as

    python -m gsplat_tpu_torch.render_trained \\
        --checkpoint bench_assets/trained_ckpt.npz --benchmark_only

Without ``--benchmark_only`` the orbit frames are written as one uint8
array to ``renders/orbit.npy`` (video export comes with a later slice).
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np


def resolve_checkpoint(path_or_dir: str) -> str:
    """final > explicit file > latest iteration."""
    if os.path.isfile(path_or_dir):
        return path_or_dir
    final = os.path.join(path_or_dir, "checkpoint_final.npz")
    if os.path.exists(final):
        return final
    cands = sorted(glob.glob(os.path.join(path_or_dir, "checkpoint_*.npz")))
    if cands:
        return cands[-1]
    raise FileNotFoundError(f"no checkpoint under {path_or_dir}")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--checkpoint", required=True,
                   help=".npz checkpoint file or output dir")
    p.add_argument("--num_frames", type=int, default=120)
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--elevation", type=float, default=15.0)
    p.add_argument("--orbit_scale", type=float, default=1.0,
                   help="orbit camera distance as a multiple of the "
                        "estimated scene radius")
    p.add_argument("--max_pairs", type=int, default=2**21)
    p.add_argument("--benchmark_only", action="store_true",
                   help="skip image IO, print FPS stats only")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)

    from .config import RenderConfig
    from .train.trainer import restore_pool
    from .viewer import (
        create_orbit_trajectory,
        estimate_scene_center_radius,
        make_render_fn,
        render_trajectory,
    )

    ckpt = resolve_checkpoint(args.checkpoint)
    print(f"checkpoint: {ckpt}")
    pool = restore_pool(ckpt, device=args.device)
    alive = pool.alive.cpu().numpy()
    n_alive = int(alive.sum())
    print(f"{n_alive} gaussians (pool capacity {pool.capacity}) on "
          f"{pool.alive.device}")

    H = args.height or 1080
    W = args.width or 1920
    fx = fy = 0.85 * W
    cx, cy = W / 2.0, H / 2.0
    cfg = RenderConfig(height=H, width=W, max_pairs=args.max_pairs)

    center, radius = estimate_scene_center_radius(
        positions=pool.pos.detach().cpu().numpy()[alive]
    )
    print(f"orbit: center {np.round(center, 2)}, radius {radius:.2f}")
    traj = create_orbit_trajectory(
        center, radius * args.orbit_scale, num_frames=args.num_frames,
        elevation_deg=args.elevation,
    )

    orbit_fn = make_render_fn(
        pool.params, cfg, fx, fy, cx, cy, alive=pool.alive,
        report_demand=True,
    )
    frames, stats = render_trajectory(
        orbit_fn, traj, keep_frames=not args.benchmark_only,
        pair_capacity=cfg.max_pairs,
    )
    print(
        f"FPS: {stats['fps']:.2f}  (mean {stats['mean_ms']:.2f} ms, "
        f"median {stats['median_ms']:.2f}, min {stats['min_ms']:.2f}, "
        f"max {stats['max_ms']:.2f}, std {stats['std_ms']:.2f})"
    )
    if "fps_pipelined" in stats:
        print(
            f"pipelined FPS: {stats['fps_pipelined']:.2f} "
            f"({stats['pipelined_ms']:.2f} ms/frame — no per-frame sync)"
        )
    print(f"pair demand: max {stats['max_pairs_seen']} of capacity "
          f"{stats['pair_capacity']}")
    if stats["pair_overflow_frames"]:
        print(
            f"WARNING: {stats['pair_overflow_frames']} frame(s) exceeded "
            f"pair capacity — the farthest splats were dropped; raise "
            f"--max_pairs"
        )
    if not args.benchmark_only:
        os.makedirs("renders", exist_ok=True)
        out = os.path.join("renders", "orbit.npy")
        np.save(out, np.stack(frames))
        print(f"frames: {out}")
    return stats


if __name__ == "__main__":
    main()

"""Serve a trained scene: orbit render with per-frame timing and demand.

Counterpart of ``scripts/render_trained.py:78-409``, restricted to what
the port supports (one device, rect binning, the default camera without a
dataset), with batched poses (``--render_batch``: B poses through one
binning and one compositor launch) and the serving levers: per-tile rank
truncation
(``--tile_rank_cap``, with the pre-sort occlusion cull in
``--cull_chunks`` depth chunks), demand-sized capacities
(``--auto_pairs``), per-frame capacity bucketing (``--bucket_pairs``),
``--transmittance_math``, ``--background`` and ``--aa_mode``. Run as

    python -m gsplat_tpu_torch.render_trained \\
        --checkpoint bench_assets/trained_ckpt.npz --benchmark_only \\
        --tile_rank_cap 1024 --bucket_pairs 4

Without ``--benchmark_only`` the orbit frames are written as one uint8
array to ``renders/orbit.npy`` (video export comes with a later slice).
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np
import torch


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
    """Parse ``argv``, serve the orbit and return ``render_trajectory``'s
    stats. With ``--bucket_pairs`` they also hold the ladder (``rungs``,
    ``rung_cfgs``), each frame's rung (``rung_of_frame``) and its probed
    demands (``frame_demand``, ``frame_trunc_demand``)."""
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
    p.add_argument("--auto_pairs", action="store_true",
                   help="probe the orbit's true pair demand (projection and "
                        "binning only) and shrink max_pairs (and "
                        "trunc_pairs) to demand +20%% before rendering; "
                        "--max_pairs becomes the upper bound")
    p.add_argument("--bucket_pairs", type=int, default=0,
                   help="per-frame capacity bucketing: probe every orbit "
                        "pose's demand, build a /2 ladder of N demand-sized "
                        "configs (clamped at --max_pairs) and render each "
                        "frame at the smallest rung that fits. Subsumes "
                        "--auto_pairs. 0 = off")
    p.add_argument("--cull_chunks", type=int, default=64,
                   help="depth chunks of the pre-sort occlusion cull's rank "
                        "bound (more = tighter bound, bigger count grids)")
    p.add_argument("--tile_rank_cap", type=int, default=0,
                   help="keep only the front-most K pairs per tile; combine "
                        "with --auto_pairs to shrink the capacities to the "
                        "truncated demand. 0 = exact")
    p.add_argument("--transmittance_math", default="cumprod",
                   choices=("log", "cumprod"))
    p.add_argument("--background", default="black",
                   help="render background: 'black', 'white', or 'r,g,b'")
    p.add_argument("--aa_mode", default="none",
                   choices=("none", "dilate", "mip"),
                   help="screen-space antialiasing: 'dilate' adds the 0.3 px "
                        "low-pass, 'mip' also compensates opacity")
    p.add_argument("--render_batch", type=int, default=1,
                   help="poses rendered per launch via the shared-binning "
                        "batched path (1 = per-pose rendering)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)

    from .config import RenderConfig, parse_background
    from .render import pair_demand
    from .train.trainer import restore_pool
    from .viewer import (
        create_orbit_trajectory,
        estimate_scene_center_radius,
        make_batch_render_fn,
        make_bucketed_render_fn,
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
    cfg = RenderConfig(height=H, width=W, max_pairs=args.max_pairs,
                       tile_rank_cap=args.tile_rank_cap,
                       cull_chunks=args.cull_chunks,
                       transmittance_math=args.transmittance_math,
                       aa_mode=args.aa_mode,
                       background=parse_background(args.background))

    center, radius = estimate_scene_center_radius(
        positions=pool.pos.detach().cpu().numpy()[alive]
    )
    print(f"orbit: center {np.round(center, 2)}, radius {radius:.2f}")
    traj = create_orbit_trajectory(
        center, radius * args.orbit_scale, num_frames=args.num_frames,
        elevation_deg=args.elevation,
    )

    if args.auto_pairs:
        # Probe the orbit's demand (projection and binning, no compositor)
        # and shrink the capacities to demand + 20 %: every pairs-sized
        # stage then runs at the workload's size, not the CLI's bound.
        probe_traj = create_orbit_trajectory(
            center, radius * args.orbit_scale,
            num_frames=min(args.num_frames, 16),
            elevation_deg=args.elevation)
        with torch.no_grad():
            demands = [tuple(int(x) for x in pair_demand(
                pool.params, c, fx, fy, cx, cy, cfg, alive=pool.alive))
                for c in probe_traj]
        pk = max(d[0] for d in demands)
        tk = max(d[2] for d in demands)
        new_pairs = max(4096, -(-int(pk * 1.2) // 4096) * 4096)
        if new_pairs > args.max_pairs:
            # Never grow past the CLI bound: overflow frames drop their
            # farthest splats and are reported by the render loop.
            print(f"auto_pairs: demand {pk} exceeds --max_pairs "
                  f"{args.max_pairs}; clamping (farthest splats drop on "
                  f"overflow frames — raise --max_pairs for exactness)")
            new_pairs = args.max_pairs
        kw = {"max_pairs": new_pairs}
        if cfg.tile_rank_cap:
            # The truncated demand sizes the compacted list the gather and
            # the compositor run on.
            kw["trunc_pairs"] = max(4096, -(-int(tk * 1.2) // 4096) * 4096)
        print(f"auto_pairs: demand {pk} pairs"
              + (f" / {tk} truncated" if cfg.tile_rank_cap else "")
              + f" -> capacities {kw}")
        cfg = cfg.with_(**kw)

    pair_capacity = cfg.max_pairs
    batch_size = 1
    if args.render_batch > 1:
        # The batch shares one pair list of render_batch x max_pairs.
        orbit_fn = make_batch_render_fn(
            pool.params, cfg, fx, fy, cx, cy, alive=pool.alive,
            batch=args.render_batch, report_demand=True,
        )
        batch_size = args.render_batch
        pair_capacity = args.render_batch * cfg.max_pairs
    elif args.bucket_pairs:
        orbit_fn = make_bucketed_render_fn(
            pool.params, cfg, fx, fy, cx, cy, alive=pool.alive,
            trajectory=traj, num_buckets=args.bucket_pairs,
            report_demand=True,
        )
    else:
        orbit_fn = make_render_fn(
            pool.params, cfg, fx, fy, cx, cy, alive=pool.alive,
            report_demand=True,
        )
    frames, stats = render_trajectory(
        orbit_fn, traj, batch_size=batch_size,
        keep_frames=not args.benchmark_only, pair_capacity=pair_capacity,
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
            f"--max_pairs or use --auto_pairs"
        )
    if args.bucket_pairs and batch_size == 1:
        stats.update(rungs=orbit_fn.rungs, rung_of_frame=orbit_fn.assign,
                     rung_cfgs=orbit_fn.cfgs,
                     frame_demand=[d[0] for d in orbit_fn.demands],
                     frame_trunc_demand=[d[2] for d in orbit_fn.demands])
    if not args.benchmark_only:
        os.makedirs("renders", exist_ok=True)
        out = os.path.join("renders", "orbit.npy")
        np.save(out, np.stack(frames))
        print(f"frames: {out}")
    return stats


if __name__ == "__main__":
    main()

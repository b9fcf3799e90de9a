"""Serve a trained scene: orbit render with per-frame timing and demand.

Counterpart of ``scripts/render_trained.py:78-409``, with the camera of a
prepared dataset (``--data_dir``, ``--scale_factor``; else a generic
pinhole at ``--height``/``--width``), its training views
(``--render_training_views``: the first 10), the pool exported as a
standard 3DGS PLY (``--export_ply``, ``--ply_external_colors``) or a
``.splat`` file (``--export_splat``), batched poses (``--render_batch``: B
poses through one
binning and one compositor launch) and the serving levers: per-tile rank
truncation
(``--tile_rank_cap``, with the pre-sort occlusion cull in
``--cull_chunks`` depth chunks), demand-sized capacities
(``--auto_pairs``), per-frame capacity bucketing (``--bucket_pairs``),
``--transmittance_math``, ``--background``, ``--aa_mode``, the tile cull
(``--cull_mode``: ``ellipse`` expands only the tiles of each splat's
ellipse; ``--auto_pairs`` then also sizes ``max_rows``) and the
compositor (``--backend``: ``auto`` and ``pallas`` the kernel, ``xla`` the
dense per-tile compositor). ``--spmd`` serves the orbit over a ``(data,
tile)`` grid of ``--spmd_ranks`` processes (default: the launcher's world,
else one per card): poses split over ``data``, frames into
``--spmd_bands`` bands over ``tile`` (``--dist_backend gloo`` shares one
card). Run as

    python -m gsplat_tpu_torch.render_trained \\
        --checkpoint bench_assets/trained_ckpt.npz --benchmark_only \\
        --tile_rank_cap 1024 --bucket_pairs 4

Without ``--benchmark_only`` the orbit is written to
``<output_dir>/orbit.mp4`` at ``--fps`` (``viewer.save_video``: imageio,
else ffmpeg; its PNG frames stay in ``<output_dir>/orbit_frames``), and
``--save_depth`` writes each orbit pose's colourized depth map to
``<output_dir>/depth/depth_<i>.png``.
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


def load_params(path: str, device="cuda"):
    """(params, alive) on ``device`` from a ``.npz`` pool checkpoint, a
    standard 3DGS ``.ply`` (every gaussian alive), or a directory of six
    ``.pt`` tensors (the reference implementation's checkpoint layout)."""
    from .device import resolve_device

    dev = resolve_device(device)
    if path.endswith(".npz"):
        from .train.trainer import restore_pool

        pool = restore_pool(path, device=dev)
        return pool.params, pool.alive
    if path.endswith(".ply"):
        from .data.gsply import import_gaussians_ply

        params = {k: torch.from_numpy(v).to(dev)
                  for k, v in import_gaussians_ply(path).items()}
    else:
        d = os.path.dirname(path) if os.path.isfile(path) else path
        names = {
            "pos": "positions.pt", "scale_raw": "scales.pt",
            "q_raw": "rotations.pt", "opacity_raw": "opacities.pt",
            "f_dc": "features_dc.pt", "f_rest": "features_rest.pt",
        }
        params = {k: torch.load(os.path.join(d, fn), map_location="cpu",
                                weights_only=True).to(dev, torch.float32)
                  for k, fn in names.items()}
    n = params["pos"].shape[0]
    return params, torch.ones(n, dtype=torch.bool, device=dev)


def apply_resolution_override(H, W, fx, fy, cx, cy, height=None, width=None):
    """Apply ``--height``/``--width``, rescaling the intrinsics to keep the
    field of view."""
    if (height and height != H) or (width and width != W):
        from .ops.camera import scale_intrinsics

        H_new = height or H
        W_new = width or W
        fx, fy, cx, cy = scale_intrinsics(H_new, W_new, H, W, fx, fy, cx, cy)
        H, W = H_new, W_new
    return H, W, fx, fy, cx, cy


def main(argv=None):
    """Parse ``argv``, serve the orbit and return ``render_trajectory``'s
    stats. With ``--bucket_pairs`` they also hold the ladder (``rungs``,
    ``rung_cfgs``), each frame's rung (``rung_of_frame``) and its probed
    demands (``frame_demand``, ``frame_trunc_demand``); with the orbit
    written, ``video`` (the video's path, or the PNG directory) and, with
    ``--save_depth``, ``depth_dir``."""
    from .utils.compile_cache import enable_compilation_cache

    enable_compilation_cache()  # the kernel builds' directory
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--checkpoint", required=True,
                   help=".npz checkpoint file, output dir, or a 3DGS .ply")
    p.add_argument("--data_dir", default=None,
                   help="dataset dir (for camera intrinsics and the orbit "
                        "center)")
    p.add_argument("--output_dir", default="renders")
    p.add_argument("--num_frames", type=int, default=120)
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--scale_factor", type=float, default=1.0)
    p.add_argument("--elevation", type=float, default=15.0)
    p.add_argument("--orbit_scale", type=float, default=1.0,
                   help="orbit camera distance as a multiple of the "
                        "estimated scene radius")
    p.add_argument("--fps", type=int, default=30)
    p.add_argument("--max_pairs", type=int, default=2**21)
    p.add_argument("--benchmark_only", action="store_true",
                   help="skip image/video IO, print FPS stats only")
    p.add_argument("--render_training_views", action="store_true",
                   help="with --data_dir: also write the first 10 training "
                        "views' renders")
    p.add_argument("--save_depth", action="store_true",
                   help="also write normalized depth maps for orbit frames")
    p.add_argument("--export_ply", default=None,
                   help="also write the gaussians as a standard 3DGS PLY "
                        "(loadable by public splat viewers)")
    p.add_argument("--export_splat", default=None,
                   help="also write a .splat file (antimatter15 web-viewer "
                        "format, 32 bytes/gaussian)")
    p.add_argument("--ply_external_colors", action="store_true",
                   help="remap the DC color term for INRIA-convention "
                        "viewers (approximate for view-dependent color)")
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
    p.add_argument("--backend", default="auto",
                   choices=("auto", "pallas", "xla"))
    p.add_argument("--render_batch", type=int, default=1,
                   help="poses rendered per launch via the shared-binning "
                        "batched path (1 = per-pose rendering)")
    p.add_argument("--cull_mode", default="rect",
                   choices=("rect", "ellipse"),
                   help="tile culling granularity (ellipse: exact per-row "
                        "ellipse intervals, fewer pairs)")
    p.add_argument("--spmd", action="store_true",
                   help="serve over a (data, tile) process grid: poses over "
                        "'data', frames split into --spmd_bands bands")
    p.add_argument("--spmd_bands", type=int, default=1,
                   help="tile-band ('tile' grid axis) size under --spmd")
    p.add_argument("--spmd_ranks", type=int, default=None,
                   help="processes of the --spmd grid (default: the "
                        "launcher's world, else one per card)")
    p.add_argument("--dist_backend", default="nccl",
                   choices=("nccl", "gloo"),
                   help="collectives of the --spmd grid (gloo: through "
                        "host memory, several ranks per card)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)
    if args.spmd:
        from .parallel.mesh import cli_rank, grid_device, grid_ranks, launch

        # Rank 0 prints, writes and returns the result.
        return launch(cli_rank, grid_ranks(args.spmd_ranks),
                      args.dist_backend, grid_device(args.device),
                      args=(_run, args, None, args.spmd_bands))
    return _run(args)


def _run(args, mesh=None):
    """The CLI's work on one device, or on this rank of ``mesh``."""
    write = mesh is None or mesh.rank == 0

    from .config import RenderConfig, parse_background
    from .data.images import save_image
    from .render import pair_demand
    from .viewer import (
        colorize_depth,
        create_orbit_trajectory,
        estimate_scene_center_radius,
        make_batch_render_fn,
        make_bucketed_render_fn,
        make_render_fn,
        render_trajectory,
        save_video,
    )

    ckpt = resolve_checkpoint(args.checkpoint)
    print(f"checkpoint: {ckpt}")
    params, alive_t = load_params(
        ckpt, device=args.device if mesh is None else mesh.device)
    alive = alive_t.cpu().numpy()
    n_alive = int(alive.sum())
    print(f"{n_alive} gaussians (pool capacity {alive.shape[0]}) on "
          f"{alive_t.device}")

    # Camera: the dataset's intrinsics when given, else a generic pinhole.
    c2ws = None
    if args.data_dir:
        from .data import GaussianDataset

        ds = GaussianDataset(args.data_dir, scale_factor=args.scale_factor)
        H, W = ds.height, ds.width
        fx, fy, cx, cy = ds.fx, ds.fy, ds.cx, ds.cy
        c2ws = ds.c2w
    else:
        H = args.height or 1080
        W = args.width or 1920
        fx = fy = 0.85 * W
        cx, cy = W / 2.0, H / 2.0
    H, W, fx, fy, cx, cy = apply_resolution_override(
        H, W, fx, fy, cx, cy, args.height, args.width)
    cfg = RenderConfig(height=H, width=W, max_pairs=args.max_pairs,
                       backend=args.backend, cull_mode=args.cull_mode,
                       tile_rank_cap=args.tile_rank_cap,
                       cull_chunks=args.cull_chunks,
                       transmittance_math=args.transmittance_math,
                       aa_mode=args.aa_mode,
                       background=parse_background(args.background))

    if write and (args.export_ply or args.export_splat):
        from .data.gsply import export_gaussians_ply, export_gaussians_splat

        host = {k: v.detach().cpu().numpy() for k, v in params.items()}
        if args.export_ply:
            n_written = export_gaussians_ply(
                args.export_ply, host, alive=alive,
                convert_colors=args.ply_external_colors)
            print(f"exported {n_written} gaussians to {args.export_ply}")
        if args.export_splat:
            n_written = export_gaussians_splat(args.export_splat, host,
                                               alive=alive)
            print(f"exported {n_written} gaussians to {args.export_splat}")

    if write and args.render_training_views and c2ws is not None:
        os.makedirs(args.output_dir, exist_ok=True)
        view_fn = make_render_fn(params, cfg, fx, fy, cx, cy, alive=alive_t)
        for i, c2w in enumerate(c2ws[:10]):
            save_image(os.path.join(args.output_dir,
                                    f"train_view_{i:03d}.png"),
                       view_fn(c2w).cpu().numpy())
        print(f"rendered {min(len(c2ws), 10)} training views")

    center, radius = estimate_scene_center_radius(
        c2w_matrices=c2ws,
        positions=params["pos"].detach().cpu().numpy()[alive],
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
                params, c, fx, fy, cx, cy, cfg, alive=alive_t))
                for c in probe_traj]
        pk = max(d[0] for d in demands)
        rk = max(d[1] for d in demands)
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
        if cfg.cull_mode == "ellipse":
            kw["max_rows"] = max(4096, -(-int(rk * 1.2) // 4096) * 4096)
        if cfg.tile_rank_cap:
            # The truncated demand sizes the compacted list the compositor
            # runs on.
            kw["trunc_pairs"] = max(4096, -(-int(tk * 1.2) // 4096) * 4096)
        print(f"auto_pairs: demand {pk} pairs"
              + (f" / {rk} rows" if cfg.cull_mode == "ellipse" else "")
              + (f" / {tk} truncated" if cfg.tile_rank_cap else "")
              + f" -> capacities {kw}")
        cfg = cfg.with_(**kw)

    pair_capacity = cfg.max_pairs
    batch_size = 1
    if mesh is not None:
        from .parallel import make_sharded_batch_render

        n_data = mesh.shape["data"]
        batch_size = args.render_batch if args.render_batch > 1 else n_data
        if batch_size % n_data:
            raise ValueError(f"--render_batch {batch_size} must be a "
                             f"multiple of the grid's data axis ({n_data})")
        print(f"SPMD orbit: grid {mesh.shape} of {mesh.backend} ranks")
        sfn = make_sharded_batch_render(cfg, mesh)

        def orbit_fn(c2w_b):
            return sfn(params, alive_t, c2w_b, fx, fy, cx, cy)

        pair_capacity = 0
    elif args.render_batch > 1:
        # The batch shares one pair list of render_batch x max_pairs.
        orbit_fn = make_batch_render_fn(
            params, cfg, fx, fy, cx, cy, alive=alive_t,
            batch=args.render_batch, report_demand=True,
        )
        batch_size = args.render_batch
        pair_capacity = args.render_batch * cfg.max_pairs
    elif args.bucket_pairs:
        orbit_fn = make_bucketed_render_fn(
            params, cfg, fx, fy, cx, cy, alive=alive_t,
            trajectory=traj, num_buckets=args.bucket_pairs,
            report_demand=True,
        )
    else:
        orbit_fn = make_render_fn(
            params, cfg, fx, fy, cx, cy, alive=alive_t,
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
    if "max_pairs_seen" in stats:
        print(f"pair demand: max {stats['max_pairs_seen']} of capacity "
              f"{stats['pair_capacity']}")
    if stats.get("pair_overflow_frames"):
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
    if write and not args.benchmark_only:
        os.makedirs(args.output_dir, exist_ok=True)
        video = save_video(frames, os.path.join(args.output_dir,
                                                "orbit.mp4"), fps=args.fps)
        print(f"video/frames: {video}")
        stats["video"] = video
    if write and args.save_depth:
        depth_fn = make_render_fn(params, cfg, fx, fy, cx, cy,
                                  alive=alive_t, with_depth=True)
        depth_dir = os.path.join(args.output_dir, "depth")
        os.makedirs(depth_dir, exist_ok=True)
        for i, c2w in enumerate(traj):
            _, depth, alpha_plane = depth_fn(c2w)
            save_image(os.path.join(depth_dir, f"depth_{i:05d}.png"),
                       colorize_depth(depth.cpu().numpy(),
                                      alpha_plane.cpu().numpy()))
        print(f"depth maps: {depth_dir}")
        stats["depth_dir"] = depth_dir
    return stats


if __name__ == "__main__":
    main()

"""Render novel views along a precomputed [K, 4, 4] trajectory.

Counterpart of ``scripts/inference.py``. The trajectory is a .npy / .npz
/ .pt array of camera-to-world matrices; frames are written as PNGs. Run
as

    python -m gsplat_tpu_torch.inference --checkpoint output/garden \\
        --trajectory path.npy --data_dir data/garden

``--render_batch`` B renders B poses per launch through one binning;
``--bucket_pairs`` N sizes each frame's capacities from a ladder of N
demand-sized configurations over the known trajectory. ``--spmd``
renders over a ``(data, tile)`` grid of ``--spmd_ranks`` processes
(default: the launcher's world, else one per card; ``--dist_backend
gloo`` shares one card): poses over ``data``, frames in ``--spmd_bands``
bands over ``tile``; rank 0 writes the frames.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def load_trajectory(path: str) -> np.ndarray:
    """[K, 4, 4] float32 camera-to-world poses from .npy / .npz / .pt."""
    if path.endswith(".pt"):
        t = torch.load(path, map_location="cpu", weights_only=True)
        traj = np.asarray(t, np.float32)
    elif path.endswith(".npz"):
        with np.load(path) as data:
            traj = data[list(data.keys())[0]].astype(np.float32)
    else:
        traj = np.load(path).astype(np.float32)
    if traj.ndim != 3 or traj.shape[1:] != (4, 4):
        raise ValueError(f"trajectory must be [K, 4, 4], got {traj.shape}")
    return traj


def main(argv=None):
    """Parse ``argv``, render the trajectory and return the frame paths."""
    from .utils.compile_cache import enable_compilation_cache

    enable_compilation_cache()  # the kernel builds' directory
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--trajectory", required=True,
                   help="[K, 4, 4] c2w array (.npy/.npz/.pt)")
    p.add_argument("--output_dir", default="novel_views")
    p.add_argument("--data_dir", default=None,
                   help="dataset dir for intrinsics")
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--scale_factor", type=float, default=0.5,
                   help="resolution multiplier (0.5 = half size)")
    p.add_argument("--max_pairs", type=int, default=2**21)
    p.add_argument("--cull_mode", default="rect",
                   choices=("rect", "ellipse"),
                   help="tile culling granularity (ellipse: exact per-row "
                        "ellipse intervals, fewer pairs)")
    p.add_argument("--tile_rank_cap", type=int, default=0,
                   help="keep only the front-most K pairs per tile; 0 = "
                        "exact")
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
    p.add_argument("--spmd", action="store_true",
                   help="render over a (data, tile) process grid: poses "
                        "over 'data', frames in --spmd_bands bands")
    p.add_argument("--spmd_bands", type=int, default=1,
                   help="tile-band ('tile' grid axis) size under --spmd")
    p.add_argument("--spmd_ranks", type=int, default=None,
                   help="processes of the --spmd grid (default: the "
                        "launcher's world, else one per card)")
    p.add_argument("--dist_backend", default="nccl",
                   choices=("nccl", "gloo"),
                   help="collectives of the --spmd grid (gloo: through "
                        "host memory, several ranks per card)")
    p.add_argument("--render_batch", type=int, default=1,
                   help="poses rendered per launch via the shared-binning "
                        "batched path")
    p.add_argument("--bucket_pairs", type=int, default=0,
                   help="per-frame capacity bucketing over the known "
                        "trajectory (see render_trained --bucket_pairs); 0 = "
                        "off")
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
    """Render the trajectory on one device, or on this rank of ``mesh``."""

    from .config import RenderConfig, parse_background
    from .data.images import save_image
    from .render_trained import load_params, resolve_checkpoint
    from .viewer import (make_batch_render_fn, make_bucketed_render_fn,
                         make_render_fn, render_trajectory)

    params, alive = load_params(
        resolve_checkpoint(args.checkpoint),
        device=args.device if mesh is None else mesh.device)
    traj = load_trajectory(args.trajectory)

    if args.data_dir:
        from .data import GaussianDataset

        ds = GaussianDataset(args.data_dir, scale_factor=args.scale_factor)
        H, W, fx, fy, cx, cy = ds.height, ds.width, ds.fx, ds.fy, ds.cx, ds.cy
    else:
        H = args.height or 720
        W = args.width or 1280
        fx = fy = 0.85 * W
        cx, cy = W / 2.0, H / 2.0
    if args.height:
        H = args.height
    if args.width:
        W = args.width

    cfg = RenderConfig(height=H, width=W, max_pairs=args.max_pairs,
                       backend=args.backend, cull_mode=args.cull_mode,
                       tile_rank_cap=args.tile_rank_cap,
                       transmittance_math=args.transmittance_math,
                       aa_mode=args.aa_mode,
                       background=parse_background(args.background))
    write = mesh is None or mesh.rank == 0
    if write:
        os.makedirs(args.output_dir, exist_ok=True)
    paths = []
    if args.render_batch > 1 or mesh is not None:
        if mesh is not None:
            from .parallel import make_sharded_batch_render

            n_data = mesh.shape["data"]
            if args.render_batch == 1:
                args.render_batch = n_data
            if args.render_batch % n_data:
                raise ValueError(f"--render_batch {args.render_batch} must "
                                 f"be a multiple of the grid's data axis "
                                 f"({n_data})")
            print(f"SPMD: grid {mesh.shape} of {mesh.backend} ranks")
            sfn = make_sharded_batch_render(cfg, mesh)

            def batch_fn(c2w_b):
                return sfn(params, alive, c2w_b, fx, fy, cx, cy)
        else:
            batch_fn = make_batch_render_fn(
                params, cfg, fx, fy, cx, cy, alive=alive,
                batch=args.render_batch,
            )
        frames, _ = render_trajectory(batch_fn, traj,
                                      batch_size=args.render_batch)
        for i, frame in enumerate(frames):
            paths.append(os.path.join(args.output_dir, f"view_{i:05d}.png"))
            if write:
                save_image(paths[-1], frame)
    else:
        if args.bucket_pairs:
            render_fn = make_bucketed_render_fn(
                params, cfg, fx, fy, cx, cy, alive=alive, trajectory=traj,
                num_buckets=args.bucket_pairs,
            )
        else:
            render_fn = make_render_fn(params, cfg, fx, fy, cx, cy,
                                       alive=alive)
        for i, c2w in enumerate(traj):
            paths.append(os.path.join(args.output_dir, f"view_{i:05d}.png"))
            save_image(paths[-1], render_fn(c2w).cpu().numpy())
    print(f"rendered {len(traj)} views to {args.output_dir}")
    return paths


if __name__ == "__main__":
    main()

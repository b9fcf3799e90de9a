"""Occlusion-cull sweep: post-cull pair demand and cull cost vs cull_chunks.

Counterpart of ``scripts/cull_sweep.py``, with its flags and a
``--device``. Run on the card as

    python -m gsplat_tpu_torch.cull_sweep

The pre-sort occlusion cull (``ops/binning.py::_occlusion_cull``) trades
a per-frame bound computation against the size every expansion, sort and
gather stage runs at. At the bench pose (4.4x the scene radius) and a
close-in pose of the default orbit (1.0x), for each chunk count C, it
prints:

  * the post-cull pair demand (what auto-sizing sizes the pipeline for),
  * the kept pairs (the truncation floor: the demand cannot go below it),
  * the cull's own time (``profile_kernel.device_ms``: CUDA events, median
    of 3 runs of ``--iters`` calls; the host clock on the CPU).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def main(argv=None) -> dict:
    """Parse ``argv``, print the sweep and return {pose: {"pre", "kept",
    "chunks": {C: {"demand", "ms"}}}}."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--checkpoint", default="bench_assets/trained_ckpt.npz")
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--tile_rank_cap", type=int, default=1024)
    ap.add_argument("--chunks", type=int, nargs="+",
                    default=[16, 32, 64, 128, 256])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    from .config import RenderConfig
    from .device import resolve_device
    from .ops import binning as B
    from .ops.gaussian import build_cov3d_packed
    from .ops.projection import project_gaussians
    from .profile_stages import clock_name, time_ms
    from .train.trainer import restore_pool
    from .viewer import estimate_scene_center_radius, look_at

    dev = resolve_device(args.device)
    pool = restore_pool(args.checkpoint, device=dev)
    pos = pool.pos.detach().cpu().numpy()[pool.alive.cpu().numpy()]
    center, radius = estimate_scene_center_radius(positions=pos)
    H, W = args.height, args.width
    fx = fy = 0.85 * W
    cx, cy = W / 2.0, H / 2.0
    poses = {
        "bench(4.4x)": look_at(
            center + np.array([0.0, -0.6 * radius, -4.4 * radius]), center),
        "orbit(1.0x)": look_at(
            center + np.array([0.0, -0.3 * radius, -1.0 * radius]), center),
    }
    print(f"device={dev} K={args.tile_rank_cap} ({clock_name(dev)})",
          flush=True)

    out = {}
    with torch.no_grad():
        for name, c2w in poses.items():
            c2w = torch.as_tensor(c2w, dtype=torch.float32, device=dev)
            cfg0 = RenderConfig(height=H, width=W, max_pairs=2**20,
                                tile_rank_cap=args.tile_rank_cap)
            cov3d = build_cov3d_packed(pool.params["scale_raw"],
                                       pool.params["q_raw"])
            proj = project_gaussians(pool.pos, cov3d,
                                     pool.params["opacity_raw"], c2w, fx, fy,
                                     cx, cy, cfg0, extra_valid=pool.alive)
            _, tile_min, n_u, n_v, counts = B._footprints(proj)
            pre = int(counts.sum())
            cap_t = cfg0.rank_cap_blocks * cfg0.pair_block
            # The truncation floor: per-tile exact counts clipped at cap_t.
            tc = B._cover_counts(tile_min[:, 1], tile_min[:, 1] + n_v,
                                 tile_min[:, 0], tile_min[:, 0] + n_u,
                                 counts > 0, cfg0.tiles_y, cfg0.tiles_x)
            kept = int(torch.clamp(tc, max=cap_t).sum())
            print(f"{name}: pre-cull demand {pre}  truncation floor {kept}",
                  flush=True)
            res = out[name] = {"pre": pre, "kept": kept, "chunks": {}}
            for C in args.chunks:
                cfg = cfg0.with_(cull_chunks=C)

                def cull():
                    return B._occlusion_cull(tile_min, n_u, n_v, counts, cfg)

                post = int(cull().sum())
                reps = [time_ms(cull, args.iters, dev) for _ in range(3)]
                ms = sorted(reps)[1]
                res["chunks"][C] = {"demand": post, "ms": ms}
                print(f"  C={C:4d}  cull {ms:7.3f} ms  post-cull demand "
                      f"{post}  ({post / max(pre, 1):.3f}x pre, "
                      f"{post / max(kept, 1):.3f}x floor)", flush=True)
    return out


if __name__ == "__main__":
    main()

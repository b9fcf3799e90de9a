"""Truncation image-error ladder: error vs tile_rank_cap K across poses.

Counterpart of ``scripts/trunc_error_ladder.py``, with its flags and a
``--device``. Run on the card as

    python -m gsplat_tpu_torch.trunc_error_ladder [--caps 1024 4096]

It renders ``--poses`` poses of the default orbit (``--orbit_scale`` 1.0,
the reference convention) exactly, then truncated at each K, and prints
one JSON row per (pose, K): max abs error, PSNR against the exact render,
the pair demand after the cull, the kept (truncated) slots and the exact
demand; then the worst pose per K.

The exact reference is rendered in horizontal bands by principal-point
shift (``cy - r0``): each band is an exact crop with its own, smaller
pair demand. The band count doubles from 2 until the worst band's block
metadata (``band_cap / 128 * 4`` bytes) is at most 700,000 or 16 bands:
the JAX rule, kept as it is so that the port renders the same bands,
although its compositor kernel has no scalar-memory limit. Each band's
projection culls against the band's own screen bounds.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch


def main(argv=None) -> dict:
    """Parse ``argv``, print the ladder, and return {"rows", "summary",
    "bands", "band_capacity", "exact_capacity", "exact_demand", "exact"
    (the banded exact images, [H, W, 3] tensors), "poses"}."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--checkpoint", default="bench_assets/trained_ckpt.npz")
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--orbit_scale", type=float, default=1.0)
    ap.add_argument("--poses", type=int, default=4)
    ap.add_argument("--caps", type=int, nargs="+",
                    default=[512, 1024, 2048, 4096])
    ap.add_argument("--exact_pairs", type=int, default=0,
                    help="full-integrity capacity (0 = 1.2x max probed "
                         "demand across the poses)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    from .config import RenderConfig
    from .device import resolve_device
    from .render import pair_demand, render_from_params
    from .train.trainer import restore_pool
    from .viewer import create_orbit_trajectory, estimate_scene_center_radius

    dev = resolve_device(args.device)
    pool = restore_pool(args.checkpoint, device=dev)
    params, alive = pool.params, pool.alive
    pos = pool.pos.detach().cpu().numpy()[alive.cpu().numpy()]
    center, radius = estimate_scene_center_radius(positions=pos)
    traj = create_orbit_trajectory(center, radius * args.orbit_scale,
                                   num_frames=args.poses)
    H, W = args.height, args.width
    fx = fy = 0.85 * W
    cx, cy = W / 2.0, H / 2.0

    def rup(x):
        return max(4096, -(-int(x) // 4096) * 4096)

    def f32(x):
        return torch.tensor(float(x), dtype=torch.float32, device=dev)

    with torch.no_grad():
        # Exact demand per pose (truncation off, so no occlusion cull).
        base = RenderConfig(height=H, width=W, max_pairs=2**20,
                            max_per_tile=8192)
        demands = [int(pair_demand(params, c2w, fx, fy, cx, cy, base,
                                   alive=alive)[0]) for c2w in traj]
        print("exact pair demand per pose:", demands, flush=True)
        exact_cap = args.exact_pairs or rup(max(demands) * 1.2)
        print(f"exact capacity {exact_cap}", flush=True)

        bands = 2
        while True:
            bh = H // bands
            bcfg0 = base.with_(height=bh)
            bdemand = max(
                int(pair_demand(params, c2w, fx, fy, cx, f32(cy - b * bh),
                                bcfg0, alive=alive)[0])
                for c2w in traj for b in range(bands))
            band_cap = rup(bdemand * 1.2)
            if (band_cap // 128) * 4 <= 700_000 or bands >= 16:
                break
            bands *= 2
        print(f"exact render: {bands} bands, band capacity {band_cap}",
              flush=True)
        ecfg = base.with_(height=H // bands, max_pairs=band_cap)

        def exact_render(c2w):
            bh = H // bands
            return torch.cat([render_from_params(
                params, c2w, fx, fy, cx, f32(cy - b * bh), ecfg,
                alive=alive)[0] for b in range(bands)], dim=0)

        exact_imgs = [exact_render(c2w) for c2w in traj]

        # One config per K, sized to the largest demand over the poses.
        results = []
        for K in args.caps:
            tcfg0 = base.with_(tile_rank_cap=K)
            probes = [pair_demand(params, c2w, fx, fy, cx, cy, tcfg0,
                                  alive=alive) for c2w in traj]
            pds = [int(x[0]) for x in probes]
            tds = [int(x[2]) for x in probes]
            tcfg = tcfg0.with_(max_pairs=rup(max(pds) * 1.2),
                               trunc_pairs=rup(max(tds) * 1.2))
            for i, c2w in enumerate(traj):
                timg = render_from_params(params, c2w, fx, fy, cx, cy, tcfg,
                                          alive=alive)[0]
                diff = timg - exact_imgs[i]
                err = float(diff.abs().max())
                mse = float(torch.mean(diff * diff))
                psnr = float(10 * np.log10(1.0 / mse)) if mse > 0 \
                    else float("inf")
                row = {"pose": i, "K": K, "max_abs_err": err,
                       "psnr_vs_exact": round(psnr, 2),
                       "demand_culled": pds[i], "kept": tds[i],
                       "exact_demand": demands[i]}
                results.append(row)
                print(json.dumps(row), flush=True)

    print("--- worst-pose summary ---", flush=True)
    summary = []
    for K in args.caps:
        rows = [r for r in results if r["K"] == K]
        worst = max(rows, key=lambda r: r["max_abs_err"])
        summary.append({"K": K, "worst_max_abs_err": worst["max_abs_err"],
                        "worst_psnr": worst["psnr_vs_exact"],
                        "worst_pose": worst["pose"]})
        print(json.dumps(summary[-1]), flush=True)
    return {"rows": results, "summary": summary, "bands": bands,
            "band_capacity": band_cap, "exact_capacity": exact_cap,
            "exact_demand": demands, "exact": exact_imgs, "poses": traj}


if __name__ == "__main__":
    main()

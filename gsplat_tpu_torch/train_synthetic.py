"""End-to-end self-check without a dataset: synthesize a scene, render
ground-truth views, train from its point cloud, report PSNR.

Counterpart of ``scripts/train_synthetic.py``: a smoke test of the card
and a training-quality check (the optimizer must recover the scene from
a noisy initialization). Run as

    python -m gsplat_tpu_torch.train_synthetic --iterations 400
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def make_gt_scene(n, seed=0, n_clusters=24, scale_mean=-2.6, device="cpu"):
    """Clustered colourful gaussians (more structure than random noise):
    (params as float32 tensors on ``device``, the [n, 6] cloud of their
    positions and colours), the JAX script's draws from ``seed``."""
    rng = np.random.default_rng(seed)
    centers = np.stack(
        [
            rng.uniform(-2.0, 2.0, n_clusters),
            rng.uniform(-1.2, 1.2, n_clusters),
            rng.uniform(3.0, 7.0, n_clusters),
        ],
        axis=-1,
    )
    cluster_colors = rng.uniform(0.1, 0.9, (n_clusters, 3))
    which = rng.integers(0, n_clusters, n)
    pos = centers[which] + rng.normal(0, 0.25, (n, 3))
    colors = np.clip(
        cluster_colors[which] + rng.normal(0, 0.05, (n, 3)), 0.02, 0.98
    )
    arrays = {
        "pos": pos,
        "scale_raw": rng.normal(0, 0.25, (n, 3)) + scale_mean,
        "q_raw": rng.normal(0, 0.6, (n, 4)) + np.array([0, 0, 0, 1.5]),
        "opacity_raw": rng.normal(1.0, 0.8, n),
        "f_dc": colors,
        "f_rest": rng.normal(0, 0.03, (n, 45)),
    }
    params = {k: torch.as_tensor(np.asarray(v, np.float32), device=device)
              for k, v in arrays.items()}
    cloud = np.concatenate([pos, colors], axis=-1).astype(np.float32)
    return params, cloud


def gt_views(gt_params, n_views, cfg):
    """The ground-truth views of the recipe: ``n_views`` renders of
    ``gt_params`` at ``cfg`` on an orbit around the scene, as view dicts
    (image as numpy, c2w, fx, fy, cx, cy), in the JAX script's order.
    The render keeps ``cfg.max_pairs`` as it is (no growth)."""
    from .render import render_from_params
    from .viewer import look_at

    fx = fy = 0.9 * cfg.width
    cx, cy = cfg.width / 2.0, cfg.height / 2.0
    center = np.array([0.0, 0.0, 4.5])
    views = []
    for i in range(n_views):
        th = 2.0 * np.pi * i / n_views
        posn = center + np.array(
            [4.5 * np.sin(th), 0.8 * np.sin(2 * th), -4.5 * np.cos(th)]
        )
        c2w = look_at(posn, center)
        with torch.no_grad():
            img = render_from_params(gt_params, c2w, fx, fy, cx, cy,
                                     cfg)[0].cpu().numpy()
        views.append(
            {"image": img, "c2w": c2w, "fx": fx, "fy": fy, "cx": cx, "cy": cy}
        )
    return views


class _Views:
    """Minimal dataset over in-memory views (numpy batches of random
    views, drawn with ``default_rng(seed)`` as the JAX script draws
    them)."""

    def __init__(self, views):
        self.views = views

    def __len__(self):
        return len(self.views)

    def __getitem__(self, i):
        return self.views[i]

    def batches(self, batch_size, shuffle=True, seed=0):
        r = np.random.default_rng(seed)
        v0 = self.views[0]
        while True:
            idx = r.integers(0, len(self.views), batch_size)
            sel = [self.views[int(i)] for i in idx]
            yield {
                "image": np.stack([v["image"] for v in sel]),
                "c2w": np.stack([v["c2w"] for v in sel]),
                **{k: np.full((batch_size,), v0[k], np.float32)
                   for k in ("fx", "fy", "cx", "cy")},
            }

    def pointcloud_path(self):
        return None


def main(argv=None):
    """Parse ``argv``, train and evaluate; returns ``evaluate_views``'s
    result with the run's ``steps_per_s`` and ``gaussians``."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--height", type=int, default=256)
    p.add_argument("--width", type=int, default=384)
    p.add_argument("--gt_gaussians", type=int, default=4000)
    p.add_argument("--capacity", type=int, default=2**15)
    p.add_argument("--views", type=int, default=16)
    p.add_argument("--iterations", type=int, default=400)
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--max_pairs", type=int, default=2**18)
    p.add_argument("--trunc_pairs", type=int, default=0,
                   help="capacity of the truncated pair list (0 = worst "
                        "case; fit() grows it on overflow)")
    p.add_argument("--bwd_pairs", type=int, default=0,
                   help="compacted backward: capacity of the composited "
                        "block list in pairs (0 = off; fit() grows it on "
                        "overflow)")
    p.add_argument("--tile_rank_cap", type=int, default=0,
                   help="train through the rank-truncated renderer (a "
                        "serving lever; from-scratch training loses quality "
                        "with it); 0 = exact")
    p.add_argument("--output_dir", default=None)
    p.add_argument("--init_fraction", type=float, default=1.0,
                   help="start from this fraction of the GT cloud (<1 "
                        "makes density control grow the pool)")
    p.add_argument("--max_grad", type=float, default=0.01,
                   help="ADC densify gradient threshold")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--adc_mode", default="reference",
                   choices=("reference", "paper"))
    p.add_argument("--densify_grad_threshold", type=float, default=0.0002)
    p.add_argument("--gt_clusters", type=int, default=24)
    p.add_argument("--gt_scale", type=float, default=-2.6,
                   help="mean log-scale of GT gaussians (smaller = finer)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)

    from .config import RenderConfig, TrainConfig
    from .device import resolve_device
    from .evaluation import evaluate_views
    from .train.fit import fit

    dev = resolve_device(args.device)
    cfg = RenderConfig(
        height=args.height, width=args.width, max_pairs=args.max_pairs,
        tile_rank_cap=args.tile_rank_cap, trunc_pairs=args.trunc_pairs,
        bwd_pairs=args.bwd_pairs,
    )

    gt_params, init_cloud = make_gt_scene(
        args.gt_gaussians, args.seed, n_clusters=args.gt_clusters,
        scale_mean=args.gt_scale, device=dev,
    )

    views = gt_views(gt_params, args.views, cfg)
    print(f"rendered {len(views)} GT views at {args.width}x{args.height}")

    # Noisy initialization: GT cloud positions + noise, colors kept;
    # optionally subsampled so ADC must clone/split to recover density.
    noisy = init_cloud.copy()
    if args.init_fraction < 1.0:
        keep = np.random.default_rng(3).choice(
            len(noisy), max(int(len(noisy) * args.init_fraction), 16),
            replace=False,
        )
        noisy = noisy[keep]
        print(f"sparse init: {len(noisy)} of {len(init_cloud)} points")
    noisy[:, :3] += np.random.default_rng(2).normal(0, 0.05, (len(noisy), 3))

    tcfg = TrainConfig(
        iterations=args.iterations,
        batch_size=args.batch_size,
        capacity=args.capacity,
        densification_interval=100,
        densify_until_iter=args.iterations // 2,
        opacity_reset_interval=10**9,
        checkpoint_interval=10**9,
        position_lr_max_steps=args.iterations,
        max_grad=args.max_grad,
        adc_mode=args.adc_mode,
        densify_grad_threshold=args.densify_grad_threshold,
        # Scene extent for the paper-ADC size rules: the GT cloud spread.
        scene_extent=float(
            np.linalg.norm(
                init_cloud[:, :3].max(0) - init_cloud[:, :3].min(0)
            ) / 2.0
        ),
    )

    t0 = time.time()
    state, report = fit(
        _Views(views), cfg, tcfg,
        output_dir=args.output_dir,
        initial_points=noisy,
        log_every=max(args.iterations // 8, 1),
        seed=args.seed,
        device=dev,
    )
    dt = time.time() - t0

    result = evaluate_views(
        state.pool.params, views, cfg, alive=state.pool.alive
    )
    steps_per_s = args.iterations / report.wall_time_s
    print(
        f"RESULT psnr={result['psnr']:.2f}dB ssim={result['ssim']:.4f} "
        f"gaussians={report.num_gaussians} "
        f"steps_per_s={steps_per_s:.2f} wall={dt:.1f}s"
    )
    return dict(result, steps_per_s=steps_per_s,
                gaussians=report.num_gaussians)


if __name__ == "__main__":
    main()

"""Train on a real photograph through the textured-plane warp scenes.

Counterpart of ``scripts/train_photo.py``. The ground-truth views are made
by ray-plane homography warping of a photograph (``data/photo_plane.py``),
not by any gaussian renderer, so the run checks the whole optimization on
natural image statistics without a download. Reports held-out PSNR/SSIM as
one JSON line. Run as

    python -m gsplat_tpu_torch.train_photo --image photo.jpg --planes 3

``--image matplotlib`` (the default) needs matplotlib's sample data.
"""

from __future__ import annotations

import argparse
import json
import os
import time


def main(argv=None):
    """Parse ``argv``, build the scene, train, evaluate the held-out views;
    print and return the JSON result (with ``nonfinite_steps``, the NaN
    guard's skipped updates)."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--image", default="matplotlib",
                   help="photo path ('matplotlib' = matplotlib's sample "
                        "photograph)")
    p.add_argument("--output_dir", default="output/photo_plane")
    p.add_argument("--scene_dir", default=None,
                   help="where to write the warped scene "
                        "(default <output_dir>/scene)")
    p.add_argument("--n_views", type=int, default=16)
    p.add_argument("--planes", type=int, default=1,
                   help="number of stacked textured planes (1 = a single "
                        "plane; 2-4 add occlusion boundaries and parallax "
                        "between depth layers)")
    p.add_argument("--height", type=int, default=240)
    p.add_argument("--width", type=int, default=320)
    p.add_argument("--iterations", type=int, default=2000)
    p.add_argument("--capacity", type=int, default=2**15)
    p.add_argument("--max_pairs", type=int, default=2**19)
    p.add_argument("--holdout_every", type=int, default=8)
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--batched_render", action="store_true")
    p.add_argument("--sh_warmup_interval", type=int, default=0)
    p.add_argument("--adc_mode", default="paper",
                   choices=("reference", "paper"),
                   help="densification rule ('paper': the view-space "
                        "gradient statistic)")
    p.add_argument("--max_grad", type=float, default=2e-5,
                   help="reference-mode world-space grad threshold (the "
                        "JAX package's TrainConfig default, 0.01, never "
                        "fires on this scene)")
    p.add_argument("--densify_grad_threshold", type=float, default=None,
                   help="paper-mode view-space grad threshold in px "
                        "(TrainConfig default 2e-4)")
    p.add_argument("--scene_extent", type=float, default=2.8,
                   help="paper-mode scene extent (camera arc radius of the "
                        "plane scene)")
    p.add_argument("--percent_dense", type=float, default=None)
    p.add_argument("--opacity_reset_interval", type=int, default=None,
                   help="default: off for runs shorter than 6000 iterations "
                        "(a reset near the end leaves no time to recover)")
    p.add_argument("--densification_interval", type=int, default=None)
    p.add_argument("--backend", default="auto",
                   choices=("auto", "pallas", "xla"))
    p.add_argument("--json", action="store_true", help="print JSON only")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)

    from .config import RenderConfig, TrainConfig
    from .data import GaussianDataset
    from .data.photo_plane import (
        load_photo,
        make_photo_multiplane_scene,
        make_photo_plane_scene,
    )
    from .evaluation import evaluate_views
    from .train.fit import fit

    scene_dir = args.scene_dir or os.path.join(args.output_dir, "scene")
    photo = load_photo(args.image)
    if args.planes > 1:
        meta = make_photo_multiplane_scene(
            scene_dir, photo=photo, n_planes=args.planes,
            n_views=args.n_views, height=args.height, width=args.width,
        )
    else:
        meta = make_photo_plane_scene(
            scene_dir, photo=photo, n_views=args.n_views,
            height=args.height, width=args.width,
        )
    log = (lambda s: None) if args.json else print
    log(f"scene: {meta['n_views']} warped views of a "
        f"{photo.shape[1]}x{photo.shape[0]} photo -> {scene_dir}")

    train_ds = GaussianDataset(
        scene_dir, scale_factor=1.0,
        holdout_every=args.holdout_every, split="train",
    )
    render_cfg = RenderConfig(
        height=train_ds.height, width=train_ds.width,
        max_pairs=args.max_pairs, backend=args.backend,
    )
    adc_kw = {}
    if args.max_grad is not None:
        adc_kw["max_grad"] = args.max_grad
    if args.densify_grad_threshold is not None:
        adc_kw["densify_grad_threshold"] = args.densify_grad_threshold
    if args.percent_dense is not None:
        adc_kw["percent_dense"] = args.percent_dense
    if args.densification_interval is not None:
        adc_kw["densification_interval"] = args.densification_interval
    # Opacity resets need thousands of iterations of recovery; off for
    # runs shorter than two reset intervals.
    reset = (args.opacity_reset_interval
             if args.opacity_reset_interval is not None
             else (3000 if args.iterations >= 6000 else 10**9))
    train_cfg = TrainConfig(
        iterations=args.iterations,
        batch_size=args.batch_size,
        capacity=args.capacity,
        position_lr_max_steps=args.iterations,
        adc_mode=args.adc_mode,
        scene_extent=args.scene_extent,
        opacity_reset_interval=reset,
        batched_render=args.batched_render,
        sh_warmup_interval=args.sh_warmup_interval,
        checkpoint_interval=10**9,
        **adc_kw,
    )
    t0 = time.time()
    state, report = fit(
        train_ds, render_cfg, train_cfg,
        output_dir=args.output_dir, log_fn=log, device=args.device,
    )
    train_s = time.time() - t0

    test_ds = GaussianDataset(
        scene_dir, scale_factor=1.0,
        holdout_every=args.holdout_every, split="test",
    )
    views = [test_ds[i] for i in range(len(test_ds))]
    result = evaluate_views(
        state.pool.params, views, render_cfg, alive=state.pool.alive
    )
    out = {
        "metric": "photo_plane_holdout_psnr",
        "planes": args.planes,
        "psnr": round(result["psnr"], 3),
        "ssim": round(result["ssim"], 4),
        "holdout_views": result["num_views"],
        "train_views": len(train_ds),
        "iterations": args.iterations,
        "gaussians": int(state.pool.alive.sum()),
        "train_seconds": round(train_s, 1),
        "final_loss": round(report.final_loss, 5),
        "nonfinite_steps": report.nonfinite_steps,
        "adc_mode": args.adc_mode,
        "n_views": args.n_views,
        "eval_max_pair_demand": result.get("max_pair_demand"),
        "eval_max_pairs": result.get("eval_max_pairs"),
        "per_view_psnr": [round(v["psnr"], 2) for v in result["per_view"]],
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()

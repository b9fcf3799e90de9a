"""Re-evaluate a trained checkpoint on a prepared scene's holdout split.

Counterpart of ``scripts/eval_checkpoint.py``. ``evaluate_views`` sizes
its capacity from the probed demand, so the score does not depend on the
training run's capacities. Run as

    python -m gsplat_tpu_torch.eval_checkpoint \\
        --checkpoint output/garden/checkpoint_final.npz \\
        --scene_dir data/garden --holdout_every 8
"""

from __future__ import annotations

import argparse
import json


def main(argv=None):
    """Parse ``argv``, evaluate, print the JSON line and return it as a
    dict."""
    from .utils.compile_cache import enable_compilation_cache

    enable_compilation_cache()  # the kernel builds' directory
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--scene_dir", required=True)
    ap.add_argument("--holdout_every", type=int, default=8)
    ap.add_argument("--split", default="test", choices=("test", "train",
                                                        "all"))
    ap.add_argument("--max_pairs", type=int, default=2**20,
                    help="starting capacity (grown from the demand)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    from .config import RenderConfig
    from .data import GaussianDataset
    from .evaluation import evaluate_views
    from .train.trainer import restore_pool

    pool = restore_pool(args.checkpoint, device=args.device)
    ds = GaussianDataset(args.scene_dir, scale_factor=1.0,
                         holdout_every=args.holdout_every, split=args.split)
    cfg = RenderConfig(height=ds.height, width=ds.width,
                       max_pairs=args.max_pairs)
    views = [ds[i] for i in range(len(ds))]
    result = evaluate_views(pool.params, views, cfg, alive=pool.alive)
    out = {
        "metric": "checkpoint_eval",
        "checkpoint": args.checkpoint,
        "split": args.split,
        "psnr": round(result["psnr"], 3),
        "ssim": round(result["ssim"], 4),
        "num_views": result["num_views"],
        "gaussians": int(pool.alive.sum()),
        "max_pair_demand": result["max_pair_demand"],
        "eval_max_pairs": result["eval_max_pairs"],
        "per_view_psnr": [round(v["psnr"], 2) for v in result["per_view"]],
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()

"""Evaluate a trained checkpoint: PSNR / SSIM / L1 over dataset views.

Counterpart of ``scripts/evaluate.py``. Run as

    python -m gsplat_tpu_torch.evaluate --checkpoint output/garden \\
        --data_dir data/garden --holdout_every 8

``--holdout_every`` N evaluates the held-out test views (every Nth, as in
training). ``--spmd`` evaluates over a ``(data, tile)`` grid of
``--spmd_ranks`` processes (default: the launcher's world, else one per
card; ``--dist_backend gloo`` shares one card): views over ``data``,
frames in ``--spmd_bands`` bands over ``tile``.
"""

from __future__ import annotations

import argparse
import json


def main(argv=None):
    """Parse ``argv``, evaluate, print and return ``evaluate_views``'s
    result."""
    from .utils.compile_cache import enable_compilation_cache

    enable_compilation_cache()  # the kernel builds' directory
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--data_dir", required=True)
    p.add_argument("--scale_factor", type=float, default=0.5)
    p.add_argument("--max_views", type=int, default=None)
    p.add_argument("--holdout_every", type=int, default=0,
                   help="evaluate on the held-out test views (every Nth; "
                        "must match the --holdout_every used in training)")
    p.add_argument("--max_pairs", type=int, default=2**21)
    p.add_argument("--cull_mode", default="rect",
                   choices=("rect", "ellipse"),
                   help="tile culling granularity (ellipse: exact per-row "
                        "ellipse intervals, fewer pairs)")
    p.add_argument("--transmittance_math", default="cumprod",
                   choices=("log", "cumprod"))
    p.add_argument("--tile_rank_cap", type=int, default=0,
                   help="keep only the front-most K pairs per tile; 0 = "
                        "exact")
    p.add_argument("--background", default="black",
                   help="render background: 'black', 'white', or 'r,g,b'")
    p.add_argument("--aa_mode", default="none",
                   choices=("none", "dilate", "mip"),
                   help="screen-space antialiasing: 'dilate' adds the 0.3 px "
                        "low-pass, 'mip' also compensates opacity")
    p.add_argument("--backend", default="auto",
                   choices=("auto", "pallas", "xla"))
    p.add_argument("--json", action="store_true", help="print JSON only")
    p.add_argument("--render_batch", type=int, default=1,
                   help="views rendered per launch via the shared-binning "
                        "batched path")
    p.add_argument("--spmd", action="store_true",
                   help="evaluate over a (data, tile) process grid: views "
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
    """Evaluate on one device, or on this rank of ``mesh``."""

    from .config import RenderConfig, parse_background
    from .data import GaussianDataset
    from .evaluation import evaluate_views
    from .render_trained import load_params, resolve_checkpoint

    params, alive = load_params(
        resolve_checkpoint(args.checkpoint),
        device=args.device if mesh is None else mesh.device)
    ds = GaussianDataset(
        args.data_dir, scale_factor=args.scale_factor,
        holdout_every=args.holdout_every,
        split="test" if args.holdout_every else "all",
    )
    cfg = RenderConfig(height=ds.height, width=ds.width,
                       max_pairs=args.max_pairs, backend=args.backend,
                       cull_mode=args.cull_mode,
                       transmittance_math=args.transmittance_math,
                       tile_rank_cap=args.tile_rank_cap,
                       aa_mode=args.aa_mode,
                       background=parse_background(args.background))
    n = len(ds) if args.max_views is None else min(len(ds), args.max_views)
    views = [ds[i] for i in range(n)]
    result = evaluate_views(params, views, cfg, alive=alive,
                            render_batch=args.render_batch, mesh=mesh)
    if args.json:
        print(json.dumps(result))
    else:
        print(
            f"{result['num_views']} views: PSNR {result['psnr']:.2f} dB  "
            f"SSIM {result['ssim']:.4f}  L1 {result['l1']:.4f}"
        )
    return result


if __name__ == "__main__":
    main()

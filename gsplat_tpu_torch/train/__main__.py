"""Train a 3D Gaussian Splatting scene from a prepared dataset.

Counterpart of ``scripts/train.py`` (every flag), driving the port's
``fit()`` on one device or over a ``(data, tile)`` process grid. Run as

    python -m gsplat_tpu_torch.prepare_dataset mipnerf \\
        --input_dir data/raw/garden --output_dir data/garden
    python -m gsplat_tpu_torch.train --data_dir data/garden \\
        --output_dir output/garden

The dataset's point cloud starts the pool, and its views are kept on the
card once when they fit ``fit()``'s device cache. ``--mesh_data D
--mesh_tile T`` trains over a grid of D*T processes (views over ``data``,
image bands over ``tile``): under ``torchrun --nproc_per_node D*T`` each
process joins the launched world; a plain ``python -m`` starts the D*T
workers itself. ``--dist_backend gloo`` lets several ranks share one card
(NCCL needs one card per rank). ``--gauss_sharded`` shards the pool,
its gradients and Adam moments over the tile axis (the ZeRO-style step;
with ``--ring`` the gaussians stream around the tile ring instead of one
all-gather); on one rank it is ignored, as in the JAX script. ``--device
cpu`` runs the plain PyTorch path.
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--data_dir", required=True, help="prepared dataset dir")
    p.add_argument("--output_dir", default="output")
    p.add_argument("--iterations", type=int, default=30000)
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--scale_factor", type=float, default=0.5,
                   help="image resolution multiplier (0.5 = half size)")
    p.add_argument("--holdout_every", type=int, default=0,
                   help="hold out every Nth view for evaluation (llffhold "
                        "protocol; 8 in the 3DGS papers; 0 = train on all)")
    p.add_argument("--capacity", type=int, default=2**17,
                   help="gaussian pool capacity (grows on ADC overflow)")
    p.add_argument("--max_pairs", type=int, default=2**21)
    p.add_argument("--cull_mode", default="rect",
                   choices=("rect", "ellipse"),
                   help="tile culling granularity (ellipse: exact per-row "
                        "ellipse intervals, fewer pairs)")
    p.add_argument("--transmittance_math", default="cumprod",
                   choices=("log", "cumprod"))
    p.add_argument("--bwd_pairs", type=int, default=0,
                   help="compacted backward: capacity of the composited "
                        "block list in pairs (0 = off; fit() grows it on "
                        "overflow, demand reported)")
    p.add_argument("--tile_rank_cap", type=int, default=0,
                   help="keep only the front-most K pairs per tile; 0 = "
                        "exact")
    p.add_argument("--background", default="black",
                   help="render background: 'black', 'white', or 'r,g,b'")
    p.add_argument("--aa_mode", default="none",
                   choices=("none", "dilate", "mip"),
                   help="screen-space antialiasing: 'dilate' adds the 0.3 px "
                        "low-pass, 'mip' also compensates opacity")
    p.add_argument("--sh_bands", type=int, default=3, choices=(0, 1, 2, 3))
    p.add_argument("--position_lr_init", type=float, default=0.00016)
    p.add_argument("--position_lr_final", type=float, default=0.0000016)
    p.add_argument("--feature_lr", type=float, default=0.0025)
    p.add_argument("--opacity_lr", type=float, default=0.05)
    p.add_argument("--scaling_lr", type=float, default=0.005)
    p.add_argument("--rotation_lr", type=float, default=0.001)
    p.add_argument("--lambda_l1", type=float, default=0.8)
    p.add_argument("--lambda_ssim", type=float, default=0.2)
    p.add_argument("--densification_interval", type=int, default=100)
    p.add_argument("--densify_until_iter", type=int, default=15000)
    p.add_argument("--opacity_reset_interval", type=int, default=3000)
    p.add_argument("--checkpoint_interval", type=int, default=1000)
    p.add_argument("--resume_from", default=None)
    p.add_argument("--backend", default="auto",
                   choices=("auto", "pallas", "xla"))
    p.add_argument("--adc_mode", default="reference",
                   choices=("reference", "paper"),
                   help="density control rules: the world-space-gradient "
                        "variant, or the original paper's view-space "
                        "statistic with scene-extent rules")
    p.add_argument("--sh_warmup_interval", type=int, default=0,
                   help="activate SH band b at iteration b*interval (0 = "
                        "all bands from iteration 0)")
    p.add_argument("--batched_render", action="store_true",
                   help="render the whole view batch through one shared "
                        "binning and one compositor launch per step")
    p.add_argument("--densify_grad_threshold", type=float, default=0.0002,
                   help="paper-ADC view-space gradient threshold (px)")
    p.add_argument("--max_screen_size", type=int, default=0,
                   help="paper-ADC screen-size prune in px (0 = off)")
    p.add_argument("--mesh_data", type=int, default=1,
                   help="devices along the data (view) mesh axis")
    p.add_argument("--mesh_tile", type=int, default=1,
                   help="devices along the tile (image band) mesh axis")
    p.add_argument("--dist_backend", default="nccl",
                   choices=("nccl", "gloo"),
                   help="collectives of the grid (gloo: through host "
                        "memory, several ranks per card)")
    p.add_argument("--gauss_sharded", action="store_true",
                   help="shard pool/grads/optimizer over the tile axis "
                        "(ZeRO-style; for large scenes)")
    p.add_argument("--ring", action="store_true",
                   help="with --gauss_sharded: stream gaussian blocks "
                        "around the tile ring instead of all-gathering the "
                        "full set")
    p.add_argument("--log_every", type=int, default=50)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    return p


def main(argv=None):
    """Parse ``argv``, train, and return ``(state, report)`` of ``fit()``;
    over a grid ``(None, report)``: rank 0's report (its checkpoints hold
    the state)."""
    from ..utils.compile_cache import enable_compilation_cache

    enable_compilation_cache()  # the kernel builds' directory
    args = build_parser().parse_args(argv)
    n_ranks = args.mesh_data * args.mesh_tile
    if n_ranks > 1:
        from ..parallel.mesh import cli_rank, grid_device, launch

        # Rank 0 prints, writes and returns the report.
        return None, launch(cli_rank, n_ranks, args.dist_backend,
                            grid_device(args.device),
                            args=(_grid_train, args, args.mesh_data,
                                  args.mesh_tile))
    return _train(args)


def _grid_train(args, mesh):
    """One rank of the grid: ``fit()`` over ``mesh``; the report."""
    print(f"mesh: data={args.mesh_data} x tile={args.mesh_tile} over "
          f"{mesh.size} {mesh.backend} ranks")
    return _train(args, mesh)[1]


def _train(args, mesh=None):
    """Train on one device, or on this rank of ``mesh``."""

    from ..config import RenderConfig, TrainConfig, parse_background
    from ..data import GaussianDataset
    from .fit import fit

    dataset = GaussianDataset(
        args.data_dir, scale_factor=args.scale_factor,
        holdout_every=args.holdout_every,
        split="train" if args.holdout_every else "all",
    )
    print(
        f"dataset: {len(dataset)} views at {dataset.width}x{dataset.height}, "
        f"fx={dataset.fx:.1f}"
    )
    render_cfg = RenderConfig(
        height=dataset.height,
        width=dataset.width,
        max_pairs=args.max_pairs,
        backend=args.backend,
        cull_mode=args.cull_mode,
        transmittance_math=args.transmittance_math,
        tile_rank_cap=args.tile_rank_cap,
        bwd_pairs=args.bwd_pairs,
        aa_mode=args.aa_mode,
        background=parse_background(args.background),
    )
    train_cfg = TrainConfig(
        iterations=args.iterations,
        batch_size=args.batch_size,
        capacity=args.capacity,
        position_lr_init=args.position_lr_init,
        position_lr_final=args.position_lr_final,
        position_lr_max_steps=args.iterations,
        feature_lr=args.feature_lr,
        opacity_lr=args.opacity_lr,
        scaling_lr=args.scaling_lr,
        rotation_lr=args.rotation_lr,
        lambda_l1=args.lambda_l1,
        lambda_ssim=args.lambda_ssim,
        densification_interval=args.densification_interval,
        densify_until_iter=args.densify_until_iter,
        opacity_reset_interval=args.opacity_reset_interval,
        checkpoint_interval=args.checkpoint_interval,
        num_sh_bands=args.sh_bands,
        adc_mode=args.adc_mode,
        densify_grad_threshold=args.densify_grad_threshold,
        max_screen_size=args.max_screen_size,
        sh_warmup_interval=args.sh_warmup_interval,
        batched_render=args.batched_render,
    )
    state, report = fit(
        dataset,
        render_cfg,
        train_cfg,
        output_dir=args.output_dir,
        resume_from=args.resume_from,
        mesh=mesh,
        gauss_sharded=("ring" if args.ring else True)
        if args.gauss_sharded else False,
        log_every=args.log_every,
        seed=args.seed,
        device=args.device,
    )
    print(
        f"done: {report.iterations} iters in {report.wall_time_s:.1f}s, "
        f"final loss {report.final_loss:.5f}, "
        f"{report.num_gaussians} gaussians, "
        f"checkpoints in {args.output_dir}"
    )
    return state, report


if __name__ == "__main__":
    main()

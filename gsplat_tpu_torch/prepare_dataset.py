"""Prepare datasets for training: Mip-NeRF 360, COLMAP, or a download.

Counterpart of ``scripts/prepare_dataset.py``, with its subcommands:

    python -m gsplat_tpu_torch.prepare_dataset download \\
        --scene garden --output_dir data/raw
    python -m gsplat_tpu_torch.prepare_dataset mipnerf \\
        --input_dir data/raw/garden --output_dir data/garden
    python -m gsplat_tpu_torch.prepare_dataset colmap \\
        --image_dir photos/ --output_dir data/myscene

Each writes the layout ``data.GaussianDataset`` reads (images/,
cam_meta.npy, poses.npy, pointcloud.ply). ``colmap`` runs the ``colmap``
binary unless ``--sparse_dir`` names an existing model; ``download``
needs the network.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    """Parse ``argv`` and run the subcommand; returns its summary (the
    scene directory for ``download``)."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="cmd", required=True)

    d = sub.add_parser("download", help="fetch a Mip-NeRF 360 scene")
    d.add_argument("--scene", default="garden")
    d.add_argument("--output_dir", default="data/raw")

    m = sub.add_parser("mipnerf", help="convert a Mip-NeRF 360 scene dir")
    m.add_argument("--input_dir", required=True)
    m.add_argument("--output_dir", required=True)
    m.add_argument("--scene_name", default="scene")
    m.add_argument("--downsample", type=int, default=4,
                   help="image downsample factor (4 = quarter res)")
    m.add_argument("--max_images", type=int, default=None)

    c = sub.add_parser("colmap", help="run COLMAP SfM on raw images")
    c.add_argument("--image_dir", required=True)
    c.add_argument("--output_dir", required=True)
    c.add_argument("--workspace", default=None,
                   help="COLMAP workspace (default: output_dir/colmap)")
    c.add_argument("--sparse_dir", default=None,
                   help="existing sparse/0 model (skips running COLMAP)")
    c.add_argument("--downscale", type=float, default=1.0)
    c.add_argument("--camera_model", default="SIMPLE_PINHOLE")

    args = p.parse_args(argv)

    if args.cmd == "download":
        from .data.download import download_mipnerf360_scene

        path = download_mipnerf360_scene(args.scene, args.output_dir)
        print(f"scene at {path}")
        return path

    if args.cmd == "mipnerf":
        from .data.mipnerf import prepare_mipnerf360_dataset

        info = prepare_mipnerf360_dataset(
            args.input_dir,
            args.output_dir,
            scene_name=args.scene_name,
            image_downsample=args.downsample,
            max_images=args.max_images,
        )
        print(
            f"prepared {info['num_images']} images, "
            f"{info['num_points']} init points -> {args.output_dir}"
        )
        print(f"train: python -m gsplat_tpu_torch.train --data_dir "
              f"{args.output_dir}")
        return info

    from .data.colmap import (
        convert_colmap_to_training_format,
        run_colmap_reconstruction,
    )

    sparse = args.sparse_dir
    if sparse is None:
        ws = args.workspace or os.path.join(args.output_dir, "colmap")
        sparse = run_colmap_reconstruction(
            args.image_dir, ws, camera_model=args.camera_model
        )
    info = convert_colmap_to_training_format(
        sparse, args.image_dir, args.output_dir, downscale=args.downscale
    )
    print(
        f"prepared {info['num_images']} images, "
        f"{info['num_points']} points -> {args.output_dir}"
    )
    return info


if __name__ == "__main__":
    main()

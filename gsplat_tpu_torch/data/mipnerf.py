"""Mip-NeRF 360 dataset preparation -> the training layout.

Counterpart of ``gsplat_tpu/data/mipnerf.py``: ``load_poses_bounds``
(``:25``), ``load_transforms_json`` (``:63``), ``_pick_image_dir``
(``:81``) and ``prepare_mipnerf360_dataset`` (``:104``). The points3D.bin
parser is ``data/colmap.py``'s and the PLY writer ``data/pointcloud.py``'s.

The emitted layout is what GaussianDataset consumes:
    output_dir/images/*.png, cam_meta.npy, poses.npy, pointcloud.ply
"""

from __future__ import annotations

import json
import os

import numpy as np

from .colmap import read_points3d_binary
from .images import list_images, load_image, save_image
from .pointcloud import write_ply


def load_poses_bounds(path: str) -> dict:
    """Parse poses_bounds.npy [N, 17] (LLFF/Mip-NeRF 360 convention).

    Layout per row: a 3x5 matrix flattened row-major — 3x4 c2w with the
    LLFF (down, right, backwards)->... axis convention plus a 5th column
    (height, width, focal) — followed by (near, far) bounds.

    The hwf column sits inside the 3x5 block (LLFF's layout). The LLFF
    axis order is converted to the renderer's z-forward OpenCV convention
    (right, down, forward): the convention data/colmap.py and
    viewer.look_at emit, and the one ops/projection.py culls against
    (in_front = z > 0).
    """
    pb = np.load(path)
    n = pb.shape[0]
    mat = pb[:, :15].reshape(n, 3, 5)
    bounds = pb[:, 15:17]
    hwf = mat[:, :, 4]  # [N, 3] = (height, width, focal)
    poses = mat[:, :, :4]  # [N, 3, 4] in LLFF axes (down, right, back)
    # LLFF columns (c0, c1, c2) = (down, right, back) -> OpenCV z-forward
    # columns (right, down, forward) = (c1, c0, -c2). Translation unchanged.
    fixed = np.concatenate(
        [poses[:, :, 1:2], poses[:, :, 0:1], -poses[:, :, 2:3],
         poses[:, :, 3:4]], axis=2
    )
    c2w = np.zeros((n, 4, 4), np.float32)
    c2w[:, :3, :4] = fixed
    c2w[:, 3, 3] = 1.0
    return {
        "c2w": c2w,
        "bounds": bounds.astype(np.float32),
        "hwf": hwf.astype(np.float32),
        "num_images": n,
    }


def load_transforms_json(path: str) -> dict:
    """Parse NeRF-style transforms_train.json -> poses + intrinsics."""
    with open(path) as f:
        data = json.load(f)
    frames = data.get("frames", [])
    c2w = np.asarray(
        [f["transform_matrix"] for f in frames], np.float32
    ).reshape(-1, 4, 4)
    files = [f.get("file_path", "") for f in frames]
    out = {"c2w": c2w, "file_paths": files, "num_images": len(frames)}
    if "camera_angle_x" in data:
        out["camera_angle_x"] = float(data["camera_angle_x"])
    for k in ("fl_x", "fl_y", "cx", "cy", "w", "h"):
        if k in data:
            out[k] = float(data[k])
    return out


def _pick_image_dir(input_dir: str, downsample: int) -> tuple[str, int]:
    """Prefer pre-downsampled images_N directories when present.

    Returns (dir, effective_downsample): the factor the chosen directory's
    images are ALREADY downsampled by relative to the full-res originals
    that poses_bounds.npy describes. When only an images_N directory exists
    the effective factor is N even if the caller asked for 1 — the caller
    must fold it into intrinsic scaling or projection silently breaks.
    """
    if downsample > 1:
        cand = os.path.join(input_dir, f"images_{downsample}")
        if os.path.isdir(cand):
            return cand, downsample
    for name, native in (
        ("images", 1), ("images_2", 2), ("images_4", 4), ("images_8", 8)
    ):
        cand = os.path.join(input_dir, name)
        if os.path.isdir(cand):
            return cand, native
    raise FileNotFoundError(f"no images directory under {input_dir}")


def prepare_mipnerf360_dataset(
    input_dir: str,
    output_dir: str,
    scene_name: str = "garden",
    use_colmap_points: bool = True,
    image_downsample: int = 1,
    max_images: int | None = None,
) -> dict:
    """Convert a Mip-NeRF 360 scene directory to the training layout.

    Accepts either poses_bounds.npy (LLFF) or transforms_train.json (NeRF)
    pose sources, copies/downsamples images, and emits cam_meta.npy /
    poses.npy / pointcloud.ply (from sparse/0/points3D.bin when available).
    """
    os.makedirs(os.path.join(output_dir, "images"), exist_ok=True)

    pb_path = os.path.join(input_dir, "poses_bounds.npy")
    tj_path = os.path.join(input_dir, "transforms_train.json")

    image_dir, native_ds = _pick_image_dir(input_dir, image_downsample)
    image_paths = list_images(image_dir)
    # The chosen directory's images are already 1/native_ds of the full-res
    # originals that poses_bounds describes. Rescale on the fly only for the
    # remaining factor (never upsample), and fold the TOTAL factor into the
    # intrinsics so cam_meta always matches the emitted pixels.
    total_ds = max(image_downsample, native_ds, 1)
    scale = native_ds / total_ds
    intrinsic_scale = 1.0 / total_ds

    if os.path.exists(pb_path):
        poses_data = load_poses_bounds(pb_path)
        c2w = poses_data["c2w"]
        h0, w0, focal = poses_data["hwf"][0]
        fx = fy = float(focal) * intrinsic_scale
        width = int(round(w0 * intrinsic_scale))
        height = int(round(h0 * intrinsic_scale))
        cx, cy = width / 2.0, height / 2.0
    elif os.path.exists(tj_path):
        tj = load_transforms_json(tj_path)
        c2w = tj["c2w"]
        width = int(tj.get("w", 0)) or None
        if "fl_x" in tj:
            fx = tj["fl_x"] * intrinsic_scale
            fy = tj.get("fl_y", tj["fl_x"]) * intrinsic_scale
        elif "camera_angle_x" in tj and width:
            fx = fy = (
                0.5 * width / np.tan(0.5 * tj["camera_angle_x"])
            ) * intrinsic_scale
        else:
            raise ValueError("transforms json lacks focal information")
        first = load_image(image_paths[0], scale)
        height, width = first.shape[:2]
        # width/height above are ALREADY downsampled (loaded pixels); only
        # scale cx/cy when they come from the json (full-res values).
        cx = tj["cx"] * intrinsic_scale if "cx" in tj else width / 2.0
        cy = tj["cy"] * intrinsic_scale if "cy" in tj else height / 2.0
    else:
        raise FileNotFoundError(
            f"{input_dir}: neither poses_bounds.npy nor transforms_train.json"
        )

    n = min(len(image_paths), c2w.shape[0])
    if max_images is not None:
        n = min(n, max_images)
    for i in range(n):
        img = load_image(image_paths[i], scale)
        save_image(os.path.join(output_dir, "images", f"{i:05d}.png"), img)

    meta = {
        "fx": fx, "fy": fy, "cx": cx, "cy": cy,
        "width": width, "height": height, "scene": scene_name,
    }
    np.save(os.path.join(output_dir, "cam_meta.npy"), meta, allow_pickle=True)
    np.save(os.path.join(output_dir, "poses.npy"), c2w[:n])

    num_points = 0
    if use_colmap_points:
        for sparse in ("sparse/0", "sparse"):
            p3d = os.path.join(input_dir, sparse, "points3D.bin")
            if os.path.exists(p3d):
                points = read_points3d_binary(p3d)
                if points.size:
                    write_ply(
                        os.path.join(output_dir, "pointcloud.ply"), points
                    )
                    num_points = int(points.shape[0])
                break

    return {
        "num_images": n,
        "num_points": num_points,
        "intrinsics": meta,
        "output_dir": output_dir,
    }

"""COLMAP integration: the binary model parsers, pose helpers, the
reconstruction pipeline and the conversion to the training layout.

Counterpart of ``gsplat_tpu/data/colmap.py``: ``read_cameras_binary``
(``:45``), ``read_images_binary`` (``:65``), ``read_points3d_binary``
(``:96``), the pose helpers (``:119-140``), ``run_colmap_reconstruction``
(``:151``, which runs the ``colmap`` binary) and
``convert_colmap_to_training_format`` (``:192``). The record layouts are
the public COLMAP file format's.

Quaternions: COLMAP stores (w, x, y, z); the renderer uses (x, y, z, w)
(``ops/gaussian.py``). The conversion happens here, in
:func:`qvec_wxyz_to_rotmat`, so nothing downstream sees COLMAP's order.
"""

from __future__ import annotations

import os
import shutil
import struct
import subprocess

import numpy as np

from .images import load_image, save_image
from .pointcloud import write_ply

# model_id -> (name, num_params); params ordering per COLMAP docs.
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),  # f, cx, cy
    1: ("PINHOLE", 4),  # fx, fy, cx, cy
    2: ("SIMPLE_RADIAL", 4),  # f, cx, cy, k
    3: ("RADIAL", 5),  # f, cx, cy, k1, k2
    4: ("OPENCV", 8),  # fx, fy, cx, cy, k1, k2, p1, p2
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}


def read_cameras_binary(path: str) -> dict:
    """Parse cameras.bin -> {camera_id: dict(model, width, height, params)}."""
    cameras = {}
    with open(path, "rb") as f:
        num = struct.unpack("<Q", f.read(8))[0]
        for _ in range(num):
            cam_id, model_id, width, height = struct.unpack(
                "<iiQQ", f.read(24)
            )
            name, n_params = CAMERA_MODELS[model_id]
            params = struct.unpack(f"<{n_params}d", f.read(8 * n_params))
            cameras[cam_id] = {
                "model": name,
                "width": int(width),
                "height": int(height),
                "params": np.asarray(params, np.float64),
            }
    return cameras


def read_images_binary(path: str) -> dict:
    """Parse images.bin -> {image_id: dict(qvec, tvec, camera_id, name)}.

    qvec is COLMAP (w, x, y, z); tvec is the world->camera translation.
    2D point observations are skipped (not needed for training).
    """
    images = {}
    with open(path, "rb") as f:
        num = struct.unpack("<Q", f.read(8))[0]
        for _ in range(num):
            image_id = struct.unpack("<I", f.read(4))[0]
            qvec = np.asarray(struct.unpack("<4d", f.read(32)))
            tvec = np.asarray(struct.unpack("<3d", f.read(24)))
            camera_id = struct.unpack("<I", f.read(4))[0]
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            n_pts = struct.unpack("<Q", f.read(8))[0]
            f.seek(24 * n_pts, os.SEEK_CUR)  # (x, y, point3D_id) per obs
            images[image_id] = {
                "qvec": qvec,
                "tvec": tvec,
                "camera_id": camera_id,
                "name": name.decode("utf-8"),
            }
    return images


def read_points3d_binary(path: str) -> np.ndarray:
    """Parse points3D.bin -> [N, 6] float32 (xyz + rgb in [0, 1]).

    Variable-length records: xyz (3d), rgb (3B), error (d), then a track of
    (image_id, point2D_idx) pairs.
    """
    pts = []
    with open(path, "rb") as f:
        num = struct.unpack("<Q", f.read(8))[0]
        for _ in range(num):
            f.read(8)  # point3D_id
            xyz = struct.unpack("<3d", f.read(24))
            rgb = struct.unpack("<3B", f.read(3))
            f.read(8)  # reprojection error
            track_len = struct.unpack("<Q", f.read(8))[0]
            f.seek(8 * track_len, os.SEEK_CUR)
            pts.append((*xyz, *rgb))
    arr = np.asarray(pts, np.float32)
    if arr.size:
        arr[:, 3:6] /= 255.0
    return arr.reshape(-1, 6)


def qvec_wxyz_to_rotmat(qvec: np.ndarray) -> np.ndarray:
    """COLMAP (w, x, y, z) quaternion -> 3x3 rotation matrix."""
    w, x, y, z = np.asarray(qvec, np.float64) / np.linalg.norm(qvec)
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def colmap_pose_to_c2w(qvec: np.ndarray, tvec: np.ndarray) -> np.ndarray:
    """COLMAP stores world->camera (R, t); invert to camera->world [4, 4]."""
    R = qvec_wxyz_to_rotmat(qvec)
    c2w = np.eye(4)
    c2w[:3, :3] = R.T
    c2w[:3, 3] = -R.T @ np.asarray(tvec, np.float64)
    return c2w.astype(np.float32)


def pinhole_intrinsics(camera: dict) -> tuple[float, float, float, float]:
    """(fx, fy, cx, cy) from any supported model (distortion ignored: a
    pinhole approximation)."""
    p = camera["params"]
    model = camera["model"]
    if model in ("SIMPLE_PINHOLE", "SIMPLE_RADIAL", "RADIAL",
                 "SIMPLE_RADIAL_FISHEYE", "RADIAL_FISHEYE", "FOV"):
        return float(p[0]), float(p[0]), float(p[1]), float(p[2])
    return float(p[0]), float(p[1]), float(p[2]), float(p[3])


def run_colmap_reconstruction(
    image_dir: str,
    workspace: str,
    camera_model: str = "SIMPLE_PINHOLE",
    matcher: str = "exhaustive",
) -> str:
    """Run the COLMAP SfM pipeline (feature_extractor -> matcher -> mapper).

    Requires the ``colmap`` binary on PATH. Returns the sparse model
    directory (workspace/sparse/0).
    """
    if shutil.which("colmap") is None:
        raise RuntimeError(
            "colmap binary not found on PATH; install COLMAP or prepare the "
            "dataset with an existing sparse/ model"
        )
    os.makedirs(workspace, exist_ok=True)
    db = os.path.join(workspace, "database.db")
    sparse = os.path.join(workspace, "sparse")
    os.makedirs(sparse, exist_ok=True)

    def run(*args):
        subprocess.run(["colmap", *args], check=True)

    run(
        "feature_extractor",
        "--database_path", db,
        "--image_path", image_dir,
        "--ImageReader.camera_model", camera_model,
        "--ImageReader.single_camera", "1",
    )
    run(f"{matcher}_matcher", "--database_path", db)
    run(
        "mapper",
        "--database_path", db,
        "--image_path", image_dir,
        "--output_path", sparse,
    )
    return os.path.join(sparse, "0")


def convert_colmap_to_training_format(
    sparse_dir: str,
    image_dir: str,
    output_dir: str,
    downscale: float = 1.0,
) -> dict:
    """sparse/0 model + images -> the training layout consumed by
    GaussianDataset: images/, cam_meta.npy, poses.npy, pointcloud.ply.
    Returns a summary dict.
    """
    cameras = read_cameras_binary(os.path.join(sparse_dir, "cameras.bin"))
    images = read_images_binary(os.path.join(sparse_dir, "images.bin"))
    pts_path = os.path.join(sparse_dir, "points3D.bin")
    points = read_points3d_binary(pts_path) if os.path.exists(pts_path) else None

    os.makedirs(os.path.join(output_dir, "images"), exist_ok=True)

    # Deterministic order by file name, like sorted image globbing.
    entries = sorted(images.values(), key=lambda e: e["name"])
    poses = []
    names = []
    for i, entry in enumerate(entries):
        src = os.path.join(image_dir, entry["name"])
        if not os.path.exists(src):
            continue
        img = load_image(src, scale_factor=downscale)
        dst_name = f"{i:05d}.png"
        save_image(os.path.join(output_dir, "images", dst_name), img)
        poses.append(colmap_pose_to_c2w(entry["qvec"], entry["tvec"]))
        names.append(entry["name"])
    if not poses:
        raise ValueError("no registered COLMAP images matched the image dir")

    cam = cameras[entries[0]["camera_id"]]
    fx, fy, cx, cy = pinhole_intrinsics(cam)
    meta = {
        "fx": fx * downscale,
        "fy": fy * downscale,
        "cx": cx * downscale,
        "cy": cy * downscale,
        "width": int(round(cam["width"] * downscale)),
        "height": int(round(cam["height"] * downscale)),
        "camera_model": cam["model"],
    }
    np.save(os.path.join(output_dir, "cam_meta.npy"), meta, allow_pickle=True)
    np.save(os.path.join(output_dir, "poses.npy"), np.stack(poses))
    if points is not None and points.size:
        write_ply(os.path.join(output_dir, "pointcloud.ply"), points)
    return {
        "num_images": len(poses),
        "num_points": 0 if points is None else int(points.shape[0]),
        "intrinsics": meta,
        "image_names": names,
    }

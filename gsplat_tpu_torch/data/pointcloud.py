"""Point cloud IO: PLY (ASCII and binary) read and write, outlier
filtering, and loading from .ply / .npy / .npz / .pt (host-side numpy).

Counterpart of ``gsplat_tpu/data/pointcloud.py``: ``read_ply`` (``:27``),
``write_ply`` (``:92``), ``filter_outliers`` (``:138``) and
``load_point_cloud`` (``:158``). Binary little-endian PLY, which COLMAP
and Mip-NeRF 360 exports use, is parsed as well as ASCII.
"""

from __future__ import annotations

import numpy as np
import torch

_PLY_DTYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


def read_ply(path: str) -> np.ndarray:
    """Parse a PLY vertex cloud -> [N, 3] or [N, 6] float32 (xyz [+ rgb]).

    Handles ascii and binary_little_endian formats; colors are normalized to
    [0, 1] when stored as uint8.
    """
    with open(path, "rb") as f:
        header_lines = []
        while True:
            line = f.readline().decode("ascii", errors="replace").strip()
            header_lines.append(line)
            if line == "end_header":
                break
            if len(header_lines) > 1000:
                raise ValueError(f"{path}: runaway PLY header")
        fmt = None
        n_vertex = 0
        props: list[tuple[str, str]] = []
        in_vertex = False
        for line in header_lines:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "format":
                fmt = parts[1]
            elif parts[0] == "element":
                in_vertex = parts[1] == "vertex"
                if in_vertex:
                    n_vertex = int(parts[2])
            elif parts[0] == "property" and in_vertex:
                if parts[1] == "list":
                    raise ValueError("list properties unsupported in vertex")
                props.append((parts[2], _PLY_DTYPES[parts[1]]))

        if fmt is None or n_vertex == 0 or not props:
            raise ValueError(f"{path}: malformed PLY header")

        names = [p[0] for p in props]
        if fmt == "ascii":
            rows = []
            for _ in range(n_vertex):
                rows.append(f.readline().split())
            data = np.asarray(rows, dtype=np.float64)
            cols = {name: data[:, i] for i, (name, _) in enumerate(props)}
            color_is_byte = {
                name: dt == "u1" for name, dt in props
            }
        elif fmt == "binary_little_endian":
            dtype = np.dtype([(name, "<" + dt) for name, dt in props])
            raw = np.frombuffer(f.read(dtype.itemsize * n_vertex), dtype=dtype)
            cols = {name: raw[name].astype(np.float64) for name in names}
            color_is_byte = {name: dt == "u1" for name, dt in props}
        else:
            raise ValueError(f"{path}: unsupported PLY format {fmt}")

    xyz = np.stack([cols["x"], cols["y"], cols["z"]], axis=-1)
    out = xyz
    if all(k in cols for k in ("red", "green", "blue")):
        rgb = np.stack([cols["red"], cols["green"], cols["blue"]], axis=-1)
        if color_is_byte.get("red", False) or rgb.max(initial=0.0) > 1.0:
            rgb = rgb / 255.0
        out = np.concatenate([xyz, rgb], axis=-1)
    return out.astype(np.float32)


def write_ply(path: str, points: np.ndarray, binary: bool = True) -> None:
    """Write [N, 3] or [N, 6] points (rgb in [0,1] or [0,255]) as PLY."""
    pts = np.asarray(points, np.float32)
    has_rgb = pts.shape[1] >= 6
    n = pts.shape[0]
    header = ["ply"]
    header.append(
        "format binary_little_endian 1.0" if binary else "format ascii 1.0"
    )
    header += [f"element vertex {n}"]
    header += [f"property float {ax}" for ax in "xyz"]
    if has_rgb:
        header += [f"property uchar {c}" for c in ("red", "green", "blue")]
    header.append("end_header")

    rgb8 = None
    if has_rgb:
        rgb = pts[:, 3:6]
        if rgb.max(initial=0.0) <= 1.0:
            rgb = rgb * 255.0
        rgb8 = np.clip(rgb, 0, 255).astype(np.uint8)

    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        if binary:
            if has_rgb:
                dtype = np.dtype(
                    [("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                     ("red", "u1"), ("green", "u1"), ("blue", "u1")]
                )
                rec = np.empty(n, dtype)
                rec["x"], rec["y"], rec["z"] = pts[:, 0], pts[:, 1], pts[:, 2]
                rec["red"], rec["green"], rec["blue"] = (
                    rgb8[:, 0], rgb8[:, 1], rgb8[:, 2]
                )
                f.write(rec.tobytes())
            else:
                f.write(pts[:, :3].astype("<f4").tobytes())
        else:
            for i in range(n):
                row = f"{pts[i, 0]} {pts[i, 1]} {pts[i, 2]}"
                if has_rgb:
                    row += f" {rgb8[i, 0]} {rgb8[i, 1]} {rgb8[i, 2]}"
                f.write((row + "\n").encode("ascii"))


def filter_outliers(
    points: np.ndarray,
    hard_bound: float = 1000.0,
    percentile: float = 99.5,
) -> np.ndarray:
    """Drop non-finite rows and positions beyond +-hard_bound, then clip
    to a radial percentile around the median."""
    pts = np.asarray(points, np.float32)
    finite = np.isfinite(pts).all(axis=1)
    pts = pts[finite]
    inside = (np.abs(pts[:, :3]) <= hard_bound).all(axis=1)
    pts = pts[inside]
    if pts.shape[0] > 16:
        center = np.median(pts[:, :3], axis=0)
        r = np.linalg.norm(pts[:, :3] - center, axis=1)
        keep = r <= np.percentile(r, percentile)
        pts = pts[keep]
    return pts


def load_point_cloud(path: str, max_points: int | None = None) -> np.ndarray:
    """Load a point cloud (.ply / .npy / .npz / .pt) -> [N, 3|6] float32,
    through :func:`filter_outliers`; more than ``max_points`` are
    subsampled with numpy's ``default_rng(0)``, as the JAX package does.
    A ``.pt`` file is read with ``torch.load(..., weights_only=True)``."""
    if path.endswith(".ply"):
        pts = read_ply(path)
    elif path.endswith(".npy"):
        pts = np.load(path).astype(np.float32)
    elif path.endswith(".npz"):
        data = np.load(path)
        key = "points" if "points" in data else list(data.keys())[0]
        pts = data[key].astype(np.float32)
    elif path.endswith(".pt"):
        pts = torch.load(path, map_location="cpu", weights_only=True)
        pts = np.asarray(pts, np.float32)
    else:
        raise ValueError(f"unsupported point cloud format: {path}")

    pts = filter_outliers(pts)
    if max_points is not None and pts.shape[0] > max_points:
        idx = np.random.default_rng(0).choice(
            pts.shape[0], max_points, replace=False
        )
        pts = pts[idx]
    return pts

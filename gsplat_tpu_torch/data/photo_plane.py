"""Real-photograph textured-plane scenes with ground truth made by
warping.

Counterpart of ``gsplat_tpu/data/photo_plane.py``. A real photograph is
placed on a world-space plane (or several stacked planes) and the views'
ground truth is made by pure ray-plane homography warping: no gaussian
renderer makes the ground truth, so training against it is a
non-circular check with natural image statistics (sharp edges,
high-frequency texture), needing no download.

``make_photo_plane_scene`` and ``make_photo_multiplane_scene`` write a
scene directory in the prepared layout (images/ + poses.npy + cam_meta.npy
+ pointcloud.npy), so ``GaussianDataset``, ``fit()`` and the evaluation
run on it unchanged, holdout splits included. The views' cameras come
from this package's ``viewer.look_at``.
"""

from __future__ import annotations

import os

import numpy as np

DEFAULT_PHOTO = "matplotlib"  # resolves to mpl's bundled real photograph


def load_photo(path_or_default: str = DEFAULT_PHOTO) -> np.ndarray:
    """Load a photo as float [H, W, 3] in [0, 1].

    "matplotlib" resolves to the photograph matplotlib ships as sample
    data (grace_hopper.jpg, a public-domain US Navy portrait).
    """
    if path_or_default == DEFAULT_PHOTO:
        import matplotlib.cbook as cbook

        path = cbook.get_sample_data("grace_hopper.jpg", asfileobj=False)
    else:
        path = path_or_default
    from PIL import Image

    img = np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0
    return img


def _ray_plane_sample(photo, plane, c2w, fx, fy, cx, cy, height, width):
    """Per-pixel (bilinear sample [H,W,3], inside [H,W], ray depth t [H,W])
    of one textured z = const plane.

    ``plane``: {"z": depth, "ox"/"oy": world-space center offset,
    "half_h": half height; half width follows the photo aspect}. Pixel
    centers are at integer coordinates, the rasterizer's convention.
    """
    ht, wt = photo.shape[:2]
    half_h = plane["half_h"]
    half_w = half_h * (wt / ht)
    ox = plane.get("ox", 0.0)
    oy = plane.get("oy", 0.0)
    R = np.asarray(c2w[:3, :3], np.float64)
    o = np.asarray(c2w[:3, 3], np.float64)

    u = np.arange(width, dtype=np.float64)[None, :]
    v = np.arange(height, dtype=np.float64)[:, None]
    d_cam = np.stack(
        [
            np.broadcast_to((u - cx) / fx, (height, width)),
            np.broadcast_to((v - cy) / fy, (height, width)),
            np.ones((height, width)),
        ],
        axis=-1,
    )  # [H, W, 3]
    d_w = d_cam @ R.T
    dz = d_w[..., 2]
    t = np.where(np.abs(dz) > 1e-9, (plane["z"] - o[2]) / dz, -1.0)
    px = o[0] + t * d_w[..., 0]
    py = o[1] + t * d_w[..., 1]

    s = (px - ox + half_w) / (2 * half_w) * (wt - 1)
    r = (py - oy + half_h) / (2 * half_h) * (ht - 1)
    inside = (t > 0) & (s >= 0) & (s <= wt - 1) & (r >= 0) & (r <= ht - 1)
    s = np.clip(s, 0, wt - 1.000001)
    r = np.clip(r, 0, ht - 1.000001)
    s0 = s.astype(np.int64)
    r0 = r.astype(np.int64)
    fs = (s - s0)[..., None]
    fr = (r - r0)[..., None]
    p00 = photo[r0, s0]
    p01 = photo[r0, np.minimum(s0 + 1, wt - 1)]
    p10 = photo[np.minimum(r0 + 1, ht - 1), s0]
    p11 = photo[np.minimum(r0 + 1, ht - 1), np.minimum(s0 + 1, wt - 1)]
    img = (
        p00 * (1 - fs) * (1 - fr)
        + p01 * fs * (1 - fr)
        + p10 * (1 - fs) * fr
        + p11 * fs * fr
    )
    return img, inside, t


def warp_photo_view(
    photo: np.ndarray,
    c2w: np.ndarray,
    fx: float,
    fy: float,
    cx: float,
    cy: float,
    height: int,
    width: int,
    plane_z: float = 4.0,
    half_h: float = 1.0,
    background: float = 0.0,
) -> np.ndarray:
    """Ground-truth view of ONE textured plane by ray-plane intersection.

    For every pixel, cast the camera ray, intersect the z = plane_z world
    plane, and bilinear-sample the photo (the plane spans [-half_w, half_w]
    x [-half_h, half_h] with half_w = half_h * aspect). Pixels whose rays
    miss the plane (or point away from it) get `background`.
    """
    img, inside, _ = _ray_plane_sample(
        photo, {"z": plane_z, "half_h": half_h}, c2w, fx, fy, cx, cy,
        height, width,
    )
    return np.where(inside[..., None], img, background).astype(np.float32)


def warp_multiplane_view(
    photos: list,
    planes: list,
    c2w: np.ndarray,
    fx: float,
    fy: float,
    cx: float,
    cy: float,
    height: int,
    width: int,
    background: float = 0.0,
) -> np.ndarray:
    """Ground truth for STACKED opaque textured planes (nearest hit wins).

    Front planes occlude back planes, so the warped views carry real
    occlusion boundaries and parallax between depth layers, which the
    single-plane scene cannot exercise. Still purely homography-based: no
    gaussian renderer touches the ground truth.
    """
    best_t = np.full((height, width), np.inf)
    out = np.full((height, width, 3), background, np.float64)
    for photo, plane in zip(photos, planes):
        img, inside, t = _ray_plane_sample(
            photo, plane, c2w, fx, fy, cx, cy, height, width
        )
        closer = inside & (t < best_t)
        out = np.where(closer[..., None], img, out)
        best_t = np.where(closer, t, best_t)
    return out.astype(np.float32)


def plane_textures(photo: np.ndarray, n_planes: int) -> list:
    """Distinct textures for each plane from ONE real photo.

    Disjoint crops and flips of one photograph give each depth layer a
    different texture with natural image statistics.
    """
    ht, wt = photo.shape[:2]
    crops = [
        photo[ht // 2:, :],                       # bottom half (face)
        np.ascontiguousarray(
            photo[ht // 5: 3 * ht // 5, wt // 4:][:, ::-1]
        ),                                        # upper middle, mirrored
        np.ascontiguousarray(photo[: ht // 2, : 2 * wt // 3][::-1]),
        np.ascontiguousarray(photo[ht // 3:, wt // 3:][::-1, ::-1]),
    ]
    if not 1 <= n_planes <= len(crops):
        raise ValueError(f"n_planes must be 1..{len(crops)}")
    return crops[:n_planes]


DEFAULT_PLANES = (
    # Front small plane left-of-center, mid plane right, big background —
    # the front layers occlude the back ones across the camera arc.
    {"z": 3.1, "ox": -0.45, "oy": 0.12, "half_h": 0.38},
    {"z": 4.2, "ox": 0.40, "oy": -0.05, "half_h": 0.72},
    {"z": 5.8, "ox": 0.0, "oy": 0.0, "half_h": 1.8},
    {"z": 5.0, "ox": -0.9, "oy": -0.5, "half_h": 0.55},
)


def make_photo_multiplane_scene(
    out_dir: str,
    photo: np.ndarray | None = None,
    n_planes: int = 3,
    n_views: int = 24,
    height: int = 240,
    width: int = 320,
    planes: list | None = None,
    n_init_points: int = 6144,
    init_noise: float = 0.02,
    seed: int = 0,
) -> dict:
    """Prepared-format scene of 1-4 stacked textured planes (see
    warp_multiplane_view): occlusion boundaries and parallax from a real
    photograph, ground truth by pure homography."""
    from ..viewer import look_at
    from .images import save_image

    if photo is None:
        photo = load_photo()
    textures = plane_textures(photo, n_planes)
    planes = list(planes or DEFAULT_PLANES[:n_planes])
    rng = np.random.default_rng(seed)
    fx = fy = 0.9 * width
    cx, cy = width / 2.0, height / 2.0

    os.makedirs(os.path.join(out_dir, "images"), exist_ok=True)
    poses = []
    target = np.array([0.0, 0.0, float(np.mean([p["z"] for p in planes]))])
    for i in range(n_views):
        th = (i / max(n_views - 1, 1) - 0.5) * 0.9
        pos = np.array(
            [
                2.8 * np.sin(th),
                0.35 * np.sin(2.3 * th),
                planes[0]["z"] - 2.8 * np.cos(th),
            ]
        )
        c2w = look_at(pos, target)
        img = warp_multiplane_view(
            textures, planes, c2w, fx, fy, cx, cy, height, width
        )
        save_image(os.path.join(out_dir, "images", f"{i:03d}.png"), img)
        poses.append(c2w.astype(np.float32))
    np.save(os.path.join(out_dir, "poses.npy"), np.stack(poses))
    np.save(
        os.path.join(out_dir, "cam_meta.npy"),
        {"fx": fx, "fy": fy, "cx": cx, "cy": cy},
    )

    # Init cloud: per-plane jittered grids (points split by plane area),
    # texture-sampled colors — mimics an SfM cloud of a layered scene.
    areas = np.array(
        [p["half_h"] ** 2 * (t.shape[1] / t.shape[0])
         for p, t in zip(planes, textures)]
    )
    share = areas / areas.sum()
    clouds = []
    for p, tex, frac in zip(planes, textures, share):
        ht, wt = tex.shape[:2]
        half_h = p["half_h"]
        half_w = half_h * (wt / ht)
        g = max(int(np.sqrt(n_init_points * frac)), 4)
        gx, gy = np.meshgrid(
            np.linspace(-half_w, half_w, g), np.linspace(-half_h, half_h, g)
        )
        pts = np.stack(
            [gx.ravel() + p.get("ox", 0.0), gy.ravel() + p.get("oy", 0.0),
             np.full(g * g, p["z"])], axis=-1,
        )
        pts += rng.normal(0, init_noise, pts.shape)
        s = ((pts[:, 0] - p.get("ox", 0.0) + half_w)
             / (2 * half_w) * (wt - 1)).clip(0, wt - 1)
        r = ((pts[:, 1] - p.get("oy", 0.0) + half_h)
             / (2 * half_h) * (ht - 1)).clip(0, ht - 1)
        colors = tex[r.astype(int), s.astype(int)]
        clouds.append(np.concatenate([pts, colors], axis=-1))
    cloud = np.concatenate(clouds).astype(np.float32)
    np.save(os.path.join(out_dir, "pointcloud.npy"), cloud)
    return {
        "fx": fx, "fy": fy, "cx": cx, "cy": cy,
        "n_views": n_views, "height": height, "width": width,
        "n_points": cloud.shape[0], "n_planes": n_planes,
    }


def make_photo_plane_scene(
    out_dir: str,
    photo: np.ndarray | None = None,
    n_views: int = 16,
    height: int = 240,
    width: int = 320,
    plane_z: float = 4.0,
    half_h: float = 1.0,
    n_init_points: int = 4096,
    init_noise: float = 0.02,
    seed: int = 0,
) -> dict:
    """Write a prepared-format scene dir from warped real-photo views.

    Cameras form a forward-facing arc (LLFF-style) looking at the plane
    center; the init point cloud is a jittered grid on the plane with
    photo-sampled colors (mimicking an SfM point cloud of a planar scene).
    Returns {"fx", "fy", "cx", "cy", "n_views", ...}.
    """
    from ..viewer import look_at
    from .images import save_image

    if photo is None:
        photo = load_photo()
    rng = np.random.default_rng(seed)
    fx = fy = 0.9 * width
    cx, cy = width / 2.0, height / 2.0

    os.makedirs(os.path.join(out_dir, "images"), exist_ok=True)
    poses = []
    target = np.array([0.0, 0.0, plane_z])
    for i in range(n_views):
        th = (i / max(n_views - 1, 1) - 0.5) * 0.9
        pos = np.array(
            [
                2.8 * np.sin(th),
                0.35 * np.sin(2.3 * th),
                plane_z - 2.8 * np.cos(th),
            ]
        )
        c2w = look_at(pos, target)
        img = warp_photo_view(
            photo, c2w, fx, fy, cx, cy, height, width,
            plane_z=plane_z, half_h=half_h,
        )
        save_image(os.path.join(out_dir, "images", f"{i:03d}.png"), img)
        poses.append(c2w.astype(np.float32))
    np.save(os.path.join(out_dir, "poses.npy"), np.stack(poses))
    np.save(
        os.path.join(out_dir, "cam_meta.npy"),
        {"fx": fx, "fy": fy, "cx": cx, "cy": cy},
    )

    # Init cloud: jittered grid on the plane, photo colors.
    ht, wt = photo.shape[:2]
    half_w = half_h * (wt / ht)
    g = int(np.sqrt(n_init_points))
    gx, gy = np.meshgrid(
        np.linspace(-half_w, half_w, g), np.linspace(-half_h, half_h, g)
    )
    pts = np.stack(
        [gx.ravel(), gy.ravel(), np.full(g * g, plane_z)], axis=-1
    )
    pts += rng.normal(0, init_noise, pts.shape)
    s = ((pts[:, 0] + half_w) / (2 * half_w) * (wt - 1)).clip(0, wt - 1)
    r = ((pts[:, 1] + half_h) / (2 * half_h) * (ht - 1)).clip(0, ht - 1)
    colors = photo[r.astype(int), s.astype(int)]
    cloud = np.concatenate([pts, colors], axis=-1).astype(np.float32)
    np.save(os.path.join(out_dir, "pointcloud.npy"), cloud)
    return {
        "fx": fx, "fy": fy, "cx": cx, "cy": cy,
        "n_views": n_views, "height": height, "width": width,
        "n_points": cloud.shape[0],
    }

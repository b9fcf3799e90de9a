"""The surfel transform of 2D Gaussian Splatting (Huang et al., SIGGRAPH
2024, arXiv:2403.17888): world surfels -> the rows the surfel compositor
reads and the footprint binning reads.

A surfel k is a flat disc: centre ``p``, rotation ``R`` from the
normalised quaternion (its first two columns are the tangents ``t_u``,
``t_v``, its third the normal ``t_w``), two scales ``s = exp(scale_raw)``
and opacity ``sigmoid(opacity_raw)``. With ``W = K [R_c | t_c]`` the
world-to-pixel map (intrinsics times view) and ``H = [s_u t_u, s_v t_v,
p]``, the 3x3 matrix ``M = W H`` takes a point ``(u, v, 1)`` of the disc's
frame to homogeneous pixel coordinates. Its rows ``T_u``, ``T_v``,
``T_w`` (the authors' ``T`` columns) are what the compositor needs: a
pixel ``(x, y)`` meets the surfel's plane at ``(u, v) = (k x l)_{0,1} /
(k x l)_2`` with ``k = x T_w - T_u``, ``l = y T_w - T_v``, at camera
depth ``T_w . (u, v, 1)`` (``ops/raster_surfel.py``).

Per surfel this computes, as plain PyTorch that autograd records (the
counterpart, for surfels, of ``ops.gaussian`` + ``ops.projection``):

* validity as ``project_gaussians`` decides it (the opacity pre-filter,
  ``alive``, the frustum with its pixel guard band, finite values), and
  further the normal not perpendicular to the view ray and the 3-sigma
  disc wholly in front of the camera (its projection is then an
  ellipse);
* the normal in camera space, turned to face the camera (the authors'
  ``DUAL_VISIABLE``);
* the footprint, the authors' ``compute_aabb`` at 3 sigma: the centre
  ``c`` of the projected disc's bounding box (the projected centre for a
  surfel facing the camera) and a square pixel radius ``ceil(max(half
  widths, 3 / sqrt(filter_inv_square)))``, binned by the rectangle rule
  of ``project_gaussians`` (tiles of ``floor(c +- radius)``);
* ``ProjectedGaussians`` with ``uv = c`` (plus ``uv_tap``), ``depth`` the
  centre's camera z, ``radius`` and the tile rectangle, so that binning
  (``ops.binning``) is 3DGS's, unchanged; ``conic`` is zero (unused);
* the compositor's row of each surfel, ``[N, SURFEL_ROWS]``:
  ``T_u`` (3), ``T_v`` (3), ``T_w`` (3), ``c`` (2), opacity, rgb (3, the SH
  colour of ``ops.sh``), normal (3); zero where the surfel is invalid.

Every 3x3 product is written elementwise, so nothing reaches a matrix
library or TF32.
"""

from __future__ import annotations

import torch

from ..config import RenderConfig, SurfelConfig
from ..utils.profiling import span
from .camera import transform_to_camera_space
from .clamps import clip
from .gaussian import exp_scale, normalize_quat, quat_to_rotmat
from .projection import ProjectedGaussians
from .sh import evaluate_sh

SURFEL_ROWS = 18  # T_u 3, T_v 3, T_w 3, centre 2, opacity, rgb 3, normal 3
FOOTPRINT_SIGMA = 3.0  # the authors' compute_aabb cutoff


def surfel_transform(params: dict, c2w: torch.Tensor, fx, fy, cx, cy,
                     cfg: RenderConfig, surfel: SurfelConfig,
                     alive: torch.Tensor | None = None,
                     uv_tap: torch.Tensor | None = None):
    """One view's surfel transform and SH colour (module docstring).

    Args:
        params: a surfel pool's leaves: pos [N, 3], scale_raw [N, 2],
            q_raw [N, 4], opacity_raw [N], f_dc [N, 3], f_rest [N, K].
        c2w: [4, 4] f32 camera-to-world on their device.
        fx, fy, cx, cy: numbers or 0-d tensors.
        alive: optional [N] bool slot mask.
        uv_tap: optional [N, 2] zeros by which the whole splat moves on
            the screen (``T_u += tap_x T_w``, ``T_v += tap_y T_w``, so the
            intersection and the centre move by the tap): its gradient is
            the view-space positional gradient.

    Returns:
        (ProjectedGaussians, rows [N, SURFEL_ROWS] f32).
    """
    pos = params["pos"]
    with span("gs.cov_sh"):
        colours = evaluate_sh(params["f_dc"], params["f_rest"], pos, c2w)
    with span("gs.project"):
        H, W = cfg.height, cfg.width
        opacity = clip(torch.sigmoid(params["opacity_raw"]), 0.0, 0.999)
        valid = opacity >= cfg.alpha_cutoff * 0.5
        if alive is not None:
            valid = valid & alive

        R = c2w[:3, :3]
        x, y, z = transform_to_camera_space(pos, c2w)
        guard_v = cfg.pix_guard if cfg.pix_guard_v is None \
            else cfg.pix_guard_v
        fx_x = fx * x
        fy_y = fy * y
        valid = (valid & (z > 0) & (z > cfg.near) & (z < cfg.far)
                 & (fx_x > z * (-cfg.pix_guard - cx))
                 & (fx_x < z * (W + cfg.pix_guard - cx))
                 & (fy_y > z * (-guard_v - cy))
                 & (fy_y < z * (H + guard_v - cy))
                 & torch.isfinite(x) & torch.isfinite(y) & torch.isfinite(z))
        x = torch.where(valid, x, 0.0)
        y = torch.where(valid, y, 0.0)
        z = torch.where(valid, z, 1.0)

        rot = quat_to_rotmat(normalize_quat(params["q_raw"]))  # [N, 3, 3]
        s = exp_scale(params["scale_raw"])  # [N, 2]

        def to_cam(col):
            # camera-space R_c^T t of the world vector t = rot[:, :, col]
            t = [rot[:, j, col] for j in range(3)]
            return [t[0] * R[0, k] + t[1] * R[1, k] + t[2] * R[2, k]
                    for k in range(3)]

        tu, tv, tw = to_cam(0), to_cam(1), to_cam(2)
        au = [c * s[:, 0] for c in tu]
        av = [c * s[:, 1] for c in tv]
        Tu = (fx * au[0] + cx * au[2], fx * av[0] + cx * av[2],
              fx * x + cx * z)
        Tv = (fy * au[1] + cy * au[2], fy * av[1] + cy * av[2],
              fy * y + cy * z)
        Tw = (au[2], av[2], z)
        if uv_tap is not None:  # the whole splat shifted on the screen
            Tu = tuple(a + uv_tap[:, 0] * b for a, b in zip(Tu, Tw))
            Tv = tuple(a + uv_tap[:, 1] * b for a, b in zip(Tv, Tw))

        # The normal, turned to face the camera (the centre lies in front).
        cos = -(x * tw[0] + y * tw[1] + z * tw[2])
        valid = valid & (cos != 0.0)
        sign = torch.where(cos > 0.0, 1.0, -1.0)
        normal = [c * sign for c in tw]

        # compute_aabb at 3 sigma: the projected disc's conic, through its
        # dual (t = (r^2, r^2, -1)); d < 0 when the disc lies wholly in
        # front of the camera.
        r2 = FOOTPRINT_SIGMA * FOOTPRINT_SIGMA
        d = r2 * (Tw[0] * Tw[0] + Tw[1] * Tw[1]) - Tw[2] * Tw[2]
        valid = valid & (d < 0.0) & torch.isfinite(d)
        d = torch.where(valid, d, -1.0)
        f0 = r2 / d
        f2 = -1.0 / d
        cu = f0 * (Tu[0] * Tw[0] + Tu[1] * Tw[1]) + f2 * Tu[2] * Tw[2]
        cv = f0 * (Tv[0] * Tw[0] + Tv[1] * Tw[1]) + f2 * Tv[2] * Tw[2]

        with torch.no_grad():  # the integer footprint: no gradient path
            hx = cu * cu - (f0 * (Tu[0] * Tu[0] + Tu[1] * Tu[1])
                            + f2 * Tu[2] * Tu[2])
            hy = cv * cv - (f0 * (Tv[0] * Tv[0] + Tv[1] * Tv[1])
                            + f2 * Tv[2] * Tv[2])
            ext = torch.sqrt(torch.clamp(torch.maximum(hx, hy), min=1e-4))
            lp = FOOTPRINT_SIGMA / surfel.filter_inv_square ** 0.5
            radius_f = torch.ceil(torch.clamp(ext, min=lp))
            valid = valid & torch.isfinite(radius_f) & torch.isfinite(cu) \
                & torch.isfinite(cv)
            fu = torch.where(valid, cu, 0.0)
            fv = torch.where(valid, cv, 0.0)
            rf = torch.where(valid, radius_f, 0.0)
            umin, umax = torch.floor(fu - rf), torch.floor(fu + rf)
            vmin, vmax = torch.floor(fv - rf), torch.floor(fv + rf)
            valid = valid & (umax >= 0) & (umin < W) & (vmax >= 0) \
                & (vmin < H)

            def to_i32(a, hi):
                a = torch.where(valid, a, 0.0)
                return torch.clamp(a, 0, hi).to(torch.int32)

            T = cfg.tile
            tile_min = torch.stack([to_i32(umin, W - 1) // T,
                                    to_i32(vmin, H - 1) // T], dim=-1)
            tile_max = torch.stack([to_i32(umax, W - 1) // T,
                                    to_i32(vmax, H - 1) // T], dim=-1)
            tile_min = torch.where(valid[:, None], tile_min, 0)
            tile_max = torch.where(valid[:, None], tile_max, -1)

        uv = torch.stack([cu, cv], dim=-1)
        rows = torch.stack([*Tu, *Tv, *Tw, uv[:, 0], uv[:, 1], opacity,
                            colours[:, 0], colours[:, 1], colours[:, 2],
                            *normal], dim=-1)
        # Zero invalid rows: culled slots may hold NaN or inf.
        rows = torch.where(valid[:, None], rows, 0.0)
        n = pos.shape[0]
        proj = ProjectedGaussians(
            uv=torch.where(valid[:, None], uv, 0.0),
            depth=z,
            conic=torch.zeros(n, 3, dtype=pos.dtype, device=pos.device),
            opacity=opacity,
            radius=torch.where(valid, radius_f, 0.0).to(torch.int32),
            tile_min=tile_min.to(torch.int32),
            tile_max=tile_max.to(torch.int32),
            valid=valid,
        )
    return proj, rows

"""Fused per-Gaussian projection: world params -> screen-space splat data.

Counterpart of ``gsplat_tpu/ops/projection.py:37-274``: one static-shape
pass over every Gaussian (opacity pre-filter, camera transform, frustum
test, EWA covariance, closed-form 2x2 eigenvalue clamp, cutoff-tied
marginal radius, tile AABB, conic). Culled Gaussians keep their slot and
carry ``valid = False``; they are masked, never filtered. Invalid lanes
are sanitized before any division, because dead pool slots can hold
anything.

Every 3x3 and 2x3 product is written elementwise in the JAX package's
order, so nothing here reaches a matrix library or TF32.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import RenderConfig
from .camera import inv2x2_packed, transform_to_camera_space
from ..utils.profiling import span
from .clamps import clip, maximum

EVAL_MIN = 1e-6  # reference render.py:178 clamp bounds
EVAL_MAX = 1e4


class ProjectedGaussians(NamedTuple):
    """Per-Gaussian screen-space splat data, one slot per input Gaussian."""

    uv: torch.Tensor  # [N, 2] pixel center
    depth: torch.Tensor  # [N] camera-space z
    conic: torch.Tensor  # [N, 3] inverse 2D covariance (A, B, C)
    opacity: torch.Tensor  # [N] sigmoid opacity, clamped to [0, 0.999]
    radius: torch.Tensor  # [N] int32 pixel radius (0 for invalid)
    tile_min: torch.Tensor  # [N, 2] int32 (tx0, ty0) inclusive
    tile_max: torch.Tensor  # [N, 2] int32 (tx1, ty1) inclusive
    valid: torch.Tensor  # [N] bool


def clamp_eigvals_2x2(a, b, c, lo=EVAL_MIN, hi=EVAL_MAX):
    """Clamp eigenvalues of symmetric [[a,b],[b,c]] to [lo, hi], recompose.

    Returns (a', b', c', lam_max'). On the unclamped path the input itself
    is returned (see the JAX counterpart for the gradient reasoning).
    """
    m = 0.5 * (a + c)
    d = 0.5 * (a - c)
    r = torch.sqrt(d * d + b * b + 1e-30)
    l1_raw = m - r
    l2_raw = m + r
    l1 = clip(l1_raw, lo, hi)
    l2 = clip(l2_raw, lo, hi)
    unclamped = (l1_raw >= lo) & (l2_raw <= hi)
    m_new = 0.5 * (l1 + l2)
    f = (l2 - l1) / (2.0 * r)
    a_new = torch.where(unclamped, a, m_new + f * d)
    c_new = torch.where(unclamped, c, m_new - f * d)
    b_new = torch.where(unclamped, b, f * b)
    return a_new, b_new, c_new, l2


def project_gaussians(
    pos: torch.Tensor,
    cov3d: torch.Tensor,
    opacity_raw: torch.Tensor,
    c2w: torch.Tensor,
    fx,
    fy,
    cx,
    cy,
    cfg: RenderConfig,
    extra_valid: torch.Tensor | None = None,
    uv_tap: torch.Tensor | None = None,
) -> ProjectedGaussians:
    """Project N world-space Gaussians into screen space (static shapes).

    Args:
        pos: [N, 3] world positions.
        cov3d: [N, 6] packed world covariance (xx, xy, xz, yy, yz, zz).
        opacity_raw: [N] pre-sigmoid opacities.
        c2w: [4, 4] camera-to-world.
        fx, fy, cx, cy: intrinsics (Python floats or 0-d tensors).
        cfg: static render config.
        extra_valid: optional [N] bool mask (e.g. the pool's alive mask);
            invalid slots are culled exactly like off-frustum Gaussians.
        uv_tap: optional [N, 2] zeros added to the projected pixel centers:
            a differentiation tap, whose gradient is the view-space
            positional gradient (the paper-ADC statistic).
    """
    with span("gs.project"):
        dtype = pos.dtype
        H, W = cfg.height, cfg.width

        # --- opacity pre-filter (reference render.py:104-107) ---
        opacity = clip(torch.sigmoid(opacity_raw), 0.0, 0.999)
        valid = opacity >= cfg.alpha_cutoff * 0.5
        if extra_valid is not None:
            valid = valid & extra_valid

        # --- camera transform + frustum (render.py:119-136) ---
        R = c2w[:3, :3]
        x, y, z = transform_to_camera_space(pos, c2w)
        guard_v = cfg.pix_guard if cfg.pix_guard_v is None else cfg.pix_guard_v
        in_front = z > 0
        depth_ok = (z > cfg.near) & (z < cfg.far)
        fx_x = fx * x
        u_ok = (fx_x > z * (-cfg.pix_guard - cx)) & (
            fx_x < z * (W + cfg.pix_guard - cx)
        )
        fy_y = fy * y
        v_ok = (fy_y > z * (-guard_v - cy)) & (fy_y < z * (H + guard_v - cy))
        valid = valid & in_front & depth_ok & u_ok & v_ok
        valid = (valid & torch.isfinite(x) & torch.isfinite(y)
                 & torch.isfinite(z))

        # Sanitize BEFORE any division/sqrt: invalid lanes get a benign dummy
        # point (origin at depth 1); their outputs are masked anyway.
        x = torch.where(valid, x, 0.0)
        y = torch.where(valid, y, 0.0)
        z = torch.where(valid, z, 1.0)

        # --- projection (render.py:146) ---
        u = fx * x / z + cx
        v = fy * y / z + cy
        if uv_tap is not None:
            u = u + uv_tap[:, 0]
            v = v + uv_tap[:, 1]

        # --- EWA: Sigma2D = (J Rwc) Sigma (J Rwc)^T,
        #     rows (J Rwc)_r = J_r R^T ---
        invz = 1.0 / maximum(z, 1e-6)
        invz2 = invz * invz
        zero = torch.zeros_like(invz)
        ju = (fx * invz, zero, -fx * x * invz2)
        jv = (zero, fy * invz, -fy * y * invz2)

        def row_world(j):
            # [N, 3]: m_k = sum_j j_j R[k, j] (einsum "nj,kj->nk").
            return [j[0] * R[k, 0] + j[1] * R[k, 1] + j[2] * R[k, 2]
                    for k in range(3)]

        mu = row_world(ju)
        mv = row_world(jv)

        xx, xy, xz, yy, yz, zz = (cov3d[:, i] for i in range(6))

        def quad(p, q):
            """p^T Sigma q for row vectors p, q given as 3 columns of [N]."""
            return (
                p[0] * (xx * q[0] + xy * q[1] + xz * q[2])
                + p[1] * (xy * q[0] + yy * q[1] + yz * q[2])
                + p[2] * (xz * q[0] + yz * q[1] + zz * q[2])
            )

        s_a = quad(mu, mu)  # Sigma2D[0,0]
        s_c = quad(mv, mv)  # Sigma2D[1,1]
        # symmetrized (render.py:175)
        s_b = 0.5 * (quad(mu, mv) + quad(mv, mu))

        # Finite filter (render.py:187-200), then sanitize invalid lanes to the
        # identity covariance before the clamp/inverse.
        valid = (valid & torch.isfinite(s_a) & torch.isfinite(s_b)
                 & torch.isfinite(s_c))
        s_a = torch.where(valid, s_a, 1.0)
        s_b = torch.where(valid, s_b, 0.0)
        s_c = torch.where(valid, s_c, 1.0)

        if cfg.aa_mode == "dilate":
            s_a = s_a + cfg.aa_dilation
            s_c = s_c + cfg.aa_dilation
        elif cfg.aa_mode == "mip":
            det_before = maximum(s_a * s_c - s_b * s_b, 1e-12)
            s_a = s_a + cfg.aa_dilation
            s_c = s_c + cfg.aa_dilation
            det_after = maximum(s_a * s_c - s_b * s_b, 1e-12)
            opacity = opacity * torch.sqrt(det_before / det_after)
        elif cfg.aa_mode != "none":
            raise ValueError(f"unknown aa_mode {cfg.aa_mode!r}")

        s_a, s_b, s_c, lam_max = clamp_eigvals_2x2(s_a, s_b, s_c)

        # --- cutoff-tied marginal radius + AABB (render.py:227-247) ---
        # (These clamps feed only integer radii and tile bounds: no gradient
        # path, so torch.clamp's tie rule does not matter here.)
        k2 = torch.clamp(
            2.0 * torch.log(torch.clamp(opacity, min=1e-12)
                            / cfg.alpha_cutoff),
            max=cfg.chi2_clip,
        )
        valid = valid & (k2 > 0.0)  # opacity <= cutoff: zero contribution
        k2 = torch.clamp(k2, min=0.0)
        major = torch.clamp(lam_max, 1e-12, 1e4)
        radius_f = torch.ceil(torch.sqrt(k2 * major))
        rx = torch.ceil(torch.sqrt(k2 * torch.clamp(s_a, 1e-12, 1e4)))
        ry = torch.ceil(torch.sqrt(k2 * torch.clamp(s_c, 1e-12, 1e4)))
        umin = torch.floor(u - rx)
        umax = torch.floor(u + rx)
        vmin = torch.floor(v - ry)
        vmax = torch.floor(v + ry)
        on_screen = (umax >= 0) & (umin < W) & (vmax >= 0) & (vmin < H)
        valid = valid & on_screen

        def to_i32(a, hi):
            # Culled lanes may be NaN here; zero them before the cast
            # (XLA converts NaN to 0, a C cast is undefined) — they are
            # masked below.
            a = torch.where(valid, a, 0.0)
            return torch.clamp(a, 0, hi).to(torch.int32)

        umin_i = to_i32(umin, W - 1)
        umax_i = to_i32(umax, W - 1)
        vmin_i = to_i32(vmin, H - 1)
        vmax_i = to_i32(vmax, H - 1)

        T = cfg.tile
        tile_min = torch.stack([umin_i // T, vmin_i // T], dim=-1)
        tile_max = torch.stack([umax_i // T, vmax_i // T], dim=-1)
        # Empty footprint for invalid gaussians (tmax = tmin - 1).
        tile_min = torch.where(valid[:, None], tile_min, 0)
        tile_max = torch.where(valid[:, None], tile_max, -1)

        conic_a, conic_b, conic_c = inv2x2_packed(s_a, s_b, s_c)
        conic_a = maximum(conic_a, cfg.min_conic)  # render.py:310-315
        conic_c = maximum(conic_c, cfg.min_conic)
        conic = torch.stack([conic_a, conic_b, conic_c], dim=-1).to(dtype)

        return ProjectedGaussians(
            uv=torch.stack([u, v], dim=-1).to(dtype),
            depth=z.to(dtype),
            conic=conic,
            opacity=opacity.to(dtype),
            radius=torch.where(valid, radius_f, 0.0).to(torch.int32),
            tile_min=tile_min.to(torch.int32),
            tile_max=tile_max.to(torch.int32),
            valid=valid,
        )

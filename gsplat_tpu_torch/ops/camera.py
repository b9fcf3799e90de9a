"""Camera-space transforms, frustum test, projection, 2x2 inverses,
intrinsics.

Counterpart of ``gsplat_tpu/ops/camera.py``:

* ``Intrinsics`` (``:25``),
* w2c built from c2w as [R^T | -R^T t],
* camera-space coordinates ``(p - t) @ R``, written elementwise,
* the division-free frustum test with a pixel guard band (``:56``) and
  the pinhole projection ``u = fx*x/z + cx`` (``:73``),
* closed-form 2x2 inverses, general (``inv2x2``, ``:83``) and symmetric
  packed, with the determinant clamped from BELOW at eps (a negative
  determinant becomes eps, as in the reference),
* linear intrinsics rescaling.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .clamps import maximum


class Intrinsics(NamedTuple):
    """Pinhole intrinsics; fields may be Python floats or 0-d tensors."""

    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor


def w2c_from_c2w(c2w: torch.Tensor) -> torch.Tensor:
    """Invert a rigid camera-to-world transform: [R|t] -> [R^T | -R^T t]."""
    R = c2w[:3, :3]
    t = c2w[:3, 3]
    Rt = R.T
    # -R^T t elementwise (no matrix library, no TF32).
    tr = -(Rt[:, 0] * t[0] + Rt[:, 1] * t[1] + Rt[:, 2] * t[2])
    top = torch.cat([Rt, tr[:, None]], dim=1)
    bottom = torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=c2w.dtype,
                          device=c2w.device)
    return torch.cat([top, bottom], dim=0)


def transform_to_camera_space(pc: torch.Tensor, c2w: torch.Tensor):
    """World points [N, 3] -> camera-space (x, y, z), each [N]."""
    R = c2w[:3, :3]
    d = pc - c2w[:3, 3][None, :]
    x = d[:, 0] * R[0, 0] + d[:, 1] * R[1, 0] + d[:, 2] * R[2, 0]
    y = d[:, 0] * R[0, 1] + d[:, 1] * R[1, 1] + d[:, 2] * R[2, 1]
    z = d[:, 0] * R[0, 2] + d[:, 1] * R[1, 2] + d[:, 2] * R[2, 2]
    return x, y, z


def check_frustum_camera_space(x, y, z, fx, fy, cx, cy, H, W, near, far,
                               pix_guard) -> torch.Tensor:
    """Division-free frustum test: z > 0, near < z < far, and the
    projection within the image widened by ``pix_guard`` on every side."""
    in_front = z > 0
    depth_ok = (z > near) & (z < far)
    fx_x = fx * x
    u_ok = (fx_x > z * (-pix_guard - cx)) & (fx_x < z * (W + pix_guard - cx))
    fy_y = fy * y
    v_ok = (fy_y > z * (-pix_guard - cy)) & (fy_y < z * (H + pix_guard - cy))
    return in_front & depth_ok & u_ok & v_ok


def project_points(pc: torch.Tensor, c2w: torch.Tensor, fx, fy, cx, cy):
    """World points -> (uv [N, 2], x, y, z) of the pinhole projection."""
    x, y, z = transform_to_camera_space(pc, c2w)
    uv = torch.stack([fx * x / z + cx, fy * y / z + cy], dim=-1)
    return uv, x, y, z


def inv2x2(M: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Batched closed-form inverse of [..., 2, 2] with det clamped at
    min=eps (the reference's below-only clamp)."""
    a, b = M[..., 0, 0], M[..., 0, 1]
    c, d = M[..., 1, 0], M[..., 1, 1]
    safe_det = maximum(a * d - b * c, eps)
    row0 = torch.stack([d / safe_det, -b / safe_det], dim=-1)
    row1 = torch.stack([-c / safe_det, a / safe_det], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def inv2x2_packed(a, b, c, eps: float = 1e-12):
    """Inverse of symmetric 2x2 [[a, b], [b, c]] -> conic (A, B, C)."""
    det = a * c - b * b
    safe_det = maximum(det, eps)
    inv_det = 1.0 / safe_det
    return c * inv_det, -b * inv_det, a * inv_det


def scale_intrinsics(H, W, H_src, W_src, fx, fy, cx, cy):
    """Rescale intrinsics to a new resolution (reference utils.py:194-238)."""
    sx = W / W_src
    sy = H / H_src
    return fx * sx, fy * sy, cx * sx, cy * sy

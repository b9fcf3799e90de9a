"""Camera-space transforms, the packed 2x2 inverse, intrinsics rescaling.

Counterpart of ``gsplat_tpu/ops/camera.py:34-117``:

* w2c built from c2w as [R^T | -R^T t],
* camera-space coordinates ``(p - t) @ R``, written elementwise,
* closed-form symmetric 2x2 inverse with the determinant clamped from
  BELOW at eps (a negative determinant becomes eps, as in the reference),
* linear intrinsics rescaling.
"""

from __future__ import annotations

import torch


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


def inv2x2_packed(a, b, c, eps: float = 1e-12):
    """Inverse of symmetric 2x2 [[a, b], [b, c]] -> conic (A, B, C)."""
    det = a * c - b * b
    safe_det = torch.clamp(det, min=eps)
    inv_det = 1.0 / safe_det
    return c * inv_det, -b * inv_det, a * inv_det


def scale_intrinsics(H, W, H_src, W_src, fx, fy, cx, cy):
    """Rescale intrinsics to a new resolution (reference utils.py:194-238)."""
    sx = W / W_src
    sy = H / H_src
    return fx * sx, fy * sy, cx * sx, cy * sy

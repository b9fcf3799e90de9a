"""Gaussian parameterization: quaternion -> rotation, covariance.

Counterpart of ``gsplat_tpu/ops/gaussian.py:23-132``, with
``build_sigma_from_params`` (``:54``) beside the packed form:

* quaternions use the (x, y, z, w) layout,
* quaternions are normalized with a +1e-9 denominator guard,
* scales are stored in log-space, exponentiated and clamped to >= 1e-6,
* Sigma = R @ diag(s^2) @ R^T, packed as (xx, xy, xz, yy, yz, zz).

Every product is written elementwise, in the JAX package's order, so no
3x3 product goes through a matrix library (and none through TF32).
"""

from __future__ import annotations

import torch

from .clamps import maximum


def quat_to_rotmat(quat: torch.Tensor) -> torch.Tensor:
    """[..., 4] (x, y, z, w) quaternions -> [..., 3, 3] rotation matrices."""
    x, y, z, w = quat[..., 0], quat[..., 1], quat[..., 2], quat[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    xw, yw, zw = x * w, y * w, z * w
    row0 = torch.stack([1 - 2 * (yy + zz), 2 * (xy - zw), 2 * (xz + yw)], -1)
    row1 = torch.stack([2 * (xy + zw), 1 - 2 * (xx + zz), 2 * (yz - xw)], -1)
    row2 = torch.stack([2 * (xz - yw), 2 * (yz + xw), 1 - 2 * (xx + yy)], -1)
    return torch.stack([row0, row1, row2], dim=-2)


def normalize_quat(q_raw: torch.Tensor) -> torch.Tensor:
    """Normalize raw quaternions with the reference's +1e-9 guard."""
    norm = torch.linalg.vector_norm(q_raw, dim=-1, keepdim=True)
    return q_raw / (norm + 1e-9)


def exp_scale(scale_raw: torch.Tensor) -> torch.Tensor:
    """Log-space scale -> positive scale, clamped to >= 1e-6."""
    return maximum(torch.exp(scale_raw), 1e-6)


def build_sigma_from_params(scale_raw: torch.Tensor,
                            q_raw: torch.Tensor) -> torch.Tensor:
    """[N, 3, 3] covariance Sigma = R diag(s^2) R^T (``:54``), each entry
    ``sum_k R_ik s2_k R_jk`` written out in k order (no matrix library)."""
    scale = exp_scale(scale_raw)
    R = quat_to_rotmat(normalize_quat(q_raw))
    Rs2 = R * (scale**2)[..., None, :]
    return (Rs2[..., :, None, 0] * R[..., None, :, 0]
            + Rs2[..., :, None, 1] * R[..., None, :, 1]
            + Rs2[..., :, None, 2] * R[..., None, :, 2])


def build_cov3d_packed(scale_raw: torch.Tensor, q_raw: torch.Tensor) -> torch.Tensor:
    """Packed covariance [N, 6] = (xx, xy, xz, yy, yz, zz) of Sigma."""
    q = normalize_quat(q_raw)
    return cov3d_from_activated(exp_scale(scale_raw), q)


def cov3d_from_activated(scale: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Packed covariance [N, 6] of Sigma = R diag(scale^2) R^T from
    positive scales [N, 3] and unit quaternions [N, 4] (x, y, z, w) as
    they are: the core of :func:`build_cov3d_packed`, which activates the
    raw leaves first, and what a model whose scales and rotations come
    activated (Scaffold-GS's decoded slots) calls."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx_, yy_, zz_ = x * x, y * y, z * z
    xy_, xz_, yz_ = x * y, x * z, y * z
    xw_, yw_, zw_ = x * w, y * w, z * w
    r00 = 1 - 2 * (yy_ + zz_)
    r01 = 2 * (xy_ - zw_)
    r02 = 2 * (xz_ + yw_)
    r10 = 2 * (xy_ + zw_)
    r11 = 1 - 2 * (xx_ + zz_)
    r12 = 2 * (yz_ - xw_)
    r20 = 2 * (xz_ - yw_)
    r21 = 2 * (yz_ + xw_)
    r22 = 1 - 2 * (xx_ + yy_)

    s2 = scale ** 2
    s0, s1, s2_ = s2[..., 0], s2[..., 1], s2[..., 2]

    def sig(a0, a1, a2, b0, b1, b2):
        return s0 * a0 * b0 + s1 * a1 * b1 + s2_ * a2 * b2

    return torch.stack(
        [
            sig(r00, r01, r02, r00, r01, r02),  # xx
            sig(r00, r01, r02, r10, r11, r12),  # xy
            sig(r00, r01, r02, r20, r21, r22),  # xz
            sig(r10, r11, r12, r10, r11, r12),  # yy
            sig(r10, r11, r12, r20, r21, r22),  # yz
            sig(r20, r21, r22, r20, r21, r22),  # zz
        ],
        dim=-1,
    )


def pack_cov3d(sigma: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] symmetric -> [..., 6] upper triangular (xx,xy,xz,yy,yz,zz)."""
    return torch.stack(
        [
            sigma[..., 0, 0],
            sigma[..., 0, 1],
            sigma[..., 0, 2],
            sigma[..., 1, 1],
            sigma[..., 1, 2],
            sigma[..., 2, 2],
        ],
        dim=-1,
    )


def unpack_cov3d(packed: torch.Tensor) -> torch.Tensor:
    """[..., 6] upper triangular -> [..., 3, 3] symmetric."""
    xx, xy, xz, yy, yz, zz = (packed[..., i] for i in range(6))
    row0 = torch.stack([xx, xy, xz], dim=-1)
    row1 = torch.stack([xy, yy, yz], dim=-1)
    row2 = torch.stack([xz, yz, zz], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)

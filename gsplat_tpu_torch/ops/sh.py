"""Real spherical harmonics (degree 0..3) view-dependent color.

Counterpart of ``gsplat_tpu/ops/sh.py:57-148``: 16 Cartesian real SH basis
functions with the standard 3DGS constants, view direction =
normalize(point - camera_position) with the ``sqrt(max(sq, 1e-24))`` norm
guard and the reference's +1e-8, coefficients packed as f_dc [N, 3] plus
f_rest [N, 3*(K-1)] laid out [R terms, G terms, B terms], and
color = sigmoid(sum_k f_k * Y_k).
"""

from __future__ import annotations

import torch

from .clamps import maximum

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2_0 = 1.0925484305920792  # xy, yz, xz
SH_C2_1 = 0.31539156525252005  # (3z^2 - 1)
SH_C2_2 = 0.5462742152960396  # (x^2 - y^2)
SH_C3_0 = 0.5900435899266435  # y(3x^2 - y^2) and x(x^2 - 3y^2)
SH_C3_1 = 2.890611442640554  # xyz
SH_C3_2 = 0.4570457994644658  # y(4z^2 - x^2 - y^2) and x(...)
SH_C3_3 = 0.3731763325901154  # z(2z^2 - 3x^2 - 3y^2)
SH_C3_4 = 1.445305721320277  # z(x^2 - y^2)

# The constants by basis term (``gsplat_tpu/ops/sh.py:35``).
HARMONICS = {
    "SH_C0": SH_C0,
    "SH_C1_x": SH_C1,
    "SH_C1_y": SH_C1,
    "SH_C1_z": SH_C1,
    "SH_C2_xy": SH_C2_0,
    "SH_C2_xz": SH_C2_0,
    "SH_C2_yz": SH_C2_0,
    "SH_C2_zz": SH_C2_1,
    "SH_C2_xx_yy": SH_C2_2,
    "SH_C3_yxx_yyy": SH_C3_0,
    "SH_C3_xyz": SH_C3_1,
    "SH_C3_yzz_yxx_yyy": SH_C3_2,
    "SH_C3_zzz_zxx_zyy": SH_C3_3,
    "SH_C3_xzz_xxx_xyy": SH_C3_2,
    "SH_C3_zxx_zyy": SH_C3_4,
    "SH_C3_xxx_xyy": SH_C3_0,
}

NUM_SH_BASES = 16


def sh_basis(dirs: torch.Tensor) -> torch.Tensor:
    """[..., 3] unit view directions -> [..., 16] basis values Y0..Y15."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    return torch.stack(
        [
            torch.full_like(x, SH_C0),
            -SH_C1 * y,
            SH_C1 * z,
            -SH_C1 * x,
            SH_C2_0 * xy,
            SH_C2_0 * yz,
            SH_C2_1 * (3 * zz - 1),
            SH_C2_0 * xz,
            SH_C2_2 * (xx - yy),
            SH_C3_0 * y * (3 * xx - yy),
            SH_C3_1 * x * y * z,
            SH_C3_2 * y * (4 * zz - xx - yy),
            SH_C3_3 * z * (2 * zz - 3 * xx - 3 * yy),
            SH_C3_2 * x * (4 * zz - xx - yy),
            SH_C3_4 * z * (xx - yy),
            SH_C3_0 * x * (xx - 3 * yy),
        ],
        dim=-1,
    )


def pack_sh_coeffs(f_dc: torch.Tensor, f_rest: torch.Tensor) -> torch.Tensor:
    """Pack f_dc [N, 3] + f_rest [N, 3*(K-1)] -> [N, K, 3] coefficients."""
    n_rest = f_rest.shape[-1] // 3 if f_rest.numel() else 0
    coeffs = [f_dc[:, None, :]]
    if n_rest:
        rest = torch.stack(
            [
                f_rest[:, :n_rest],
                f_rest[:, n_rest : 2 * n_rest],
                f_rest[:, 2 * n_rest : 3 * n_rest],
            ],
            dim=-1,
        )  # [N, n_rest, 3]
        coeffs.append(rest)
    return torch.cat(coeffs, dim=1)


def evaluate_sh(
    f_dc: torch.Tensor,
    f_rest: torch.Tensor,
    points: torch.Tensor,
    c2w: torch.Tensor,
) -> torch.Tensor:
    """View-dependent RGB [N, 3] in (0, 1) from SH coefficients."""
    cam_pos = c2w[:3, 3]
    view_dir = points - cam_pos[None, :]
    # sqrt(max(.)) keeps d|v|/dv finite where a dead pool slot sits exactly
    # at the camera position.
    sq = torch.sum(view_dir * view_dir, dim=-1, keepdim=True)
    norm = torch.sqrt(maximum(sq, 1e-24))
    view_dir = view_dir / (norm + 1e-8)
    coeffs = pack_sh_coeffs(f_dc, f_rest)  # [N, K, 3]
    basis = sh_basis(view_dir)[:, : coeffs.shape[1]]  # [N, K]
    # Elementwise product + sum over K: no matrix library, no TF32.
    raw = torch.sum(basis[:, :, None] * coeffs, dim=1)
    return torch.sigmoid(raw)

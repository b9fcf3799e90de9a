"""Public rendering entry points.

Counterpart of ``gsplat_tpu/render.py``: ``render`` with the reference
signature (``:25-75``), ``pair_demand`` (``:78-107``) and
``render_from_params`` (``:110-136``, with its ``uv_tap``). Batched views come in a later
slice. Inputs are tensors on one device; the compositor runs the CUDA
kernel for CUDA tensors and its plain version for CPU tensors.
"""

from __future__ import annotations

import torch

from .config import RenderConfig
from .ops.binning import bin_gaussians
from .ops.gaussian import build_cov3d_packed, pack_cov3d
from .ops.projection import project_gaussians
from .ops.rasterize import rasterize
from .ops.sh import evaluate_sh


def _c2w(c2w, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(c2w, dtype=torch.float32, device=like.device)


def render(
    pos: torch.Tensor,
    color: torch.Tensor,
    opacity_raw: torch.Tensor,
    sigma: torch.Tensor,
    c2w,
    H: int,
    W: int,
    fx,
    fy,
    cx,
    cy,
    near: float = 0.01,
    far: float = 100.0,
    pix_guard: float = 32,
    T: int = 16,
    min_conis: float = 1e-6,
    chi_square_clip: float = 6.25,
    alpha_max: float = 0.99,
    alpha_cutoff: float = 1 / 128.0,
    cfg: RenderConfig | None = None,
    return_aux: bool = False,
):
    """Render a view; signature/threshold parity with reference render.py:62-64."""
    if cfg is None:
        cfg = RenderConfig(
            height=int(H),
            width=int(W),
            tile=int(T),
            near=near,
            far=far,
            pix_guard=pix_guard,
            min_conic=min_conis,
            chi2_clip=chi_square_clip,
            alpha_max=alpha_max,
            alpha_cutoff=alpha_cutoff,
        )
    cov3d = pack_cov3d(sigma) if sigma.dim() == 3 else sigma
    # 0-d f32 intrinsics, as the JAX entry point casts them (jnp.float32).
    fx, fy, cx, cy = (torch.tensor(float(a), dtype=torch.float32,
                                   device=pos.device) for a in (fx, fy, cx, cy))
    proj = project_gaussians(pos, cov3d, opacity_raw, _c2w(c2w, pos),
                             fx, fy, cx, cy, cfg)
    img, aux = rasterize(proj, color, cfg)
    return (img, aux) if return_aux else img


def pair_demand(params: dict, c2w, fx, fy, cx, cy, cfg: RenderConfig,
                alive: torch.Tensor | None = None):
    """True (pair, row, trunc) demand of a view — projection + binning only.

    Returns (num_pairs, num_rows, trunc_demand) as 0-d int32 tensors; the
    last two are 0 in rect mode without truncation.
    """
    pos = params["pos"]
    cov3d = build_cov3d_packed(params["scale_raw"], params["q_raw"])
    proj = project_gaussians(
        pos, cov3d, params["opacity_raw"], _c2w(c2w, pos), fx, fy, cx, cy,
        cfg, extra_valid=alive,
    )
    binning = bin_gaussians(proj, cfg)
    return binning.num_pairs, binning.num_rows, binning.trunc_demand


def render_from_params(params: dict, c2w, fx, fy, cx, cy, cfg: RenderConfig,
                       alive: torch.Tensor | None = None,
                       uv_tap: torch.Tensor | None = None):
    """Raw parameter dict -> (image [H, W, 3], RenderAux).

    Args:
        params: dict with pos [N,3], scale_raw [N,3], q_raw [N,4],
            opacity_raw [N], f_dc [N,3], f_rest [N,45|9|0], all on one
            device (e.g. ``GaussianPool.params``).
        c2w: [4, 4] camera-to-world (tensor or array), moved to that device.
        alive: optional [N] bool pool-slot mask.
        uv_tap: optional [N, 2] zeros; the gradient w.r.t. it is the
            view-space positional gradient (paper-style ADC statistic).
    """
    pos = params["pos"]
    c2w = _c2w(c2w, pos)
    cov3d = build_cov3d_packed(params["scale_raw"], params["q_raw"])
    colors = evaluate_sh(params["f_dc"], params["f_rest"], pos, c2w)
    proj = project_gaussians(
        pos, cov3d, params["opacity_raw"], c2w, fx, fy, cx, cy, cfg,
        extra_valid=alive, uv_tap=uv_tap,
    )
    return rasterize(proj, colors, cfg)

"""Public rendering entry points.

Counterpart of ``gsplat_tpu/render.py``: ``render`` with the reference
signature (``:25-75``), ``pair_demand`` (``:78-107``),
``render_from_params`` (``:110-136``, with its ``uv_tap``),
``stack_view_projections`` (``:139-177``) and ``render_batch_from_params``
(``:180-268``: B views through one binning and one compositor launch).
Inputs are tensors on one device; the compositor runs the CUDA kernel for
CUDA tensors and its plain version for CPU tensors. The per-gaussian
stages (covariance, SH colour, projection) go through
``ops.preprocess.preprocess``: one kernel, P1, for CUDA tensors autograd
does not record, else the plain chain. A surfel pool (a two-column
``scale_raw``: 2D Gaussian Splatting) goes through the surfel transform
(``ops.surfel``) and the surfel compositor (``ops.raster_surfel``)
instead, in ``render_from_params`` and ``pair_demand``; the batched entry
refuses it. An anchor pool (an ``anchor_feat`` leaf: Scaffold-GS), whose
params carry its three MLPs beside its leaves, is decoded each view into
neural gaussians (``ops.scaffold``), projected from their activated
fields and rasterized with their colours, in the same two entries; the
batched entry refuses it too.
"""

from __future__ import annotations

import torch

from .config import (FEATURE_KEY, RenderConfig, SurfelConfig,
                     is_anchor_pool, is_surfel_pool)
from .ops import scaffold
from .ops.binning import bin_gaussians
from .ops.gaussian import cov3d_from_activated, pack_cov3d
from .ops.preprocess import preprocess
from .ops.projection import (ProjectedGaussians, project_activated,
                             project_gaussians)
from .ops.raster_surfel import check_config as check_surfel_config
from .ops.rasterize import rasterize, rasterize_surfels
from .ops.surfel import surfel_transform
from .utils.profiling import span


def _c2w(c2w, like: torch.Tensor) -> torch.Tensor:
    with span("gs.pose"):
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
                alive: torch.Tensor | None = None,
                surfel: SurfelConfig | None = None):
    """True (pair, row, trunc) demand of a view — projection + binning only.

    Returns (num_pairs, num_rows, trunc_demand) as 0-d int32 tensors; the
    last two are 0 in rect mode without truncation. A surfel pool's
    demand is its footprints' (``surfel``: as ``render_from_params``); an
    anchor pool's, its kept neural gaussians'.
    """
    c2w = _c2w(c2w, params["pos"])
    if is_anchor_pool(params):
        proj = _anchors(params, c2w, fx, fy, cx, cy, cfg, alive, None)[0]
    elif is_surfel_pool(params):
        proj = _surfels(params, c2w, fx, fy, cx, cy, cfg, alive, None,
                        surfel)[0]
    else:
        proj, _, _ = preprocess(params, c2w, fx, fy, cx, cy, cfg,
                                alive=alive, colour=False)
    binning = bin_gaussians(proj, cfg)
    return binning.num_pairs, binning.num_rows, binning.trunc_demand


def _surfels(params: dict, c2w, fx, fy, cx, cy, cfg: RenderConfig, alive,
             uv_tap, surfel):
    """A surfel pool's transform, after its refusals: (projection, rows,
    the SurfelConfig)."""
    if FEATURE_KEY in params:
        raise ValueError("a surfel pool (two-column scale_raw) carries no "
                         "per-gaussian features (f_sem)")
    check_surfel_config(cfg)
    surfel = surfel or SurfelConfig()
    proj, rows = surfel_transform(params, c2w, fx, fy, cx, cy, cfg, surfel,
                                  alive=alive, uv_tap=uv_tap)
    return proj, rows, surfel


def _anchors(params: dict, c2w, fx, fy, cx, cy, cfg: RenderConfig, alive,
             uv_tap):
    """An anchor pool's neural gaussians, after its refusals: (their
    projection, colours [A k, 3], scales [A k, 3], keep [A k])."""
    scaffold.refuse(params, cfg, uv_tap)
    mu, s, q, alpha, colour, keep = scaffold.decode_view(
        params, c2w, fx, fy, cx, cy, cfg, alive)
    with span("gs.project"):
        proj = project_activated(mu, cov3d_from_activated(s, q), alpha, c2w,
                                 fx, fy, cx, cy, cfg, extra_valid=keep)
    return proj, colour, s, keep


def render_from_params(params: dict, c2w, fx, fy, cx, cy, cfg: RenderConfig,
                       alive: torch.Tensor | None = None,
                       uv_tap: torch.Tensor | None = None,
                       surfel: SurfelConfig | None = None):
    """Raw parameter dict -> (image [H, W, 3], RenderAux).

    Args:
        params: dict with pos [N,3], scale_raw [N,3], q_raw [N,4],
            opacity_raw [N], f_dc [N,3], f_rest [N,45|9|0], all on one
            device (e.g. ``GaussianPool.params``), and optionally f_sem
            [N, C], per-gaussian features (Feature 3DGS): their map
            [C, H, W], composited with the frame's own weights, is then
            ``aux.features`` (``ops/raster_feat.py``).
        c2w: [4, 4] camera-to-world (tensor or array), moved to that device.
        alive: optional [N] bool pool-slot mask.
        uv_tap: optional [N, 2] zeros; the gradient w.r.t. it is the
            view-space positional gradient (paper-style ADC statistic).
        surfel: a surfel pool's ``SurfelConfig`` (``SurfelConfig()``
            where None): with a two-column ``scale_raw`` the frame is 2D
            Gaussian Splatting's (``ops.rasterize.rasterize_surfels``), and
            the aux holds its normal and distortion maps.

    An anchor pool's params (``pos``, ``offset``, ``anchor_feat``,
    ``scale_raw``) carry its MLPs (``mlp_opacity``, ``mlp_cov``,
    ``mlp_color``) beside them; ``alive`` is then the anchors' [A]. Its
    frame is the kept neural gaussians' (``ops.scaffold``), and the aux
    holds their scales and mask (``neural_scales``, ``neural_keep``) for
    the loss's scaling term.
    """
    c2w = _c2w(c2w, params["pos"])
    if is_anchor_pool(params):
        proj, colour, s, keep = _anchors(params, c2w, fx, fy, cx, cy, cfg,
                                         alive, uv_tap)
        img, aux = rasterize(proj, colour, cfg)
        return img, aux._replace(neural_scales=s, neural_keep=keep)
    if is_surfel_pool(params):
        proj, rows, surfel = _surfels(params, c2w, fx, fy, cx, cy, cfg,
                                      alive, uv_tap, surfel)
        return rasterize_surfels(proj, rows, cfg, surfel)
    proj, colors, _ = preprocess(params, c2w, fx, fy, cx, cy, cfg,
                                 alive=alive, uv_tap=uv_tap)
    return rasterize(proj, colors, cfg, params.get(FEATURE_KEY))


def stack_view_projections(proj_b: ProjectedGaussians, cfg: RenderConfig):
    """Stack per-view projections (fields ``[B, N, ...]``) into one scene.

    View v takes the tile rows ``[v * tiles_y, (v + 1) * tiles_y)``: its
    ``tile_min`` and ``tile_max`` rows are offset by ``v * tiles_y`` (an
    invalid slot keeps ``tmax = tmin - 1``), and ``uv`` stays view-local;
    the compositor wraps tile rows back to view-local pixel rows through
    the returned config's ``view_tile_rows`` (exact integers). Returns
    (the ``[B*N]`` projections, the config with ``height = B *
    padded_height``, ``max_pairs``, ``max_rows`` and ``bwd_pairs`` times B
    (capacities shared by the batch) and ``view_tile_rows = tiles_y``).
    """
    B, n = proj_b.uv.shape[:2]
    voff = torch.arange(B, dtype=proj_b.tile_min.dtype,
                        device=proj_b.uv.device) * cfg.tiles_y
    tile_off = torch.stack([torch.zeros_like(voff), voff], dim=-1)[:, None]
    stacked = ProjectedGaussians(
        uv=proj_b.uv.reshape(B * n, 2),
        depth=proj_b.depth.reshape(B * n),
        conic=proj_b.conic.reshape(B * n, 3),
        opacity=proj_b.opacity.reshape(B * n),
        radius=proj_b.radius.reshape(B * n),
        tile_min=(proj_b.tile_min + tile_off).reshape(B * n, 2),
        tile_max=(proj_b.tile_max + tile_off).reshape(B * n, 2),
        valid=proj_b.valid.reshape(B * n),
    )
    bcfg = cfg.with_(
        height=B * cfg.padded_height,
        max_pairs=B * cfg.max_pairs,
        max_rows=B * cfg.max_rows,
        bwd_pairs=B * cfg.bwd_pairs,
        view_tile_rows=cfg.tiles_y,
    )
    return stacked, bcfg


def _per_view(x, B: int, like: torch.Tensor) -> torch.Tensor:
    """[B] f32 on ``like``'s device from a scalar or B values."""
    t = torch.as_tensor(x, dtype=torch.float32, device=like.device)
    return torch.broadcast_to(t, (B,))


def render_batch_from_params(params: dict, c2w, fx, fy, cx, cy,
                             cfg: RenderConfig,
                             alive: torch.Tensor | None = None,
                             uv_taps: torch.Tensor | None = None):
    """Render B views in one binning and one compositor launch.

    The views' colours and projections are computed view by view (the JAX
    package's ``vmap``), stacked by :func:`stack_view_projections` into
    one image of ``B * padded_height`` rows, and rasterized once. Tiles
    never span views and the binning's depth sort is stable, so each view
    keeps its order inside the ``B*N`` pool and composites as it would
    alone: fed the same per-view projections, the batch gives each view's
    image bit for bit. Pair-capacity overflow drops the farthest pairs of
    the whole batch (``aux.num_pairs`` against ``B * max_pairs``).

    Args:
        c2w: [B, 4, 4] camera-to-world per view.
        fx, fy, cx, cy: scalars or [B] per-view intrinsics.
        alive: optional [N] bool pool mask, shared by the views.
        uv_taps: optional [B, N, 2] zeros; the gradient w.r.t. it gives each
            view's view-space positional gradient (paper-ADC statistic).

    Returns:
        (images [B, H, W, 3], RenderAux) with depth and alpha [B, H, W] and
        ``screen_radius`` [B, N]; the counts and capacities are the
        batch's.
    """
    if FEATURE_KEY in params:
        raise ValueError("batched views do not composite per-gaussian "
                         "features: render the views one at a time")
    if is_anchor_pool(params):
        raise ValueError("batched views do not decode anchors (Scaffold-GS):"
                         " render the views one at a time")
    if is_surfel_pool(params):
        raise ValueError("batched views do not composite surfels (a "
                         "two-column scale_raw): render the views one at "
                         "a time")
    pos = params["pos"]
    c2w = _c2w(c2w, pos)
    B = c2w.shape[0]
    n = pos.shape[0]
    fx, fy, cx, cy = (_per_view(a, B, pos) for a in (fx, fy, cx, cy))
    colors, projs, cov3d = [], [], None
    for v in range(B):
        proj, col, cov3d = preprocess(
            params, c2w[v], fx[v], fy[v], cx[v], cy[v], cfg, alive=alive,
            uv_tap=None if uv_taps is None else uv_taps[v], cov3d=cov3d)
        colors.append(col)
        projs.append(proj)
    proj_b = ProjectedGaussians(*(torch.stack(f) for f in zip(*projs)))
    stacked, bcfg = stack_view_projections(proj_b, cfg)
    img, aux = rasterize(stacked, torch.cat(colors), bcfg)
    H, Hp, W = cfg.height, cfg.padded_height, cfg.width
    return img.reshape(B, Hp, W, 3)[:, :H], aux._replace(
        depth=aux.depth.reshape(B, Hp, W)[:, :H],
        alpha=aux.alpha.reshape(B, Hp, W)[:, :H],
        screen_radius=proj_b.radius,
    )

"""Tile rasterization: depth-sorted alpha compositing of projected Gaussians.

Counterpart of ``gsplat_tpu/ops/rasterize.py``: ``RenderAux`` (``:44-75``),
``_pair_features`` (``:133-147``), ``gather_pair_features`` with its
backward (``:150-264``, the uncompacted branches: untruncated, and
truncated by ``tile_rank_cap``), ``rasterize_binned_pallas``
(``:462-560``) and ``rasterize`` (``:592-609``). The compositing itself
is ``ops/raster_cuda.py``: the Hopper kernels for CUDA tensors, their
plain PyTorch versions for CPU tensors, forward and backward.

``backend="xla"`` (the ``max_per_tile`` ``lax.map`` compositor) and
``bwd_pairs > 0`` (the compacted backward) raise NotImplementedError.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import RenderConfig
from .binning import TileBinning, bin_gaussians
from .clamps import clip
from .projection import ProjectedGaussians
from .raster_cuda import composite_pairs


class RenderAux(NamedTuple):
    """Extra render outputs: capacity diagnostics (never silently
    truncate) plus depth / alpha planes. Fields as in the JAX package;
    those of modes this slice does not run stay None / 0."""

    num_pairs: torch.Tensor  # [] int32 true (gaussian, tile) pair count
    pair_capacity: int
    max_tile_count: torch.Tensor  # [] int32 largest per-tile gaussian count
    per_tile_capacity: int
    depth: torch.Tensor  # [H, W] accumulated depth (sum w_i * z_i)
    alpha: torch.Tensor  # [H, W] opacity = 1 - final transmittance
    screen_radius: torch.Tensor | None = None  # [N] int32, 0 = culled
    num_rows: torch.Tensor | None = None
    row_capacity: int = 0
    num_pairs_kept: torch.Tensor | None = None
    trunc_demand: torch.Tensor | None = None
    trunc_capacity: int = 0
    # Pair slots of the blocks the compositor composited (row 5).
    bwd_demand: torch.Tensor | None = None
    bwd_capacity: int = 0


def _pair_features(proj: ProjectedGaussians, colors: torch.Tensor, dtype):
    """[N, 10] per-gaussian features (u, v, conic x3, opacity, rgb, z)."""
    feat = torch.cat(
        [
            proj.uv,
            proj.conic,
            proj.opacity[:, None],
            colors,
            proj.depth[:, None],
        ],
        dim=-1,
    ).to(dtype)
    # Zero invalid rows: culled slots may hold NaN/inf, and 0 * NaN would
    # still poison the composite.
    return torch.where(proj.valid[:, None], feat, 0.0)


def _gather(feat10: torch.Tensor, pair_slot: torch.Tensor):
    n = feat10.shape[0]
    idx = torch.clamp(pair_slot, 0, n - 1).to(torch.int64)
    out = torch.index_select(feat10.T.contiguous(), 1, idx)
    return torch.where(pair_slot[None, :] >= 0, out, 0.0)


_SCAN_BLOCK = 1024


def _cumsum_rows(x: torch.Tensor) -> torch.Tensor:
    """Inclusive cumulative sum of [R, P] along P, in two levels: within
    chunks of ``_SCAN_BLOCK``, then over the chunk totals.

    Each level is a scan along the innermost dimension of a tensor with
    many rows, so it is parallel and its order is fixed (deterministic).
    A one-level cumsum of [10, P] along P runs on CUDA as about one thread
    block for all 10 rows (a few rows, each millions long), and PyTorch's
    fast 1-D float scan is not deterministic from run to run.
    """
    R, P = x.shape
    B = _SCAN_BLOCK
    xb = torch.nn.functional.pad(x, (0, (-P) % B)).reshape(R, -1, B)
    c = torch.cumsum(xb, dim=2)
    tot = c[:, :-1, B - 1]  # every chunk's total but the last
    pre = torch.cat([tot.new_zeros(R, 1), torch.cumsum(tot, dim=1)], dim=1)
    return (c + pre[:, :, None]).reshape(R, -1)[:, :P]


class _GatherPairFeatures(torch.autograd.Function):
    """The gather with the JAX package's backward (``_gpf_bwd``,
    ``gsplat_tpu/ops/rasterize.py:217-261``, uncompacted): key each pair's
    cotangent rows by ``pair_slot`` (padding keyed to ``n``, so it sorts
    last), one stable sort that carries the rows, a cumulative sum along
    the pairs (two-level, :func:`_cumsum_rows`), and the per-gaussian
    segment difference at the group bounds: ``gauss_offsets`` (each
    gaussian's pairs are exactly its footprint count), or, for a truncated
    list, which holds a subset of each gaussian's pairs,
    ``searchsorted(sorted_key, arange(n + 1), side="left")`` (the pairs
    truncation dropped get no gradient, as they add nothing to the
    image). No atomics: autograd through ``index_select`` would be an
    ``index_add_``, whose order on CUDA varies from run to run."""

    @staticmethod
    def forward(ctx, feat10, pair_slot, gauss_offsets, truncated):
        ctx.n = feat10.shape[0]
        ctx.truncated = truncated
        ctx.save_for_backward(pair_slot, gauss_offsets)
        return _gather(feat10, pair_slot)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        pair_slot, gauss_offsets = ctx.saved_tensors
        n = ctx.n
        key = torch.where(pair_slot >= 0, pair_slot, n)
        sorted_key, perm = torch.sort(key, stable=True)
        c = _cumsum_rows(g.index_select(1, perm))
        cpad = torch.cat([c.new_zeros(g.shape[0], 1), c], dim=1)
        if ctx.truncated:
            bounds = torch.searchsorted(
                sorted_key, torch.arange(n + 1, dtype=sorted_key.dtype,
                                         device=sorted_key.device))
        else:
            bounds = gauss_offsets.to(torch.int64)
        seg = cpad[:, bounds[1:]] - cpad[:, bounds[:-1]]  # [10, N]
        return seg.T, None, None, None


def gather_pair_features(feat10: torch.Tensor, pair_slot: torch.Tensor,
                         gauss_offsets: torch.Tensor, truncated: bool = False,
                         bwd_cap: int = 0):
    """Expand per-gaussian features [N, 10] (depth order) to the sorted pair
    list, feature-major [10, padded_pairs]; padding slots (-1) are zero.

    Forward: one pairs-sized gather. Backward (recorded when grad is
    enabled and ``feat10`` requires it): the sort-based per-gaussian sum of
    :class:`_GatherPairFeatures`. ``gauss_offsets`` [N+1] are the binning's
    per-gaussian pair offsets (``TileBinning.gauss_offsets``), the group
    bounds unless ``truncated`` (a per-tile rank-truncated list: the bounds
    come from the sorted keys). ``bwd_cap > 0`` (the compacted backward) is
    not ported and raises.
    """
    if bwd_cap:
        raise NotImplementedError(
            "bwd_cap > 0 (the compacted gather backward) is not ported yet")
    if torch.is_grad_enabled() and feat10.requires_grad:
        return _GatherPairFeatures.apply(feat10, pair_slot, gauss_offsets,
                                         bool(truncated))
    return _gather(feat10, pair_slot)


def rasterize_binned(
    proj: ProjectedGaussians,
    colors: torch.Tensor,
    binning: TileBinning,
    cfg: RenderConfig,
):
    """Rasterize a precomputed aligned binning. Returns (image, aux)."""
    if cfg.bwd_pairs:
        raise NotImplementedError(
            "bwd_pairs > 0 (the compacted backward) is not ported yet")
    T = cfg.tile
    feat10 = _pair_features(proj, colors, torch.float32)[
        binning.depth_order.to(torch.int64)]
    pair_feat = gather_pair_features(feat10, binning.pair_slot,
                                     binning.gauss_offsets,
                                     truncated=cfg.tile_rank_cap > 0)
    out = composite_pairs(
        pair_feat, binning.tile_start, binning.tile_count, cfg
    )  # [num_tiles, 8, P]: rows 0-2 rgb, 3 depth, 4 transmittance

    # Tiles with no pairs: mask them, as the JAX package must.
    occupied = (binning.tile_count > 0)[:, None, None]
    tiles_out = torch.where(occupied, out[:, 0:4, :], 0.0)
    tiles_T = torch.where(occupied[:, 0, :], out[:, 4, :], 1.0)
    planes = torch.cat([tiles_out, tiles_T[:, None, :]], dim=1)  # [nt, 5, P]

    planes = planes.reshape(cfg.tiles_y, cfg.tiles_x, 5, T, T)
    planes = planes.permute(0, 3, 1, 4, 2).reshape(
        cfg.padded_height, cfg.padded_width, 5
    )[: cfg.height, : cfg.width]
    img = clip(planes[..., 0:3], 0.0, 1.0)  # JAX's tie gradient (clamps.py)

    aux = RenderAux(
        num_pairs=binning.num_pairs,
        pair_capacity=cfg.max_pairs,
        max_tile_count=torch.max(binning.tile_count),
        per_tile_capacity=cfg.padded_pairs,
        depth=planes[..., 3],
        alpha=1.0 - planes[..., 4],
        screen_radius=proj.radius,
        num_rows=binning.num_rows,
        row_capacity=0,
        num_pairs_kept=binning.num_pairs_kept,
        trunc_demand=binning.trunc_demand,
        trunc_capacity=cfg.trunc_padded_pairs if cfg.tile_rank_cap else 0,
        bwd_demand=torch.where(
            binning.tile_count > 0, out[:, 5, 0], 0.0).to(torch.int32).sum()
        * cfg.pair_block,
        bwd_capacity=0,
    )
    return img, aux


def rasterize(proj: ProjectedGaussians, colors: torch.Tensor,
              cfg: RenderConfig):
    """Bin + rasterize one view. Returns (image [H, W, 3], RenderAux)."""
    if cfg.backend == "xla":
        raise NotImplementedError(
            "backend='xla' (the max_per_tile lax.map compositor) is not "
            "ported; use 'auto' or 'pallas' (the hand-written compositor)")
    if cfg.backend not in ("auto", "pallas"):
        raise ValueError(f"unknown backend {cfg.backend!r}")
    binning = bin_gaussians(proj, cfg)
    img, aux = rasterize_binned(proj, colors, binning, cfg)
    if cfg.background != (0.0, 0.0, 0.0):
        bg = torch.tensor(cfg.background, dtype=img.dtype, device=img.device)
        img = img + (1.0 - aux.alpha)[..., None] * bg
    return img, aux

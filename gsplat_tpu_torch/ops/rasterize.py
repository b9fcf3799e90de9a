"""Tile rasterization: depth-sorted alpha compositing of projected Gaussians.

Counterpart of ``gsplat_tpu/ops/rasterize.py``: ``RenderAux`` (``:44-75``),
``_pair_features`` (``:133-147``), ``gather_pair_features`` with its
backward (``:150-264``: untruncated, truncated by ``tile_rank_cap``, and
compacted by ``bwd_cap``), ``_reduce_pair_grads`` (``:267-286``),
``_composite_gathered`` (``:289-373``, the gather and the compositor with
the compacted backward), ``rasterize_binned_pallas`` (``:462-560``) and
``rasterize`` (``:592-609``). The compositing itself is
``ops/raster_cuda.py``: the Hopper kernels for CUDA tensors, their plain
PyTorch versions for CPU tensors, forward and backward.

When autograd records, :func:`rasterize_binned` runs the gather and the
compositor as one function (:class:`_CompositeGathered`) whose backward
reduces only the blocks the forward composited, in either layout: with
``bwd_pairs = 0`` the backward kernel writes the whole list and the other
blocks are keyed out of the reduction; with ``bwd_pairs > 0`` it writes
the compact ``[10, kb*G]`` list. The reduction then sorts the same
cotangents in the same order in both and sums each gaussian's run on its
own, so a ``bwd_pairs`` at or above the demand gives the gradients of
``bwd_pairs = 0`` bit for bit.

``backend="xla"`` (the ``max_per_tile`` ``lax.map`` compositor) raises
NotImplementedError.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import RenderConfig, cdiv
from . import raster_cuda
from .binning import TileBinning, bin_gaussians
from .clamps import clip
from .projection import ProjectedGaussians


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


def _reduce_pair_grads(key, g, n: int, bounds=None):
    """Per-gaussian sums [n, 10] of the per-pair cotangent rows g [10, M]
    keyed by ``key`` [M] in [0, n] (n: no gaussian): one stable sort that
    carries the rows, then a segmented sum over each gaussian's run of the
    sorted rows (``torch.segment_reduce``), between the bounds ``bounds``
    [n + 1] if given (the groups are whole footprints), else
    ``searchsorted(sorted_key, arange(n + 1), side="left")`` (any subset
    of each gaussian's pairs; the rows keyed n fall past the last bound).

    Each gaussian's sum reads its own run alone, in sorted order, so it
    does not depend on the rows before it or on the list's length: a list
    that holds the same runs in the same order (the compacted backward
    against the whole list) reduces bit for bit alike. The JAX package
    takes a cumulative sum and differences at the bounds; a scan's
    rounding depends on where the run falls in the list, and PyTorch's
    CUDA scan also picks its thread layout from the tensor's shape. No
    atomics: autograd through ``index_select`` would be an ``index_add_``,
    whose order on CUDA varies from run to run."""
    sorted_key, perm = torch.sort(key, stable=True)
    if bounds is None:
        bounds = torch.searchsorted(
            sorted_key, torch.arange(n + 1, dtype=sorted_key.dtype,
                                     device=sorted_key.device))
    rows = g.index_select(1, perm).T  # [M, 10]
    return torch.segment_reduce(rows, "sum", offsets=bounds.to(torch.int64),
                                axis=0, initial=0.0)


_BWD_BLOCK = 128  # the compacted gather backward's block (JAX _BWD_BLOCK)


class _GatherPairFeatures(torch.autograd.Function):
    """The gather with the JAX package's backward (``_gpf_bwd``,
    ``gsplat_tpu/ops/rasterize.py:217-261``): key each pair's cotangent
    rows by ``pair_slot`` (padding keyed to ``n``, so it sorts last) and
    reduce them per gaussian (:func:`_reduce_pair_grads`) at the bounds
    ``gauss_offsets`` (each gaussian's pairs are exactly its footprint
    count), or, for a truncated list, which holds a subset of each
    gaussian's pairs, at bounds from the sorted keys (the pairs truncation
    dropped get no gradient, as they add nothing to the image). With
    ``bwd_cap`` > 0 (and a list of whole 128-pair blocks) it first drops
    the all-zero 128-pair blocks and keeps the first ``cdiv(bwd_cap, 128)``
    blocks in (nonzero first, then block) order; nonzero blocks past them
    lose their gradient, as in JAX."""

    @staticmethod
    def forward(ctx, feat10, pair_slot, gauss_offsets, truncated, bwd_cap):
        ctx.n = feat10.shape[0]
        ctx.truncated = truncated
        ctx.bwd_cap = bwd_cap
        ctx.save_for_backward(pair_slot, gauss_offsets)
        return _gather(feat10, pair_slot)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        pair_slot, gauss_offsets = ctx.saved_tensors
        n = ctx.n
        key = torch.where(pair_slot >= 0, pair_slot, n)
        rows, padded = g.shape
        compacted = bool(ctx.bwd_cap) and padded % _BWD_BLOCK == 0
        if compacted:
            nb = padded // _BWD_BLOCK
            kb = min(cdiv(ctx.bwd_cap, _BWD_BLOCK), nb)
            gb = g.reshape(rows, nb, _BWD_BLOCK)
            nz = (gb != 0.0).any(dim=2).any(dim=0)  # NaN counts as nonzero
            src = torch.argsort((~nz).to(torch.int8), stable=True)[:kb]
            g = gb[:, src, :].reshape(rows, kb * _BWD_BLOCK)
            key = key.reshape(nb, _BWD_BLOCK)[src].reshape(-1)
        exact = not (ctx.truncated or compacted)
        seg = _reduce_pair_grads(key, g, n, gauss_offsets if exact else None)
        return seg, None, None, None, None


def gather_pair_features(feat10: torch.Tensor, pair_slot: torch.Tensor,
                         gauss_offsets: torch.Tensor, truncated: bool = False,
                         bwd_cap: int = 0):
    """Expand per-gaussian features [N, 10] (depth order) to the sorted pair
    list, feature-major [10, padded_pairs]; padding slots (-1) are zero.

    Forward: one pairs-sized gather. Backward (recorded when grad is
    enabled and ``feat10`` requires it): the sort-based per-gaussian sum of
    :class:`_GatherPairFeatures`. ``gauss_offsets`` [N+1] are the binning's
    per-gaussian pair offsets (``TileBinning.gauss_offsets``), the group
    bounds unless ``truncated`` (a per-tile rank-truncated list) or
    ``bwd_cap`` > 0 (the block-compacted backward): then the bounds come
    from the sorted keys.
    """
    if torch.is_grad_enabled() and feat10.requires_grad:
        return _GatherPairFeatures.apply(feat10, pair_slot, gauss_offsets,
                                         bool(truncated), int(bwd_cap))
    return _gather(feat10, pair_slot)


class _CompositeGathered(torch.autograd.Function):
    """The gather and the compositor as one function of ``feat10`` (the
    JAX package's ``_composite_gathered``, ``rasterize.py:289-373``).

    Forward: the gather, then K1 writing its block-start state. Backward:
    K2, then :func:`_reduce_pair_grads` over the composited blocks only,
    each keyed by its ``pair_slot`` (padding and every other slot keyed
    ``n``), with bounds from the sorted keys:

    * ``cfg.bwd_pairs`` > 0: K2 in compact mode, ``kb = min(cdiv(bwd_pairs,
      G), nb)``: the first ``kb`` composited blocks in block order, as
      JAX's ``_cg_bwd`` keeps them (overflow drops the trailing tiles'
      blocks; ``RenderAux.bwd_demand`` reports it);
    * ``bwd_pairs = 0``: K2 over the whole list, the blocks not composited
      keyed ``n``. Their cotangents are exact zeros; keyed out, each
      gaussian's sorted run is the compact mode's, element for element, so
      the two reduce bit for bit alike whatever order the sum takes.

    The composited-block list comes from K1's row 5 on the device
    (``raster_cuda.composited_blocks``): no host sync.
    """

    @staticmethod
    def forward(ctx, feat10, pair_slot, tile_start, tile_count, cfg):
        pf = _gather(feat10, pair_slot)
        raster_cuda._check_inputs(pf, tile_start, tile_count, cfg)
        out, state = raster_cuda._composite_fwd(pf, tile_start, tile_count,
                                                cfg, with_state=True)
        ctx.n = feat10.shape[0]
        ctx.cfg = cfg
        ctx.save_for_backward(pf, pair_slot, tile_start, tile_count, out,
                              state)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gout):
        pf, pair_slot, tile_start, tile_count, out, state = ctx.saved_tensors
        cfg, n = ctx.cfg, ctx.n
        G = cfg.pair_block
        nb = pf.shape[1] // G
        kb = min(cdiv(cfg.bwd_pairs, G), nb)
        d = raster_cuda.composite_pairs_bwd(
            pf, tile_start, tile_count, out, state, gout.contiguous(), cfg,
            kb=kb)
        key = composited_pair_keys(pair_slot, tile_start, out, n, kb, cfg)
        return _reduce_pair_grads(key, d, n), None, None, None, None


def composited_pair_keys(pair_slot, tile_start, fwd_out, n: int, kb: int,
                         cfg: RenderConfig):
    """The reduction keys of the backward's gradient columns: each column's
    ``pair_slot`` where it belongs to a composited block, else ``n``. With
    ``kb`` > 0 the columns are the compact layout's (item i at ``[i*G,
    (i+1)*G)``, ``kb*G`` of them); with ``kb = 0`` the pair list's. Built
    on the device from the forward's row 5, with no host sync."""
    G = cfg.pair_block
    nb = pair_slot.shape[0] // G
    off = raster_cuda.tile_block_offsets(fwd_out)
    slots = pair_slot.view(nb, G)
    blk, _, _, valid = raster_cuda.composited_blocks(tile_start, off,
                                                     kb or nb, cfg)
    if kb:  # item i's slots are its block's
        slots = slots[blk]
    else:  # the composited blocks in place
        mask = torch.zeros(nb + 1, dtype=torch.bool, device=slots.device)
        mask[torch.where(valid, blk, nb)] = True
        valid = mask[:nb]
    return torch.where(valid[:, None] & (slots >= 0), slots, n).reshape(-1)


def rasterize_binned(
    proj: ProjectedGaussians,
    colors: torch.Tensor,
    binning: TileBinning,
    cfg: RenderConfig,
):
    """Rasterize a precomputed aligned binning. Returns (image, aux).

    When autograd records (``colors`` or the projection requires grad),
    the gather and the compositor run as :class:`_CompositeGathered`;
    otherwise as the gather and ``composite_pairs`` (no state written).
    """
    T = cfg.tile
    feat10 = _pair_features(proj, colors, torch.float32)[
        binning.depth_order.to(torch.int64)]
    if torch.is_grad_enabled() and feat10.requires_grad:
        out = _CompositeGathered.apply(feat10, binning.pair_slot,
                                       binning.tile_start,
                                       binning.tile_count, cfg)
    else:
        out = raster_cuda.composite_pairs(
            _gather(feat10, binning.pair_slot), binning.tile_start,
            binning.tile_count, cfg)
    # out [num_tiles, 8, P]: rows 0-2 rgb, 3 depth, 4 transmittance

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
        bwd_capacity=cfg.bwd_capacity,
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

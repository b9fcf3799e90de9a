"""Tile rasterization: depth-sorted alpha compositing of projected Gaussians.

Counterpart of ``gsplat_tpu/ops/rasterize.py``: ``RenderAux`` (``:44-75``),
``_pair_features`` (``:133-147``), ``_composite_chunk`` (``:78-130``),
``gather_pair_features`` with its backward (``:150-264``: untruncated,
truncated by ``tile_rank_cap``, and compacted by ``bwd_cap``),
``_reduce_pair_grads`` (``:267-286``), ``_composite_gathered``
(``:289-373``, the gather and the compositor with the compacted backward),
``rasterize_binned_xla`` (``:376-459``), ``rasterize_binned_pallas``
(``:462-560``), ``resolve_backend`` (``:563-576``), ``rasterize_binned``
and ``rasterize`` (``:579-609``) and the dense oracle ``rasterize_dense``
(``:612-657``).

Two compositors:

* ``"pallas"`` (and ``"auto"``): ``ops/raster_cuda.py``, the Hopper
  kernels for CUDA tensors, their plain PyTorch versions for CPU tensors,
  forward and backward. Each tile composites every pair of its list.
* ``"xla"``: :func:`rasterize_binned_xla`, plain PyTorch on either device
  (the JAX package computes it with ``lax.map`` and an einsum, outside any
  Pallas kernel). Each tile composites only its first ``max_per_tile``
  pairs, as a dense ``[C, K, P]`` cumulative product over chunks of
  ``tile_chunk`` tiles, each chunk recomputed in the backward
  (``torch.utils.checkpoint``, as JAX wraps it in ``jax.checkpoint``).

When autograd records, :func:`rasterize_binned_pallas` runs the gather and
the compositor as one function (:class:`_CompositeGathered`) whose backward
reduces only the blocks the forward composited, in either layout: with
``bwd_pairs = 0`` the backward kernel writes the whole list and the other
blocks are keyed out of the reduction; with ``bwd_pairs > 0`` it writes
the compact ``[10, kb*G]`` list. The reduction then sorts the same
cotangents in the same order in both and sums each gaussian's run on its
own, so a ``bwd_pairs`` at or above the demand gives the gradients of
``bwd_pairs = 0`` bit for bit.

When autograd does not record (serving, evaluation) and no per-gaussian
features are composited, no pair list is gathered: the per-gaussian
fields go into one depth-ordered table (:func:`_pair_table`) and K1 reads
each pair's row by its ``pair_slot`` (``raster_cuda.composite_pairs_indexed``),
the same floats, so the frame is the gathered list's bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from ..config import RenderConfig, SurfelConfig, cdiv
from ..utils.profiling import span
from . import raster_cuda, raster_feat, raster_surfel
from .binning import TileBinning, bin_gaussians, depth_order
from .clamps import clip, minimum
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
    # The feature map [C, H, W] of a pool with per-gaussian features
    # (Feature 3DGS, ``ops/raster_feat.py``), else None.
    features: torch.Tensor | None = None
    # A surfel pool's (2D Gaussian Splatting, ``ops/raster_surfel.py``)
    # normal map [H, W, 3] (sum w n, camera space) and distortion map
    # [H, W]; else None. Its ``depth`` is then sum w z and ``alpha`` sum w.
    normal: torch.Tensor | None = None
    distortion: torch.Tensor | None = None


def _composite_chunk(feats: torch.Tensor, mask: torch.Tensor,
                     cfg: RenderConfig) -> torch.Tensor:
    """Composite one chunk of tiles (the XLA compositor's body).

    Args:
        feats: [C, K, 10] per-(tile, slot) features (u, v, conic x3,
            opacity, rgb, depth), u and v relative to the tile's origin.
        mask: [C, K] slot validity.

    Returns:
        [C, T*T, 5]: rgb and depth sums, then the final transmittance.
        Pixel index ``py * T + px``.
    """
    T = cfg.tile
    P = T * T
    u = feats[..., 0:1]  # [C, K, 1]
    v = feats[..., 1:2]
    ca = feats[..., 2:3]
    cb = feats[..., 3:4]
    cc = feats[..., 4:5]
    op = feats[..., 5:6]
    chans = feats[..., 6:10]  # [C, K, 4]: rgb + depth

    pix = torch.arange(P, dtype=feats.dtype, device=feats.device)
    px = pix % T  # [P]
    py = torch.div(pix, T, rounding_mode="floor")

    du = px[None, None, :] - u  # [C, K, P]
    dv = py[None, None, :] - v
    q = ca * du * du + 2.0 * cb * du * dv + cc * dv * dv
    inside = q <= cfg.chi2_clip
    g = torch.exp(-0.5 * minimum(q, cfg.chi2_clip))
    g = torch.where(inside, g, 0.0)

    alpha = minimum(op * g, cfg.alpha_max)
    alpha = torch.where(alpha >= cfg.alpha_cutoff, alpha, 0.0)
    alpha = torch.where(mask[..., None], alpha, 0.0)

    # Front-to-back transmittance: T_i = prod_{j<i} (1 - alpha_j).
    one_minus = 1.0 - alpha
    trans = torch.cumprod(one_minus, dim=1)
    trans = torch.cat([torch.ones_like(trans[:, :1]), trans[:, :-1]], dim=1)
    alive = (trans > cfg.transmittance_min).to(alpha.dtype)
    w = alpha * trans * alive  # [C, K, P]

    # [C, P, K] @ [C, K, 4] -> [C, P, 4]: full float32 (device.py turns
    # TF32 off; the JAX package asks for precision="highest").
    out = torch.einsum("ckp,ckd->cpd", w, chans)
    t_final = trans[:, -1, :] * one_minus[:, -1, :]  # [C, P]
    return torch.cat([out, t_final[..., None]], dim=-1)


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


def _pair_table(proj: ProjectedGaussians, colors: torch.Tensor,
                depth_order: torch.Tensor):
    """The depth-ordered ``[N, raster_cuda.TABLE_WIDTH]`` table that K1
    reads by slot: :func:`_pair_features`' rows in ``depth_order`` with two
    zero columns (``raster_cuda.pair_table``: one kernel on CUDA)."""
    f32 = torch.float32
    return raster_cuda.pair_table(
        depth_order, proj.valid, proj.uv.to(f32), proj.conic.to(f32),
        proj.opacity.to(f32), colors.to(f32), proj.depth.to(f32))


_gather = raster_cuda.gather_rows


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


def _gather_k1(feat10, pair_slot, tile_start, tile_count, cfg):
    """The forward of :class:`_CompositeGathered`: the gather, then K1
    writing its block-start state. Returns (pair rows, out, state)."""
    with span("gs.gather"):
        pf = _gather(feat10, pair_slot)
    with span("gs.k1"):
        raster_cuda._check_inputs(pf, tile_start, tile_count, cfg)
        out, state = raster_cuda._composite_fwd(pf, tile_start, tile_count,
                                                cfg, with_state=True)
    return pf, out, state


def _k2_reduce(pf, pair_slot, tile_start, tile_count, out, state, gout,
               n, cfg, then=None):
    """The backward of :class:`_CompositeGathered`: K2 (compact with
    ``cfg.bwd_pairs``), then ``then`` (a function of K2's [10, pairs]
    output, which it may add to in place), then the keyed reduction.
    Returns (per-gaussian gradients [n, 10], what ``then`` returned)."""
    G = cfg.pair_block
    nb = pf.shape[1] // G
    kb = min(cdiv(cfg.bwd_pairs, G), nb)
    with span("gs.k2"):
        d = raster_cuda.composite_pairs_bwd(
            pf, tile_start, tile_count, out, state, gout.contiguous(), cfg,
            kb=kb)
    got = then(d) if then is not None else None
    with span("gs.pair_grads"):
        key = composited_pair_keys(pair_slot, tile_start, out, n, kb, cfg)
        return _reduce_pair_grads(key, d, n), got


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
        pf, out, state = _gather_k1(feat10, pair_slot, tile_start,
                                    tile_count, cfg)
        ctx.n = feat10.shape[0]
        ctx.cfg = cfg
        ctx.save_for_backward(pf, pair_slot, tile_start, tile_count, out,
                              state)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gout):
        grad, _ = _k2_reduce(*ctx.saved_tensors, gout, ctx.n, ctx.cfg)
        return grad, None, None, None, None


class _CompositeGatheredFeatures(torch.autograd.Function):
    """:class:`_CompositeGathered` with the feature map of per-gaussian
    features ``f_sem`` [N, C] (Feature 3DGS): the same gather, K1 and K2,
    and between them F1 and F2 (``raster_feat``), which read each pair's
    feature row by its gaussian (``depth_order[pair_slot]``). Outputs K1's
    tiles and the map [C, H, W]. Backward: K2, then F2 adds the feature
    channels' part of each pair's geometry gradient into K2's rows 0-5 and
    gives ``d f_sem``, then the keyed reduction of :class:`_CompositeGathered`
    over the whole list (``bwd_pairs`` must be 0)."""

    @staticmethod
    def forward(ctx, feat10, f_sem, depth_order, pair_slot, tile_start,
                tile_count, cfg):
        pf, out, state = _gather_k1(feat10, pair_slot, tile_start,
                                    tile_count, cfg)
        with span("gs.feat_k1"):
            fmap = raster_feat.composite_features(
                pf, pair_slot, depth_order, f_sem, tile_start, out, cfg)
        ctx.n = feat10.shape[0]
        ctx.cfg = cfg
        ctx.save_for_backward(pf, pair_slot, tile_start, tile_count, out,
                              state, f_sem, depth_order, fmap)
        return out, fmap

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gout, gfmap):
        (pf, pair_slot, tile_start, tile_count, out, state, f_sem,
         depth_order, fmap) = ctx.saved_tensors
        cfg = ctx.cfg

        def f2(d):
            with span("gs.feat_k2"):
                return raster_feat.composite_features_bwd(
                    pf, pair_slot, depth_order, f_sem, tile_start, out,
                    fmap, gfmap.contiguous(), d, cfg)

        grad, g_sem = _k2_reduce(pf, pair_slot, tile_start, tile_count, out,
                                 state, gout, ctx.n, cfg, then=f2)
        return grad, g_sem, None, None, None, None, None


class _CompositeSurfels(torch.autograd.Function):
    """S1 and S2 (``raster_surfel``) as one function of the surfels' rows
    [N, SURFEL_ROWS] in depth order (``ops.surfel``). Forward: S1 over the
    binning's pairs, reading each pair's row by its surfel
    (``rows[pair_slot]``; no per-pair buffer). Backward: S2's per-pair
    gradients ``[SURFEL_ROWS, pairs]``, then the keyed reduction of
    :class:`_CompositeGathered` (:func:`_reduce_pair_grads`, keyed by
    ``pair_slot``, padding keyed ``n``; the pairs S2 does not reach are
    exact zeros)."""

    @staticmethod
    def forward(ctx, rows, pair_slot, tile_start, tile_count, cfg, sc):
        tab = raster_surfel.table(rows.detach())
        with span("gs.s1"):
            out = raster_surfel.composite_surfels(tab, pair_slot, tile_start,
                                                  tile_count, cfg, sc)
        ctx.n = rows.shape[0]
        ctx.cfg, ctx.sc = cfg, sc
        ctx.save_for_backward(tab, pair_slot, tile_start, tile_count, out)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gout):
        tab, pair_slot, tile_start, tile_count, out = ctx.saved_tensors
        with span("gs.s2"):
            d = raster_surfel.composite_surfels_bwd(
                tab, pair_slot, tile_start, tile_count, out,
                gout.contiguous(), ctx.cfg, ctx.sc)
        with span("gs.pair_grads"):
            key = torch.where(pair_slot >= 0, pair_slot, ctx.n)
            grad = _reduce_pair_grads(key, d, ctx.n)
        return grad, None, None, None, None, None


def rasterize_surfels(proj: ProjectedGaussians, rows: torch.Tensor,
                      cfg: RenderConfig, sc: SurfelConfig):
    """Bin and composite one view of surfels (``ops.surfel``'s projection
    and rows) through ``raster_surfel``: S1 on CUDA tensors, its plain
    version on CPU tensors, as :class:`_CompositeSurfels` when autograd
    records. Returns (image [H, W, 3] clipped to [0, 1], RenderAux with
    ``depth`` sum w z, ``alpha`` sum w, ``normal`` and ``distortion``)."""
    raster_surfel.check_config(cfg)
    binning = bin_gaussians(proj, cfg)
    with span("gs.gather"):
        rows_d = rows.index_select(0, binning.depth_order.to(torch.int64))
    if torch.is_grad_enabled() and rows_d.requires_grad:
        out = _CompositeSurfels.apply(rows_d, binning.pair_slot,
                                      binning.tile_start, binning.tile_count,
                                      cfg, sc)
    else:
        with span("gs.s1"):
            out = raster_surfel.composite_surfels(
                raster_surfel.table(rows_d), binning.pair_slot,
                binning.tile_start, binning.tile_count, cfg, sc)
    T = cfg.tile
    planes = out[:, :9].reshape(cfg.tiles_y, cfg.tiles_x, 9, T, T).permute(
        0, 3, 1, 4, 2).reshape(cfg.padded_height, cfg.padded_width, 9)[
            :cfg.height, :cfg.width]
    img = clip(planes[..., 0:3], 0.0, 1.0)
    alpha = planes[..., 4]
    if cfg.background != (0.0, 0.0, 0.0):
        bg = torch.tensor(cfg.background, dtype=img.dtype, device=img.device)
        img = img + (1.0 - alpha)[..., None] * bg
    aux = RenderAux(
        num_pairs=binning.num_pairs,
        pair_capacity=cfg.max_pairs,
        max_tile_count=torch.max(binning.tile_count),
        per_tile_capacity=cfg.padded_pairs,
        depth=planes[..., 3],
        alpha=alpha,
        screen_radius=proj.radius,
        num_rows=binning.num_rows,
        num_pairs_kept=binning.num_pairs_kept,
        trunc_demand=binning.trunc_demand,
        normal=planes[..., 5:8],
        distortion=planes[..., 8],
    )
    return img, aux


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


def _assemble_planes(tiles: torch.Tensor, cfg: RenderConfig):
    """[num_tiles, 5, T*T] tile planes -> [H, W, 5] image planes."""
    T = cfg.tile
    planes = tiles.reshape(cfg.tiles_y, cfg.tiles_x, 5, T, T)
    return planes.permute(0, 3, 1, 4, 2).reshape(
        cfg.padded_height, cfg.padded_width, 5
    )[: cfg.height, : cfg.width]


def rasterize_binned_xla(
    proj: ProjectedGaussians,
    colors: torch.Tensor,
    binning: TileBinning,
    cfg: RenderConfig,
):
    """Rasterize a precomputed pair list with the dense per-tile compositor
    (the JAX package's XLA path). Returns (image, aux).

    Each tile composites only its first ``cfg.max_per_tile`` pairs (its
    front-most ones: the list is depth-ordered within a tile), whatever the
    tile holds, so it differs from the kernel path wherever a tile holds
    more. Tiles go ``cfg.tile_chunk`` at a time through
    :func:`_composite_chunk`; when autograd records, each chunk runs under
    ``torch.utils.checkpoint`` (its ``[C, K, P]`` intermediates are
    recomputed in the backward, not kept), and the gradients flow through
    the gathers by autograd. ``cfg.view_tile_rows`` wraps tile rows per
    view (batched views). Any tile size; no kernel on either device. The
    aux reports ``per_tile_capacity = max_per_tile`` and, as in JAX, no
    ``bwd_demand`` (None) and ``bwd_capacity`` 0."""
    dtype = colors.dtype
    dev = colors.device
    T = cfg.tile
    K = cfg.max_per_tile
    C = cfg.tile_chunk
    num_tiles = cfg.num_tiles
    num_chunks = cdiv(num_tiles, C)
    i64 = torch.int64

    # Flat per-pair features, tile-major depth-ordered: one gather through
    # the depth order (pair_slot indexes depth-sorted gaussians; it is the
    # trunc-compacted layout when tile_rank_cap is set).
    cap = binning.pair_slot.shape[0]
    s_idx = binning.pair_slot.to(i64)  # [cap], -1 = padding slot
    feat = _pair_features(proj, colors, dtype)[binning.depth_order.to(i64)]
    pair_feat = feat[torch.clamp(s_idx, 0, feat.shape[0] - 1)]  # [cap, 10]
    pair_feat = torch.where(s_idx[:, None] >= 0, pair_feat, 0.0)

    # Tile origins of every tile; view_tile_rows wraps tile rows per view
    # (exact integers, as raster_cuda.tile_rows).
    tids = torch.arange(num_chunks * C, dtype=i64, device=dev)
    tys = tids // cfg.tiles_x
    if cfg.view_tile_rows:
        tys = tys % cfg.view_tile_rows
    ox = (tids % cfg.tiles_x * T).to(dtype)
    oy = (tys * T).to(dtype)
    pad = torch.zeros(num_chunks * C - num_tiles, dtype=i64, device=dev)
    starts_all = torch.cat([binning.tile_start.to(i64), pad])
    counts_all = torch.cat([binning.tile_count.to(i64), pad])
    slot = torch.arange(K, dtype=i64, device=dev)

    def chunk_fn(pair_feat, st, ct, cox, coy):
        idx = torch.clamp(st[:, None] + slot[None, :], 0, cap - 1)  # [C, K]
        mask = slot[None, :] < torch.clamp(ct, max=K)[:, None]
        feats = pair_feat[idx]  # [C, K, 10]
        # uv tile-local, so the compositor works in [0, T) coordinates.
        local = torch.cat([feats[..., 0:1] - cox[:, None, None],
                           feats[..., 1:2] - coy[:, None, None],
                           feats[..., 2:]], dim=-1)
        return _composite_chunk(local, mask, cfg)  # [C, T*T, 5]

    remat = torch.is_grad_enabled() and pair_feat.requires_grad
    outs = []
    for c in range(num_chunks):
        sl = slice(c * C, (c + 1) * C)
        args = (pair_feat, starts_all[sl], counts_all[sl], ox[sl], oy[sl])
        outs.append(checkpoint(chunk_fn, *args, use_reentrant=False)
                    if remat else chunk_fn(*args))
    tiles_out = torch.cat(outs)[:num_tiles]  # [num_tiles, T*T, 5]
    planes = _assemble_planes(tiles_out.transpose(1, 2), cfg)
    img = clip(planes[..., 0:3], 0.0, 1.0)  # JAX's tie gradient (clamps.py)

    aux = RenderAux(
        num_pairs=binning.num_pairs,
        pair_capacity=cfg.max_pairs,
        max_tile_count=torch.max(binning.tile_count),
        per_tile_capacity=K,
        depth=planes[..., 3],
        alpha=1.0 - planes[..., 4],
        screen_radius=proj.radius,
        num_rows=binning.num_rows,
        row_capacity=cfg.row_capacity if cfg.cull_mode == "ellipse" else 0,
        num_pairs_kept=binning.num_pairs_kept,
        trunc_demand=binning.trunc_demand,
        trunc_capacity=cfg.trunc_padded_pairs if cfg.tile_rank_cap else 0,
    )
    return img, aux


def rasterize_binned_pallas(
    proj: ProjectedGaussians,
    colors: torch.Tensor,
    binning: TileBinning,
    cfg: RenderConfig,
    features: torch.Tensor | None = None,
):
    """Rasterize a precomputed aligned binning through ``raster_cuda`` (the
    kernels on CUDA tensors, their plain versions on CPU tensors). Returns
    (image, aux).

    When autograd records (``colors`` or the projection requires grad),
    the gather and the compositor run as :class:`_CompositeGathered`.
    Otherwise nothing is gathered: ``raster_cuda.composite_pairs_indexed``
    reads each pair's row by its ``pair_slot`` from the depth-ordered
    table (no state written; the same output bit for bit).
    ``features`` [N, C] (per-gaussian features, Feature 3DGS) adds their
    map [C, H, W] as ``aux.features``: F1 and F2 of ``raster_feat``
    (:class:`_CompositeGatheredFeatures` when autograd records), which
    read the gathered pair list's geometry.
    """
    fmap = None
    if features is not None:
        raster_feat.check_config(cfg, features.shape[1])
    recorded = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (
            proj.uv, proj.conic, proj.opacity, proj.depth, colors, features))
    indexed = not recorded and features is None  # K1 reads the table by slot
    with span("gs.gather"):
        if indexed:
            table = _pair_table(proj, colors, binning.depth_order)
        else:
            feat10 = _pair_features(proj, colors, torch.float32)[
                binning.depth_order.to(torch.int64)]
            if not recorded:
                pf = _gather(feat10, binning.pair_slot)
    if indexed:
        with span("gs.k1"):
            out = raster_cuda.composite_pairs_indexed(
                table, binning.pair_slot, binning.tile_start,
                binning.tile_count, cfg)
    elif recorded and features is not None:
        out, fmap = _CompositeGatheredFeatures.apply(
            feat10, features, binning.depth_order, binning.pair_slot,
            binning.tile_start, binning.tile_count, cfg)
    elif recorded:
        out = _CompositeGathered.apply(feat10, binning.pair_slot,
                                       binning.tile_start,
                                       binning.tile_count, cfg)
    else:
        with span("gs.k1"):
            out = raster_cuda.composite_pairs(pf, binning.tile_start,
                                              binning.tile_count, cfg)
        if features is not None:
            with span("gs.feat_k1"):
                fmap = raster_feat.composite_features(
                    pf, binning.pair_slot, binning.depth_order, features,
                    binning.tile_start, out, cfg)
    # out [num_tiles, 8, P]: rows 0-2 rgb, 3 depth, 4 transmittance

    # Tiles with no pairs: mask them, as the JAX package must.
    occupied = (binning.tile_count > 0)[:, None, None]
    tiles_out = torch.where(occupied, out[:, 0:4, :], 0.0)
    tiles_T = torch.where(occupied[:, 0, :], out[:, 4, :], 1.0)
    planes = _assemble_planes(
        torch.cat([tiles_out, tiles_T[:, None, :]], dim=1), cfg)
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
        row_capacity=cfg.row_capacity if cfg.cull_mode == "ellipse" else 0,
        num_pairs_kept=binning.num_pairs_kept,
        trunc_demand=binning.trunc_demand,
        trunc_capacity=cfg.trunc_padded_pairs if cfg.tile_rank_cap else 0,
        bwd_demand=torch.where(
            binning.tile_count > 0, out[:, 5, 0], 0.0).to(torch.int32).sum()
        * cfg.pair_block,
        bwd_capacity=cfg.bwd_capacity,
        features=fmap,
    )
    return img, aux


def resolve_backend(cfg: RenderConfig) -> str:
    """The compositor a config asks for: ``"pallas"`` or ``"xla"``.

    ``"auto"`` is ``"pallas"`` on both devices here: the K1 kernel on CUDA
    tensors and its plain version, which has the kernel's semantics (every
    pair of a tile composited), on CPU tensors. The JAX package's
    ``"auto"`` means ``"xla"`` off a TPU, so an ``"auto"`` config that
    overflows ``max_per_tile`` in some tile renders differently in the two
    packages off a TPU; ask for ``"xla"`` to get JAX's fallback."""
    if cfg.backend == "auto":
        return "pallas"
    if cfg.backend not in ("pallas", "xla"):
        raise ValueError(f"unknown backend {cfg.backend!r}")
    return cfg.backend


def rasterize_binned(
    proj: ProjectedGaussians,
    colors: torch.Tensor,
    binning: TileBinning,
    cfg: RenderConfig,
    features: torch.Tensor | None = None,
):
    """Rasterize a precomputed aligned binning with ``cfg``'s compositor
    (:func:`resolve_backend`). Returns (image, aux). ``features`` [N, C]:
    per-gaussian features whose map becomes ``aux.features`` (the kernel
    compositor only)."""
    if resolve_backend(cfg) == "xla":
        if features is not None:
            raise ValueError("per-gaussian features take the kernel "
                             "compositor (backend 'auto' or 'pallas'), "
                             "not 'xla'")
        return rasterize_binned_xla(proj, colors, binning, cfg)
    return rasterize_binned_pallas(proj, colors, binning, cfg, features)


def rasterize(proj: ProjectedGaussians, colors: torch.Tensor,
              cfg: RenderConfig, features: torch.Tensor | None = None):
    """Bin + rasterize one view. Returns (image [H, W, 3], RenderAux);
    ``features`` as :func:`rasterize_binned`."""
    img, aux = rasterize_binned(proj, colors, bin_gaussians(proj, cfg), cfg,
                                features)
    if cfg.background != (0.0, 0.0, 0.0):
        bg = torch.tensor(cfg.background, dtype=img.dtype, device=img.device)
        img = img + (1.0 - aux.alpha)[..., None] * bg
    return img, aux


def rasterize_dense(proj: ProjectedGaussians, colors: torch.Tensor,
                    cfg: RenderConfig, row_chunk: int = 16) -> torch.Tensor:
    """Oracle rasterizer: every gaussian against every pixel (tests only).

    The reference math with no tiling, ``row_chunk`` image rows at a time;
    memory O(N * row_chunk * W). Returns the [H, W, 3] image."""
    dtype = colors.dtype
    dev = colors.device
    order = depth_order(proj.depth, proj.valid).to(torch.int64)
    ok = proj.valid[order]
    # Zero every field of invalid slots: culled gaussians may carry NaNs.
    u = torch.where(ok, proj.uv[order, 0], 0.0)
    v = torch.where(ok, proj.uv[order, 1], 0.0)
    con = torch.where(ok[:, None], proj.conic[order], 0.0)
    op = torch.where(ok, proj.opacity[order], 0.0)
    rgb = torch.where(ok[:, None], colors[order], 0.0)

    H, W = cfg.height, cfg.width
    pad_h = cdiv(H, row_chunk) * row_chunk
    xs = torch.arange(W, dtype=dtype, device=dev)
    rows = []
    for r0 in range(pad_h // row_chunk):
        ys = r0 * row_chunk + torch.arange(row_chunk, dtype=dtype,
                                           device=dev)
        du = xs[None, None, :] - u[:, None, None]  # [N, 1, W]
        dv = ys[None, :, None] - v[:, None, None]  # [N, R, 1]
        q = (con[:, 0, None, None] * du * du
             + 2.0 * con[:, 1, None, None] * du * dv
             + con[:, 2, None, None] * dv * dv)
        inside = q <= cfg.chi2_clip
        g = torch.where(inside,
                        torch.exp(-0.5 * minimum(q, cfg.chi2_clip)), 0.0)
        alpha = minimum(op[:, None, None] * g, cfg.alpha_max)
        alpha = torch.where(alpha >= cfg.alpha_cutoff, alpha, 0.0)
        trans = torch.cumprod(1.0 - alpha, dim=0)
        trans = torch.cat([torch.ones_like(trans[:1]), trans[:-1]], dim=0)
        alive = (trans > cfg.transmittance_min).to(dtype)
        w = alpha * trans * alive  # [N, R, W]
        rows.append(torch.einsum("nrw,nd->rwd", w, rgb))
    img = torch.cat(rows)[:H]
    return clip(img, 0.0, 1.0)

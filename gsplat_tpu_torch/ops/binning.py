"""Static-shape tile binning: (gaussian, tile) pair expansion + sort.

Counterpart of ``gsplat_tpu/ops/binning.py:60-108`` and the rect-mode,
untruncated path of ``bin_gaussians`` (``:348-490``, ``:709-811``). The
outputs are bit-identical to the JAX package, dead blocks and overflow
included: ``pair_slot``, ``tile_start``, ``tile_count``, ``block_meta``
(``tile << 2 | dead << 1 | first``), ``num_pairs`` (the true demand),
``depth_order`` and ``gauss_offsets``. On capacity overflow whole
gaussians are dropped from the back of the depth order.

The JAX package built these outputs around TPU costs (int8 MXU cover
counts, a two-level cumsum, 10-bit packed delta cumsums). The port
computes them directly: a binary search expands the pairs, a scatter-add
counts pairs per tile, and one int64 sort orders them. Every shape stays
static (the capacity ``cfg.max_pairs``), so a frame needs no host sync.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import RenderConfig
from .projection import ProjectedGaussians
from .raster_cuda import pack_block_meta


class TileBinning(NamedTuple):
    """Sorted, block-aligned (gaussian, tile) pair list + per-tile ranges.

    The pair list has static length ``cfg.padded_pairs`` and is tile-major
    with each tile's run starting at a multiple of ``cfg.pair_block``;
    padding slots hold -1. ``pair_slot`` indexes into the DEPTH-SORTED
    gaussian order: gaussian_id = depth_order[pair_slot].
    """

    pair_slot: torch.Tensor  # [padded_pairs] int32 depth-rank; -1 = padding
    tile_start: torch.Tensor  # [num_tiles] int32 first pair slot of tile
    tile_count: torch.Tensor  # [num_tiles] int32 real pairs in tile
    block_meta: torch.Tensor  # [num_blocks] int32 packed block metadata
    num_pairs: torch.Tensor  # [] int32 true pair count (may exceed capacity!)
    depth_order: torch.Tensor  # [N] int32 gaussian indices sorted by depth
    gauss_offsets: torch.Tensor  # [N+1] int32 presort segment boundaries
    # Fields of the ellipse / truncation modes; in rect mode without
    # truncation they hold what the JAX package reports there.
    num_rows: torch.Tensor | None = None
    num_pairs_kept: torch.Tensor | None = None
    trunc_demand: torch.Tensor | None = None


def depth_order(depth: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Global front-to-back order [N] (stable); invalid gaussians sort last."""
    key = torch.where(valid, depth, torch.inf)
    return torch.argsort(key, stable=True).to(torch.int32)


def _check_supported(cfg: RenderConfig):
    if cfg.cull_mode == "ellipse":
        raise NotImplementedError(
            "cull_mode='ellipse' is not ported yet (rect only)")
    if cfg.cull_mode != "rect":
        raise ValueError(f"unknown cull_mode {cfg.cull_mode!r}")
    if cfg.tile_rank_cap:
        raise NotImplementedError(
            "tile_rank_cap > 0 (per-tile truncation and the occlusion cull) "
            "is not ported yet")


def bin_gaussians(proj: ProjectedGaussians, cfg: RenderConfig) -> TileBinning:
    """Build the block-aligned sorted pair list for one view (static shapes)."""
    _check_supported(cfg)
    dev = proj.depth.device
    i64 = torch.int64
    n = proj.depth.shape[0]
    num_tiles = cfg.num_tiles
    cap = cfg.max_pairs
    G = cfg.pair_block
    cap_pad = cfg.padded_pairs
    num_blocks = cap_pad // G

    order = depth_order(proj.depth, proj.valid)
    order_l = order.to(i64)

    # Footprint counts in DEPTH order, so that capacity overflow drops the
    # farthest gaussians' pairs first.
    tile_min = proj.tile_min[order_l].to(i64)
    tile_max = proj.tile_max[order_l].to(i64)
    n_u = torch.clamp(tile_max[:, 0] - tile_min[:, 0] + 1, min=0)
    n_v = torch.clamp(tile_max[:, 1] - tile_min[:, 1] + 1, min=0)
    counts = n_u * n_v

    # Overflow drops WHOLE gaussians from the back of the depth order.
    full_cum = torch.cumsum(counts, 0)
    total = full_cum[-1]  # true demand (reported; may exceed cap)
    counts = torch.where(full_cum <= cap, counts, 0)
    offsets = torch.cat(
        [torch.zeros(1, dtype=i64, device=dev), torch.cumsum(counts, 0)]
    )  # [N+1] exclusive offsets (post-drop)

    # --- expansion: owner depth-slot of pair p = #(offsets <= p) - 1 ---
    p = torch.arange(cap, dtype=i64, device=dev)
    slot = torch.searchsorted(offsets, p, right=True) - 1  # n past the end
    pair_ok = slot < n
    s = torch.clamp(slot, max=n - 1)
    local = p - offsets[s]
    nu = torch.clamp(n_u[s], min=1)
    tx = tile_min[s, 0] + local % nu
    ty = tile_min[s, 1] + local // nu
    tile_id = torch.where(pair_ok, ty * cfg.tiles_x + tx, num_tiles)

    # --- exact per-tile counts (integer scatter-add: deterministic) ---
    tile_count = torch.zeros(num_tiles + 1, dtype=i64, device=dev)
    tile_count.scatter_add_(0, tile_id, torch.ones_like(tile_id))
    tile_count = tile_count[:num_tiles]

    # --- one sort: tile-major, depth-ordered within a tile ---
    # Keys are unique for real pairs; every unused capacity slot carries
    # the sentinel (tile num_tiles) and sorts last.
    key = torch.where(pair_ok, tile_id * (n + 1) + slot, num_tiles * (n + 1))
    sorted_key, _ = torch.sort(key)
    st = sorted_key // (n + 1)  # owning tile; num_tiles = unused
    ss = sorted_key % (n + 1)  # depth slot

    # --- block alignment: each tile's run padded to a multiple of G ---
    padded_count = tile_count + (-tile_count) % G
    zero1 = torch.zeros(1, dtype=i64, device=dev)
    padded_start = torch.cat([zero1, torch.cumsum(padded_count, 0)])  # [T+1]
    real_start = torch.cat([zero1, torch.cumsum(tile_count, 0)])  # [T+1]
    ok = st < num_tiles
    dest = padded_start[st] + (p - real_start[st])
    # Unused slots scatter to one extra trailing element, cut off below.
    pair_slot = torch.full((cap_pad + 1,), -1, dtype=i64, device=dev)
    pair_slot.scatter_(0, torch.where(ok, dest, cap_pad),
                       torch.where(ok, ss, -1))
    pair_slot = pair_slot[:cap_pad]

    # --- per-block metadata: owning tile, first / continuation / dead ---
    b0 = torch.arange(num_blocks, dtype=i64, device=dev) * G
    block_tile = torch.searchsorted(padded_start, b0, right=True) - 1
    block_tile = torch.clamp(block_tile, 0, num_tiles - 1)
    block_used = b0 < padded_start[num_tiles]
    block_first = torch.where(
        block_used, (b0 == padded_start[block_tile]).to(i64), -1
    )
    block_meta = pack_block_meta(block_tile, block_first)

    i32 = torch.int32
    total = total.to(i32)
    return TileBinning(
        pair_slot=pair_slot.to(i32),
        tile_start=padded_start[:num_tiles].to(i32),
        tile_count=tile_count.to(i32),
        block_meta=block_meta.to(i32),
        num_pairs=total,
        depth_order=order,
        gauss_offsets=offsets.to(i32),
        num_rows=torch.zeros((), dtype=i32, device=dev),
        num_pairs_kept=total,
        trunc_demand=torch.zeros((), dtype=i32, device=dev),
    )

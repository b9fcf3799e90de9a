"""Static-shape tile binning: (gaussian, tile) pair expansion + sort.

Counterpart of ``gsplat_tpu/ops/binning.py`` in rect mode: ``bin_gaussians``
(``:709-884``) with its expansion (``:348-490``), the exact tile cover
counts (``_rect_cover_counts``, ``:127-199``), the pre-sort occlusion cull
(``_occlusion_cull``, ``:202-321``) and the per-tile rank truncation
(``:815-871``). The outputs are bit-identical to the JAX package, dead
blocks and overflow included: ``pair_slot``, ``tile_start``,
``tile_count``, ``block_meta`` (``tile << 2 | dead << 1 | first``),
``num_pairs`` (the true demand, after the cull), ``depth_order``,
``gauss_offsets``, ``num_pairs_kept`` and ``trunc_demand``. On capacity
overflow whole gaussians are dropped from the back of the depth order.

The JAX package built these outputs around TPU costs (int8 MXU cover
counts, a two-level cumsum, 10-bit packed delta cumsums). The port
computes them directly: a binary search expands the pairs, a scatter-add
counts pairs per tile, one int64 sort orders them, and cover counts are a
four-corner integer scatter-add and two cumulative sums (integer adds are
exact in any order). Every shape stays static (the capacities
``cfg.max_pairs`` and ``cfg.trunc_padded_pairs``), so a frame needs no
host sync.

``cull_mode="ellipse"`` raises ``NotImplementedError``, with or without
truncation.
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
    # num_rows: the ellipse mode's row demand (0 in rect mode).
    num_rows: torch.Tensor | None = None
    # Per-tile rank truncation (cfg.tile_rank_cap > 0): the pair list above
    # is the block-compacted truncated layout (length trunc_padded_pairs).
    # num_pairs_kept = real pairs within every tile's cap; trunc_demand =
    # block-aligned slots the kept blocks need, to compare with
    # cfg.trunc_padded_pairs (trailing blocks drop when it exceeds it).
    # Both count every tile's pairs before the max_pairs drop, so a probe
    # with a small max_pairs reports the same. Without truncation they are
    # num_pairs and 0.
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


def _cover_counts(y0, y1, x0, x1, kept, tiles_y: int, tiles_x: int,
                  chunk=None, chunks: int = 1):
    """Exact int64 tile cover counts of axis-aligned tile rectangles
    (``_rect_cover_counts``): ``[chunks, tiles_y, tiles_x]``, entry
    ``[c, y, x]`` the number of i with ``kept[i]``, ``chunk[i] == c`` (all
    in chunk 0 without ``chunk``) and ``y0 <= y < y1``, ``x0 <= x < x1``
    (exclusive ends). A +1/-1 at the four corners of each rectangle,
    scatter-added, then a cumulative sum over y and one over x: integer
    sums, exact in any order."""
    dev = y0.device
    i64 = torch.int64
    ty1, tx1 = tiles_y + 1, tiles_x + 1

    def c(a, hi):  # clipping a rectangle to the grid keeps its tiles
        return torch.clamp(a.to(i64), 0, hi)

    y0, y1, x0, x1 = c(y0, tiles_y), c(y1, tiles_y), c(x0, tiles_x), \
        c(x1, tiles_x)
    base = 0 if chunk is None else chunk.to(i64) * (ty1 * tx1)
    w = kept.to(i64)
    idx = torch.cat([base + y0 * tx1 + x0, base + y0 * tx1 + x1,
                     base + y1 * tx1 + x0, base + y1 * tx1 + x1])
    grid = torch.zeros(chunks * ty1 * tx1, dtype=i64, device=dev)
    grid.scatter_add_(0, idx, torch.cat([w, -w, -w, w]))
    grid = grid.view(chunks, ty1, tx1).cumsum(1).cumsum(2)
    return grid[:, :tiles_y, :tiles_x]


def _occlusion_cull(tile_min, n_u, n_v, counts, cfg: RenderConfig):
    """Pre-sort occlusion cull of the rank-truncated path (JAX
    ``_occlusion_cull``): zero the footprint count of every gaussian whose
    depth rank within its tile provably reaches ``cap_t = rank_cap_blocks
    * pair_block`` at every tile of its footprint. Truncation drops all
    such pairs anyway, and removing them changes no tile's first cap_t
    pairs, so the truncated output is bit-identical with the cull on or
    off; the demand before the sort falls.

    The bound: the depth order is cut into ``cfg.cull_chunks`` chunks;
    ``cnt[c]`` counts, per tile, the kept gaussians of chunks 0..c; min
    tables over 2^l x 2^l squares anchored at each tile (clamped at cap_t,
    int16 when cap_t < 2^15, padded with cap_t past the grid) give for a
    gaussian of chunk c > 0 the largest of the four corner-anchored
    squares' minima of ``cnt[c - 1]`` that cover its rectangle: a lower
    bound of the gaussians strictly in front of it at each of its tiles.
    Gaussians of chunk 0 are never culled. Inputs in depth order (int64
    ``tile_min`` [N, 2], ``n_u``, ``n_v``, ``counts`` [N])."""
    n = counts.shape[0]
    dev = counts.device
    C = max(int(cfg.cull_chunks), 1)
    chunk = -(-n // C)
    TY, TX = cfg.tiles_y, cfg.tiles_x
    cap_t = cfg.rank_cap_blocks * cfg.pair_block

    kept = counts > 0
    x0 = tile_min[:, 0]
    y0 = tile_min[:, 1]
    x1 = x0 + n_u  # exclusive
    y1 = y0 + n_v
    cidx = torch.arange(n, dtype=torch.int64, device=dev) // chunk
    cnt = torch.cumsum(_cover_counts(y0, y1, x0, x1, kept, TY, TX, cidx, C),
                       dim=0)  # [C, TY, TX] counts through chunk c

    tab_dtype = torch.int16 if cap_t < 2**15 else torch.int32
    big = cap_t if cap_t < 2**15 else 2**30
    cur = torch.clamp(cnt, max=cap_t).to(tab_dtype)
    L = 1
    while (1 << (L - 1)) < max(TY, TX):
        L += 1  # 2^(L-1) >= any span: every query level exists
    tabs = [cur]
    for lv in range(1, L):
        sh = 1 << (lv - 1)
        pad = cur.new_full((C, sh, TX), big)
        cur = torch.minimum(cur, torch.cat([cur, pad], dim=1)[:, sh:, :])
        pad = cur.new_full((C, TY, sh), big)
        cur = torch.minimum(cur, torch.cat([cur, pad], dim=2)[:, :, sh:])
        tabs.append(cur)
    flat = torch.stack(tabs, dim=1).reshape(-1)  # [C * L * TY * TX]

    span = torch.clamp(torch.maximum(n_u, n_v), min=1)
    lvl = torch.zeros(n, dtype=torch.int64, device=dev)
    for lv in range(L - 1):
        lvl += (span > (1 << lv)).to(torch.int64)
    s = torch.bitwise_left_shift(torch.ones_like(lvl), lvl)
    base = ((cidx - 1) * L + lvl) * (TY * TX)
    lim = C * L * TY * TX - 1
    yb = torch.clamp(y1 - s, 0, TY - 1)
    xb = torch.clamp(x1 - s, 0, TX - 1)

    def cell(cy, cx):
        i = base + torch.clamp(cy, 0, TY - 1) * TX \
            + torch.clamp(cx, 0, TX - 1)
        return flat[torch.clamp(i, 0, lim)]

    lb = torch.maximum(torch.maximum(cell(y0, x0), cell(y0, xb)),
                       torch.maximum(cell(yb, x0), cell(yb, xb)))
    occluded = kept & (cidx > 0) & (lb >= cap_t)
    return torch.where(occluded, 0, counts)


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
    if cfg.tile_rank_cap and cfg.occlusion_cull:
        # Before the capacity drop, so num_pairs is the demand after it.
        counts = _occlusion_cull(tile_min, n_u, n_v, counts, cfg)

    # Overflow drops WHOLE gaussians from the back of the depth order.
    full_cum = torch.cumsum(counts, 0)
    total = full_cum[-1]  # true demand (reported; may exceed cap)
    kept_pre = counts > 0  # before the capacity drop
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
    tile_start = padded_start[:num_tiles]
    kept_pairs = total
    trunc_demand = torch.zeros((), dtype=i64, device=dev)

    if cfg.tile_rank_cap:
        # --- per-tile rank truncation: keep each tile's first Kb blocks,
        # compacted block by block into the trunc_padded_pairs list ---
        Kb = cfg.rank_cap_blocks
        keepb = torch.clamp(padded_count // G, max=Kb)  # [T] blocks kept
        new_start_b = torch.cat([zero1, torch.cumsum(keepb, 0)])  # [T+1]
        n_new = cfg.num_trunc_blocks
        nb0 = torch.arange(n_new, dtype=i64, device=dev)
        nb_tile = torch.clamp(
            torch.searchsorted(new_start_b, nb0, right=True) - 1,
            0, num_tiles - 1)
        nb_used = nb0 < new_start_b[num_tiles]
        src_block = torch.clamp(
            padded_start[nb_tile] // G + (nb0 - new_start_b[nb_tile]),
            0, num_blocks - 1)
        nb_first = torch.where(
            nb_used, (nb0 == new_start_b[nb_tile]).to(i64), -1)
        block_meta = pack_block_meta(nb_tile, nb_first)
        pair_slot = torch.where(
            nb_used[:, None], pair_slot.view(num_blocks, G)[src_block], -1
        ).reshape(-1)
        cap_t = Kb * G
        # Reported demand from the tile counts before the capacity drop,
        # so a probe's own max_pairs cannot hide it.
        y0g, x0g = tile_min[:, 1], tile_min[:, 0]
        tile_count_true = _cover_counts(
            y0g, y0g + n_v, x0g, x0g + n_u, kept_pre, cfg.tiles_y,
            cfg.tiles_x).reshape(num_tiles)
        kept_pairs = torch.sum(torch.clamp(tile_count_true, max=cap_t))
        trunc_demand = torch.sum(
            torch.clamp((tile_count_true + G - 1) // G, max=Kb)) * G
        tile_start = torch.clamp(new_start_b[:num_tiles] * G,
                                 max=cfg.trunc_padded_pairs - 1)
        # A tile whose first block fell past the capacity is never
        # composited: count 0. Tiles that lost only deeper blocks keep a
        # front-most prefix; the overflow is reported by trunc_demand.
        tile_count = torch.where(new_start_b[:num_tiles] < n_new,
                                 torch.clamp(tile_count, max=cap_t), 0)

    i32 = torch.int32
    return TileBinning(
        pair_slot=pair_slot.to(i32),
        tile_start=tile_start.to(i32),
        tile_count=tile_count.to(i32),
        block_meta=block_meta.to(i32),
        num_pairs=total.to(i32),
        depth_order=order,
        gauss_offsets=offsets.to(i32),
        num_rows=torch.zeros((), dtype=i32, device=dev),
        num_pairs_kept=kept_pairs.to(i32),
        trunc_demand=trunc_demand.to(i32),
    )

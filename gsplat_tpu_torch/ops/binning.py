"""Static-shape tile binning: (gaussian, tile) pair expansion + sort.

Counterpart of ``gsplat_tpu/ops/binning.py``: ``bin_gaussians``
(``:709-884``) with its rect expansion (``:348-490``), the ellipse
expansion (``_expand_pairs_ellipse``, ``:493-706``), the exact tile cover
counts (``_rect_cover_counts``, ``:127-199``), the pre-sort occlusion cull
(``_occlusion_cull``, ``:202-321``) and the per-tile rank truncation
(``:815-871``). The outputs are bit-identical to the JAX package, dead
blocks and overflow included: ``pair_slot``, ``tile_start``,
``tile_count``, ``block_meta`` (``tile << 2 | dead << 1 | first``),
``num_pairs`` (the true demand, after the cull), ``depth_order``,
``gauss_offsets``, ``num_rows`` (the ellipse's row demand),
``num_pairs_kept`` and ``trunc_demand``. On capacity overflow whole
gaussians are dropped from the back of the depth order.

The JAX package built these outputs around TPU costs (int8 MXU cover
counts, a two-level cumsum, 10-bit packed delta cumsums). The port
computes them directly, in three steps over the ``max_pairs`` pair slots,
all int32: each gaussian's pairs are written at its offsets in depth
order (:func:`emit_pairs`), stably sorted by their tile alone
(:func:`sort_pairs`: within a tile they stay front to back) and scattered
to their block-aligned places (:func:`align_pairs`), which each tile's
run in the sorted list gives (one binary search a tile). On CUDA tensors
the three steps are the kernels of ``csrc/binning.cu``; on CPU tensors
their plain versions (``*_plain``), which the kernels equal bit for bit.
The truncation's demand comes from exact cover counts: a four-corner
integer scatter-add and two cumulative sums (integer adds are exact in
any order). Every shape stays static (the capacities ``cfg.max_pairs``,
``cfg.row_capacity`` and ``cfg.trunc_padded_pairs``), so a frame needs
no host sync.

``cull_mode="ellipse"`` expands each gaussian's tile rows first and then,
per row, the tiles of the exact x-interval of its alpha-cutoff ellipse
(:func:`_expand_ellipse`), then sorts and aligns its pairs as the rect
mode does. Its interval ends are floors of float32
expressions, written in the JAX package's order of operations so that
every integer output equals JAX's. It keeps two JAX behaviours that
``ROADMAP.md`` lists as known faults: the pair and truncation demands are
counted over the rows that fit ``row_capacity`` and the pairs that fit
``max_pairs``, and the occlusion cull does not apply.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..config import RenderConfig
from ..utils.profiling import span
from .projection import ProjectedGaussians
from .raster_cuda import pack_block_meta

_PACK_MASK = (1 << 10) - 1  # JAX packs tile columns into 10 bits


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
    if cfg.cull_mode not in ("rect", "ellipse"):
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


def _footprints(proj: ProjectedGaussians):
    """The depth order and each gaussian's tile rectangle in that order:
    (order [N] int32, tile_min [N, 2], n_u, n_v, counts [N], int64)."""
    order = depth_order(proj.depth, proj.valid)
    order_l = order.to(torch.int64)
    tile_min = proj.tile_min[order_l].to(torch.int64)
    tile_max = proj.tile_max[order_l].to(torch.int64)
    n_u = torch.clamp(tile_max[:, 0] - tile_min[:, 0] + 1, min=0)
    n_v = torch.clamp(tile_max[:, 1] - tile_min[:, 1] + 1, min=0)
    return order, tile_min, n_u, n_v, n_u * n_v


def _capacity_drop(counts, cfg: RenderConfig):
    """The capacity drop: (total demand, offsets [N+1] after the drop),
    int64. Overflow drops WHOLE gaussians from the back of the depth
    order."""
    full_cum = torch.cumsum(counts, 0)
    total = full_cum[-1]  # true demand (reported; may exceed cap)
    counts = torch.where(full_cum <= cfg.max_pairs, counts, 0)
    offsets = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
    return total, offsets


def emit_pairs_plain(offsets, tile_min, n_u, cfg: RenderConfig):
    """Every depth slot's pairs at its offsets, tile rows then columns:
    (tile_id, slot) ``[max_pairs]`` int32, the sentinel tile ``num_tiles``
    (slot N) past the kept demand ``offsets[N]``. Inputs as
    :func:`emit_pairs`'; the owner of pair p is found by a binary search
    over the offsets."""
    n = offsets.shape[0] - 1
    p = torch.arange(cfg.max_pairs, dtype=torch.int64, device=offsets.device)
    slot = torch.searchsorted(offsets, p, right=True) - 1  # n past the end
    pair_ok = slot < n
    s = torch.clamp(slot, max=n - 1)
    local = p - offsets[s]
    nu = torch.clamp(n_u[s], min=1)
    tx = tile_min[s, 0] + local % nu
    ty = tile_min[s, 1] + local // nu
    tile_id = torch.where(pair_ok, ty * cfg.tiles_x + tx, cfg.num_tiles)
    return tile_id.to(torch.int32), slot.to(torch.int32)


def emit_pairs(offsets, tile_min, n_u, cfg: RenderConfig):
    """The rect expansion: (tile_id, slot) ``[max_pairs]`` int32 from the
    post-drop ``offsets`` [N+1] and the depth-ordered ``tile_min`` [N, 2]
    and ``n_u`` [N] (int64, contiguous). CPU tensors take
    :func:`emit_pairs_plain`; CUDA tensors launch ``binning_emit``
    (``csrc/binning.cu``), counted in ``emit_pairs.launches``, or raise."""
    if offsets.device.type == "cpu":
        return emit_pairs_plain(offsets, tile_min, n_u, cfg)
    n = offsets.shape[0] - 1
    _check_args(offsets=(offsets, (n + 1,), torch.int64),
                tile_min=(tile_min, (n, 2), torch.int64),
                n_u=(n_u, (n,), torch.int64))
    _check_index(cfg.max_pairs, n, cfg.num_tiles)
    dev = offsets.device
    tile_id = torch.empty(cfg.max_pairs, dtype=torch.int32, device=dev)
    slot = torch.empty(cfg.max_pairs, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = _library().binning_emit(
            offsets.data_ptr(), n, tile_min.data_ptr(), n_u.data_ptr(),
            cfg.max_pairs, cfg.tiles_x, cfg.num_tiles, tile_id.data_ptr(),
            slot.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"binning_emit launch failed: CUDA error {err}")
    emit_pairs.launches += 1
    return tile_id, slot


emit_pairs.launches = 0  # binning_emit launches


def _ellipse_table(proj: ProjectedGaussians, order, cfg: RenderConfig):
    """The 10 per-gaussian cull terms in depth order ([N, 10] f32; JAX
    ``:556-596``): uv, b, 1/a, P1 = a*k2, det, the peak dy* of the
    interval's upper end, and the AABB's tile x-range and first tile row.
    ``k2 = min(chi2_clip, 2 ln(op / alpha_cutoff))`` is the compositor's
    own zero set, widened by ``(1 + 1e-5)`` and ``1e-6`` so that the
    algebraic boundary stays conservative against the kernel's directly
    evaluated q. One rounding per JAX operation, in JAX's order."""
    o = order.to(torch.int64)
    valid = proj.valid[o]
    uv, conic, opac = proj.uv[o], proj.conic[o], proj.opacity[o]
    tile_min, tile_max = proj.tile_min[o], proj.tile_max[o]
    a = torch.where(valid, conic[:, 0], 1.0)
    b = torch.where(valid, conic[:, 1], 0.0)
    c = torch.where(valid, conic[:, 2], 1.0)
    k2 = torch.clamp(
        2.0 * torch.log(torch.clamp(opac, min=1e-12) / cfg.alpha_cutoff),
        max=cfg.chi2_clip)
    k2 = torch.where(valid, torch.clamp(k2, min=0.0), 1.0) * (1.0 + 1e-5) \
        + 1e-6
    det = torch.clamp(a * c - b * b, min=1e-12)
    return torch.stack([
        torch.where(valid, uv[:, 0], 0.0),
        torch.where(valid, uv[:, 1], 0.0),
        b,
        1.0 / a,
        a * k2,  # P1: discriminant D(dy) = P1 - det dy^2
        det,
        -b * torch.sqrt(k2 / (c * det)),  # dy* peak of xhi
        tile_min[:, 0].to(torch.float32),  # AABB clip (image bounds)
        tile_max[:, 0].to(torch.float32),
        tile_min[:, 1].to(torch.float32),  # first tile row
    ], dim=-1)


def _row_intervals(tv, ty, row_ok, cfg: RenderConfig):
    """Closed-form tile x-interval of each (gaussian, tile row) (JAX
    ``:604-631``): (txlo, rlen, ty), int64, ``rlen`` 0 and ``ty`` 0 on an
    empty or masked row. For the pixel-centre band ``dy in [dyl, dyh]``
    the reachable x-extent's upper end peaks at ``clip(dy*, dyl, dyh)``
    and its lower end at ``clip(-dy*, dyl, dyh)``; a 0.25 px guard
    absorbs float32 rounding."""
    T = cfg.tile
    tyl = ty % cfg.view_tile_rows if cfg.view_tile_rows else ty
    dyl = tyl.to(torch.float32) * T - tv[:, 1]  # band of pixel-centre dys
    dyh = dyl + (T - 1)

    def clip(x, lo, hi):  # jnp.clip: min(max(x, lo), hi)
        return torch.minimum(torch.maximum(x, lo), hi)

    dy0 = clip(torch.zeros_like(dyl), dyl, dyh)
    nonempty = tv[:, 4] - tv[:, 5] * dy0 * dy0 >= 0.0  # D at the best dy
    dyc_h = clip(tv[:, 6], dyl, dyh)
    dyc_l = clip(-tv[:, 6], dyl, dyh)
    rt_h = torch.sqrt(torch.clamp(tv[:, 4] - tv[:, 5] * dyc_h * dyc_h,
                                  min=0.0))
    rt_l = torch.sqrt(torch.clamp(tv[:, 4] - tv[:, 5] * dyc_l * dyc_l,
                                  min=0.0))
    xhi = tv[:, 0] + (-tv[:, 2] * dyc_h + rt_h) * tv[:, 3] + 0.25
    xlo = tv[:, 0] + (-tv[:, 2] * dyc_l - rt_l) * tv[:, 3] - 0.25
    rmask = row_ok & nonempty  # NaN-safe: NaN >= 0 is False
    xhi = torch.where(rmask, xhi, 0.0)
    xlo = torch.where(rmask, xlo, 0.0)
    # Clamped to +-2^30 before the integer cast (JAX's conversion
    # saturates): any end that far out leaves the row empty either way.
    big = float(2**30)
    txlo = torch.clamp(torch.maximum(torch.where(rmask, tv[:, 7], 0.0),
                                     torch.floor(xlo / T)), -big, big)
    txhi = torch.clamp(torch.minimum(torch.where(rmask, tv[:, 8], -1.0),
                                     torch.floor(xhi / T)), -big, big)
    txlo, txhi = txlo.to(torch.int64), txhi.to(torch.int64)
    ty = torch.where(rmask, ty, 0)
    rlen = torch.where(rmask, torch.clamp(txhi - txlo + 1, min=0), 0)
    return txlo, rlen, ty


def _expand_ellipse(proj: ProjectedGaussians, cfg: RenderConfig):
    """Two-level (tile rows -> pairs) expansion with the exact per-row
    ellipse x-intervals (JAX ``_expand_pairs_ellipse``). Same contract as
    the rect branch, with fewer pairs: (order, total pair demand, offsets
    [N+1] int64, tile_id and slot [max_pairs] int32 as
    :func:`emit_pairs` gives them, row demand).

    Rows stage: each gaussian's AABB tile rows, whole gaussians dropped
    from the back of the depth order at ``row_capacity``; each row finds
    its gaussian by a binary search over the row offsets and its interval
    in closed form. Pairs stage: the per-gaussian pair totals, whole
    gaussians dropped at ``max_pairs``; each pair finds its row by a
    binary search over the row pair-offsets. The row demand is the true
    one, past the capacity too; the pair demand counts the rows that fit
    (JAX's)."""
    dev = proj.depth.device
    i64 = torch.int64
    n = proj.depth.shape[0]
    cap, cap_r = cfg.max_pairs, cfg.row_capacity
    zero1 = torch.zeros(1, dtype=i64, device=dev)

    order = depth_order(proj.depth, proj.valid)
    o = order.to(i64)
    tile_min = proj.tile_min[o].to(i64)
    tile_max = proj.tile_max[o].to(i64)
    n_v = torch.clamp(tile_max[:, 1] - tile_min[:, 1] + 1, min=0)
    table = _ellipse_table(proj, order, cfg)

    # --- rows stage ---
    rows_cum = torch.cumsum(n_v, 0)
    rows_total = rows_cum[-1]
    nrows = torch.where(rows_cum <= cap_r, n_v, 0)
    row_off = torch.cat([zero1, torch.cumsum(nrows, 0)])  # [N+1]
    r = torch.arange(cap_r, dtype=i64, device=dev)
    gslot = torch.searchsorted(row_off, r, right=True) - 1  # n past the end
    row_ok = gslot < n
    gs = torch.clamp(gslot, 0, n - 1)
    tv = table[gs]  # [cap_r, 10]
    ty = tile_min[gs, 1] + (r - row_off[gs])  # global tile row
    txlo, rlen, ty = _row_intervals(tv, ty, row_ok, cfg)
    txlo = torch.clamp(txlo, 0, _PACK_MASK)  # JAX's packing-safe clamp

    # --- per-gaussian pair totals; whole-gaussian drop at max_pairs ---
    S = torch.cat([zero1, torch.cumsum(rlen, 0)])
    g_pairs = S[row_off[1:]] - S[row_off[:-1]]  # [N]
    full_cum = torch.cumsum(g_pairs, 0)
    total = full_cum[-1]
    cut = torch.sum(full_cum <= cap)
    rlen = torch.where(gslot < cut, rlen, 0)
    S2 = torch.cat([zero1, torch.cumsum(rlen, 0)])  # [cap_r + 1]
    offsets = S2[row_off]  # [N+1] presort pair boundaries per gaussian

    # --- pairs stage: each pair's row, then its tile and depth slot ---
    p = torch.arange(cap, dtype=i64, device=dev)
    pair_ok = p < S2[-1]
    row = torch.clamp(torch.searchsorted(S2, p, right=True) - 1, 0,
                      cap_r - 1)
    tx = txlo[row] + (p - S2[row])
    tile_id = torch.where(pair_ok, ty[row] * cfg.tiles_x + tx, cfg.num_tiles)
    slot = torch.where(pair_ok, gslot[row], n)
    return order, total, offsets, tile_id.to(torch.int32), \
        slot.to(torch.int32), rows_total


def _end_bit(num_tiles: int) -> int:
    """Key bits the tile sort reads: enough for the sentinel ``num_tiles``."""
    return int(num_tiles).bit_length()


def sort_pairs_plain(tile_id, slot, num_tiles: int):
    """The pairs stably sorted by tile: (tile, slot), int32. Pairs are in
    depth-slot order and a gaussian has at most one pair per tile, so this
    is the order of the unique key ``tile * (N + 1) + slot``: tile-major,
    front to back within a tile; sentinel slots last."""
    sorted_tile, perm = torch.sort(tile_id, stable=True)
    return sorted_tile, slot[perm]


def sort_pairs(tile_id, slot, num_tiles: int):
    """:func:`sort_pairs_plain`'s result. CPU tensors take it; CUDA tensors
    launch ``binning_sort`` (CUB's stable radix sort over the key's low
    ``bit_length(num_tiles)`` bits, ``csrc/binning.cu``), counted in
    ``sort_pairs.launches``, or raise. The returned tensors may be the
    inputs' storage (the sort ping-pongs between them and two others)."""
    if tile_id.device.type == "cpu":
        return sort_pairs_plain(tile_id, slot, num_tiles)
    m = tile_id.shape[0]
    _check_args(tile_id=(tile_id, (m,), torch.int32),
                slot=(slot, (m,), torch.int32))
    _check_index(m, 0, num_tiles)
    lib = _library()
    end_bit = _end_bit(num_tiles)
    keys_alt, vals_alt = torch.empty_like(tile_id), torch.empty_like(slot)
    dev = tile_id.device
    with torch.cuda.device(dev):
        size = ctypes.c_size_t(0)
        err = lib.binning_sort(None, ctypes.byref(size), None, None, None,
                               None, m, end_bit, None, None)
        if err != 0:
            raise RuntimeError(
                f"binning_sort size query failed: CUDA error {err}")
        temp = torch.empty(max(size.value, 1), dtype=torch.uint8, device=dev)
        selector = ctypes.c_int(0)
        err = lib.binning_sort(
            temp.data_ptr(), ctypes.byref(size), tile_id.data_ptr(),
            keys_alt.data_ptr(), slot.data_ptr(), vals_alt.data_ptr(), m,
            end_bit, ctypes.byref(selector),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"binning_sort launch failed: CUDA error {err}")
    sort_pairs.launches += 1
    return (keys_alt, vals_alt) if selector.value else (tile_id, slot)


sort_pairs.launches = 0  # binning_sort calls (CUB's passes in each)


def _tile_runs(sorted_tile, cfg: RenderConfig):
    """Each tile's run in the sorted pairs and in the aligned list:
    (tile_count [T], padded_count [T], real_start [T+1], padded_start
    [T+1]), int64. ``real_start[t]`` is the number of sorted pairs of
    tiles below t, one binary search a tile over the sorted tiles (exact:
    ``real_start[T]`` is the kept demand); runs are padded to a multiple
    of ``pair_block``."""
    T = cfg.num_tiles
    real_start = torch.searchsorted(sorted_tile, torch.arange(
        T + 1, dtype=sorted_tile.dtype, device=sorted_tile.device))
    tile_count = real_start[1:] - real_start[:-1]
    padded_count = tile_count + (-tile_count) % cfg.pair_block
    padded_start = torch.cat([padded_count.new_zeros(1),
                              torch.cumsum(padded_count, 0)])
    return tile_count, padded_count, real_start, padded_start


def align_pairs_plain(sorted_tile, sorted_slot, padded_start, real_start,
                      cfg: RenderConfig):
    """The block-aligned ``pair_slot`` [padded_pairs] int32 (-1 padding):
    sorted pair p of tile t at ``padded_start[t] + p - real_start[t]``."""
    T, cap_pad = cfg.num_tiles, cfg.padded_pairs
    st = sorted_tile.to(torch.int64)
    ok = st < T
    stc = torch.clamp(st, max=T - 1)
    p = torch.arange(st.shape[0], dtype=torch.int64, device=st.device)
    dest = padded_start[stc] + (p - real_start[stc])
    # Unused slots scatter to one extra trailing element, cut off below.
    pair_slot = torch.full((cap_pad + 1,), -1, dtype=torch.int32,
                           device=st.device)
    pair_slot.scatter_(0, torch.where(ok, dest, cap_pad),
                       torch.where(ok, sorted_slot, -1))
    return pair_slot[:cap_pad]


def align_pairs(sorted_tile, sorted_slot, padded_start, real_start,
                cfg: RenderConfig):
    """:func:`align_pairs_plain`'s ``pair_slot``. CPU tensors take it; CUDA
    tensors fill -1 and launch ``binning_align`` (``csrc/binning.cu``),
    counted in ``align_pairs.launches``, or raise."""
    if sorted_tile.device.type == "cpu":
        return align_pairs_plain(sorted_tile, sorted_slot, padded_start,
                                 real_start, cfg)
    m, T = sorted_tile.shape[0], cfg.num_tiles
    _check_args(sorted_tile=(sorted_tile, (m,), torch.int32),
                sorted_slot=(sorted_slot, (m,), torch.int32),
                padded_start=(padded_start, (T + 1,), torch.int64),
                real_start=(real_start, (T + 1,), torch.int64))
    _check_index(m, 0, T)
    dev = sorted_tile.device
    pair_slot = torch.full((cfg.padded_pairs,), -1, dtype=torch.int32,
                           device=dev)
    with torch.cuda.device(dev):
        err = _library().binning_align(
            sorted_tile.data_ptr(), sorted_slot.data_ptr(), m,
            padded_start.data_ptr(), real_start.data_ptr(), T,
            cfg.padded_pairs, pair_slot.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"binning_align launch failed: CUDA error {err}")
    align_pairs.launches += 1
    return pair_slot


align_pairs.launches = 0  # binning_align launches


def _library():
    from ._build import load_library

    return load_library("binning")


def _check_args(**tensors):
    """Raise unless each (tensor, shape, dtype) is contiguous, of that
    shape and dtype, and on the first one's CUDA device."""
    dev = next(iter(tensors.values()))[0].device
    for name, (a, shape, dtype) in tensors.items():
        if a.dtype != dtype or tuple(a.shape) != shape \
                or not a.is_contiguous():
            raise ValueError(
                f"{name} must be contiguous {list(shape)} {dtype}, got "
                f"{tuple(a.shape)} {a.dtype}")
        if a.device != dev or dev.type != "cuda":
            raise ValueError(f"{name} is on {a.device}; the binning kernels "
                             f"take CUDA tensors on one device")


def _check_index(pairs: int, n: int, num_tiles: int):
    if max(pairs, n, num_tiles) >= 2**31 - 1:
        raise ValueError(
            f"{pairs} pairs, {n} gaussians or {num_tiles} tiles exceed the "
            f"binning kernels' int32 index")


def _block_meta(padded_start, cfg: RenderConfig):
    """Per-block metadata: owning tile, first / continuation / dead."""
    G, T = cfg.pair_block, cfg.num_tiles
    num_blocks = cfg.num_pair_blocks
    b0 = torch.arange(num_blocks, dtype=torch.int64,
                      device=padded_start.device) * G
    block_tile = torch.searchsorted(padded_start, b0, right=True) - 1
    block_tile = torch.clamp(block_tile, 0, T - 1)
    block_used = b0 < padded_start[T]
    block_first = torch.where(
        block_used, (b0 == padded_start[block_tile]).to(torch.int64), -1
    )
    return pack_block_meta(block_tile, block_first)


def _compact_blocks(pair_slot, padded_count, padded_start,
                    cfg: RenderConfig):
    """Per-tile rank truncation: keep each tile's first ``rank_cap_blocks``
    blocks, compacted block by block into the ``trunc_padded_pairs`` list.
    Returns (pair_slot, block_meta, new_start_b [num_tiles + 1]: each
    tile's first block in the compacted list)."""
    dev = pair_slot.device
    i64 = torch.int64
    G, T = cfg.pair_block, cfg.num_tiles
    num_blocks = cfg.num_pair_blocks
    Kb = cfg.rank_cap_blocks
    keepb = torch.clamp(padded_count // G, max=Kb)  # [T] blocks kept
    new_start_b = torch.cat([torch.zeros(1, dtype=i64, device=dev),
                             torch.cumsum(keepb, 0)])  # [T+1]
    n_new = cfg.num_trunc_blocks
    nb0 = torch.arange(n_new, dtype=i64, device=dev)
    nb_tile = torch.clamp(
        torch.searchsorted(new_start_b, nb0, right=True) - 1, 0, T - 1)
    nb_used = nb0 < new_start_b[T]
    src_block = torch.clamp(
        padded_start[nb_tile] // G + (nb0 - new_start_b[nb_tile]),
        0, num_blocks - 1)
    nb_first = torch.where(
        nb_used, (nb0 == new_start_b[nb_tile]).to(i64), -1)
    pair_slot = torch.where(
        nb_used[:, None], pair_slot.view(num_blocks, G)[src_block], -1
    ).reshape(-1)
    return pair_slot, pack_block_meta(nb_tile, nb_first), new_start_b


def bin_gaussians(proj: ProjectedGaussians, cfg: RenderConfig) -> TileBinning:
    """Build the block-aligned sorted pair list for one view (static shapes).

    The steps are module functions, in order (``profile_binning`` times
    each on a frame's tensors): :func:`_footprints`, the occlusion cull
    (with truncation), :func:`_capacity_drop`, :func:`emit_pairs`,
    :func:`sort_pairs`, the tile runs (:func:`_tile_runs`),
    :func:`align_pairs`, :func:`_block_meta`, and with truncation
    :func:`_compact_blocks` and the exact cover counts. With
    ``cull_mode="ellipse"``, :func:`_expand_ellipse` takes the place of
    the first four. On CUDA tensors the emission, the sort and the
    alignment are the kernels of ``csrc/binning.cu``."""
    with span("gs.bin"):
        _check_supported(cfg)
        dev = proj.depth.device
        num_tiles = cfg.num_tiles

        if cfg.cull_mode == "ellipse":
            order, total, offsets, tile_id, slot, num_rows = \
                _expand_ellipse(proj, cfg)
        else:
            # Footprint counts in DEPTH order, so that capacity overflow drops
            # the farthest gaussians' pairs first.
            order, tile_min, n_u, n_v, counts = _footprints(proj)
            if cfg.tile_rank_cap and cfg.occlusion_cull:
                # Before the capacity drop, so num_pairs is the demand
                # after it.
                counts = _occlusion_cull(tile_min, n_u, n_v, counts, cfg)
            total, offsets = _capacity_drop(counts, cfg)
            tile_id, slot = emit_pairs(offsets, tile_min, n_u, cfg)
            num_rows = torch.zeros((), dtype=torch.int64, device=dev)
        sorted_tile, sorted_slot = sort_pairs(tile_id, slot, num_tiles)
        tile_count, padded_count, real_start, padded_start = _tile_runs(
            sorted_tile, cfg)
        pair_slot = align_pairs(sorted_tile, sorted_slot, padded_start,
                                real_start, cfg)
        block_meta = _block_meta(padded_start, cfg)
        tile_start = padded_start[:num_tiles]
        kept_pairs = total
        trunc_demand = torch.zeros((), dtype=torch.int64, device=dev)

        if cfg.tile_rank_cap:
            G = cfg.pair_block
            Kb = cfg.rank_cap_blocks
            pair_slot, block_meta, new_start_b = _compact_blocks(
                pair_slot, padded_count, padded_start, cfg)
            cap_t = Kb * G
            if cfg.cull_mode == "ellipse":
                # JAX's: the counts of the rows and pairs that fit.
                tile_count_true = tile_count
            else:
                # Reported demand from the tile counts before the capacity
                # drop, so a probe's own max_pairs cannot hide it.
                y0, x0 = tile_min[:, 1], tile_min[:, 0]
                tile_count_true = _cover_counts(
                    y0, y0 + n_v, x0, x0 + n_u, counts > 0, cfg.tiles_y,
                    cfg.tiles_x).reshape(num_tiles)
            kept_pairs = torch.sum(torch.clamp(tile_count_true, max=cap_t))
            trunc_demand = torch.sum(
                torch.clamp((tile_count_true + G - 1) // G, max=Kb)) * G
            tile_start = torch.clamp(new_start_b[:num_tiles] * G,
                                     max=cfg.trunc_padded_pairs - 1)
            # A tile whose first block fell past the capacity is never
            # composited: count 0. Tiles that lost only deeper blocks keep a
            # front-most prefix; the overflow is reported by trunc_demand.
            tile_count = torch.where(
                new_start_b[:num_tiles] < cfg.num_trunc_blocks,
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
            num_rows=num_rows.to(i32),
            num_pairs_kept=kept_pairs.to(i32),
            trunc_demand=trunc_demand.to(i32),
        )

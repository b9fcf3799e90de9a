"""Tile compositing: the Hopper kernels and their plain PyTorch versions.

Counterpart of ``gsplat_tpu/ops/raster_pallas.py``: the forward
``_fwd_kernel`` (``:192-240``, launched by ``_fwd_pallas`` at ``:349-370``)
and its VJP ``_bwd_kernel`` (``:243-346``, launched by ``_bwd_pallas`` at
``:373-405`` from ``_cp_bwd``). Front-to-back alpha compositing of the
tile-major, depth-ordered, block-aligned pair list that ``ops/binning.py``
emits:

* per (pair, pixel): ``q = a du^2 + 2 b du dv + c dv^2``,
  ``g = exp(-q/2)`` where ``q <= chi2_clip`` else 0,
  ``alpha = min(op g, alpha_max)``, zeroed below ``alpha_cutoff``;
* ``w = alpha T_excl`` where ``T_excl > transmittance_min``, with
  ``T_excl`` the product of ``(1 - alpha)`` over the pairs in front.
  ``transmittance_math="cumprod"`` computes it as a sequential product;
  ``"log"`` as the TPU kernel's log form (``raster_pallas.py:161-164``):
  within a block, ``s = log1p(-alpha)`` and its running inclusive sum
  ``S`` from 0, ``T_excl = exp(S - s) * T_in`` and ``T_out = T_in *
  exp(S_total)``, T carried by product from block to block;
* a tile's continuation block is skipped when the largest T over its
  pixels is ``<= transmittance_min`` (block-granular, as on the TPU: T
  keeps multiplying through every pair of a composited block).

Output ``[num_tiles, 8, tile*tile]`` f32: rows 0-2 sum w*rgb, row 3 sum
w*depth, row 4 final T, row 5 the number of blocks composited, rows 6-7
zero. A tile with no pairs gets rgb = depth = 0, T = 1, count 0. A tile
walks ``ceil(tile_count / pair_block)`` blocks from ``tile_start`` and
stops at the end of the pair list: a truncated list whose capacity
overflowed (``ops/binning.py``) keeps only the blocks that fit, as the
TPU kernel walks only the blocks its ``block_meta`` lists.

When autograd records, the forward also returns its block-start state
``[padded_pairs / pair_block, 5, tile*tile]`` f32: for each block it
composites, the four sums (rows 0-3) and T (row 4) at the block's start,
at the block's index in the pair list (blocks it did not composite are
left unwritten by the kernel, zero in the plain version). The backward
runs each composited block on its own from that state (as the TPU kernel
restarts its colour prefix at every block from its carry) and emits
per-pair d(u, v, a, b, c, opacity, r, g, b, depth) ``[10, padded_pairs]``;
blocks the forward skipped, dead blocks and padding get exact zeros. It
reads the cotangent of rows 0-4 only. It needs binning's layout: each
tile's run starts at a multiple of ``pair_block``, and ``tile_start`` is
nondecreasing.

``cfg.view_tile_rows`` > 0 (batched views, ``render.stack_view_projections``:
the views' tile rows stacked, uv view-local) wraps every tile row to
``row % view_tile_rows`` before it becomes a pixel row
(``raster_pallas.py::_pixel_grid``, ``rows_mod``), in exact integers, in
the kernels, their plain versions and the cull's plain test alike.

The backward has a compact mode (``kb`` > 0, ``cfg.bwd_pairs``: the JAX
package's ``_cg_bwd``, ``gsplat_tpu/ops/rasterize.py:331-373``): it writes
the gradient of the i-th composited block, in the order of
:func:`tile_block_offsets` (ascending block index), to columns ``[i*G,
(i+1)*G)`` of a ``[10, kb*G]`` output, for the first ``min(n, kb)`` of the
``n`` composited blocks; the blocks past ``kb`` (trailing tiles') are
dropped and the unused columns are zero.

Feature-major pair features ``[>= 10, padded_pairs]`` f32, rows
0:u 1:v 2:conic_a 3:conic_b 4:conic_c 5:opacity 6:r 7:g 8:b 9:depth
(the JAX layout's rows 10-15 are zero padding that nothing reads).

:func:`composite_pairs` chooses by the tensors' device: CPU tensors take
:func:`composite_pairs_plain` / :func:`composite_pairs_bwd_plain`; CUDA
tensors launch the kernels (``csrc/raster_fwd.cu``, ``csrc/raster_bwd.cu``)
or raise. The forward kernel equals :func:`composite_pairs_plain` bit for
bit; :func:`pair_warp_reach` is the plain version of its per-warp pair
cull. With grad enabled and ``pair_feat`` requiring grad it is a
``torch.autograd.Function`` whose backward is the backward kernel.
"""

from __future__ import annotations

import ctypes

import torch

from ..config import RenderConfig

FEAT_WIDTH = 16  # width of the JAX package's pair-feature layout
FEAT_ROWS = 10  # rows the compositor reads

# Per-block metadata, one int32 per block (raster_pallas.py:51-69):
#     meta = (owning_tile << 2) | (dead << 1) | first
META_SHIFT = 2
META_FIRST = 1
META_DEAD = 2

KERNEL_TILE = 16  # the only tile size the CUDA kernel takes for now
MAX_PAIR_BLOCK = 256
STATE_ROWS = 5  # block-start state: sums r g b depth, then T
KERNEL_WARPS = 8  # K1's warps per tile
WARP_W, WARP_H = 8, 4  # the pixel patch of one K1 warp
# Margins of K1's per-warp pair cull (_reach_threshold), which _launch_fwd
# passes to raster_fwd.cu
CULL_MARGIN_REL = 1e-3
CULL_MARGIN_EPS = 2.0**-17  # 128 units of float32 roundoff, over kappa
CULL_MARGIN_ABS = 1e-3
CULL_KAPPA_MIN = 1e-4


def pack_block_meta(block_tile, block_first):
    """(tile, first/dead) arrays -> packed meta (block_first: 1 first,
    0 continuation, -1 dead; tile must already be clipped in-range)."""
    dead = (block_first < 0).to(block_tile.dtype)
    first = (block_first == 1).to(block_tile.dtype)
    return (block_tile << META_SHIFT) | (dead << 1) | first


def _check_cfg(cfg: RenderConfig):
    if cfg.transmittance_math not in ("cumprod", "log"):
        raise ValueError(
            f"unknown transmittance_math {cfg.transmittance_math!r}")
    if cfg.view_tile_rows < 0:
        raise ValueError(f"view_tile_rows must be >= 0, got "
                         f"{cfg.view_tile_rows}")


def tile_rows(tiles, cfg: RenderConfig):
    """The pixel-grid tile row of each tile in ``tiles``: ``tile //
    tiles_x``, wrapped to ``% view_tile_rows`` for batched views (exact
    integers, as ``raster_pallas.py::_pixel_grid`` wraps them)."""
    ty = tiles // cfg.tiles_x
    return ty % cfg.view_tile_rows if cfg.view_tile_rows else ty


def _block_alpha(f, px, py, cfg: RenderConfig):
    """alpha [m, G, P] for features f [10, m, G] and pixel centres [m, P],
    with the terms the backward reuses: (alpha, du, dv, g, a_raw, a) where
    a = min(a_raw, alpha_max) is alpha before the cutoff.

    Operation order matches the CUDA kernels, which are built with
    -fmad=false so both round identically.
    """
    u = f[0][:, :, None]
    v = f[1][:, :, None]
    ca = f[2][:, :, None]
    cb = f[3][:, :, None]
    cc = f[4][:, :, None]
    op = f[5][:, :, None]
    du = px[:, None, :] - u
    dv = py[:, None, :] - v
    q = ca * du * du + 2.0 * cb * du * dv + cc * dv * dv
    g = torch.where(q <= cfg.chi2_clip, torch.exp(-0.5 * q), 0.0)
    a_raw = op * g
    a = torch.clamp(a_raw, max=cfg.alpha_max)
    return torch.where(a >= cfg.alpha_cutoff, a, 0.0), du, dv, g, a_raw, a


def warp_pixels(cfg: RenderConfig, device=None):
    """[8, 32] int64: the pixel ``p = py*tile + px`` of lane l of warp w in
    K1, whose warp w takes the 8x4 patch at column (w % 2)*8, row
    (w // 2)*4 of its tile, lane l at (l % 8, l // 8) within it. Local to
    the tile, so ``view_tile_rows`` does not enter."""
    w = torch.arange(KERNEL_WARPS, device=device)[:, None]
    lane = torch.arange(32, device=device)[None, :]
    x = (w % 2) * WARP_W + lane % WARP_W
    y = (w // 2) * WARP_H + lane // WARP_W
    return y * cfg.tile + x


def _reach_threshold(f, cfg: RenderConfig):
    """K1's per-pair cull values for features f [>= 10, m, G]: ``(t, m)``,
    each [m, G] f32, in the kernel's order of operations.

    A pair's alpha is non-zero at a pixel only where the pixel's q (as
    rounded) is at most ``min(chi2_clip, 2 ln(opacity / alpha_cutoff))``
    (``op * exp(-q/2)`` must reach the cutoff; ``expf``'s 2 ulp move that by
    about 1e-6). ``t`` widens it by 1e-3 absolute and ``1e-3 + 2^-17 /
    kappa`` relative, ``kappa = det / (a c)``: a rounded q lies within
    ``28 u / kappa`` of the exact quadratic form (u = 2^-24; the three
    terms' magnitudes sum to at most ``4 / kappa`` times q), and the test's
    own roundings add as much again. ``t = -inf`` skips the pair at every
    pixel (opacity <= 0, so ``a_raw <= 0``); ``t = +inf`` never skips it: a
    non-finite value among the 10 rows (then ``0 * x`` need not be 0),
    ``alpha_cutoff <= 0``, or a conic that is not positive definite with
    ``kappa >= 1e-4``. ``m = -b / a`` (0 where not tested) is the slope of
    the line where q is least along x for a given row.
    """
    a, b, c, op = f[2], f[3], f[4], f[5]
    inf = torch.tensor(float("inf"), dtype=f.dtype, device=f.device)
    finite = torch.isfinite(f[:FEAT_ROWS]).all(dim=0)
    ac = a * c
    det = ac - b * b
    kappa = det / ac
    tested = (a > 0.0) & (c > 0.0) & (kappa >= CULL_KAPPA_MIN)
    # Divisions by tensors: PyTorch divides by a Python float as a product
    # with its reciprocal (on CUDA), and a Python float over a tensor as a
    # reciprocal and a product; the kernel divides once.
    t = torch.fmin(2.0 * torch.log(op / torch.full_like(op, cfg.alpha_cutoff)),
                   torch.full_like(op, cfg.chi2_clip))
    t = t + t.abs() * (CULL_MARGIN_REL + torch.full_like(op, CULL_MARGIN_EPS)
                       / kappa) + CULL_MARGIN_ABS
    t = torch.where(tested, t, inf)
    t = torch.where(op <= 0.0, -inf, t)
    finite &= cfg.alpha_cutoff > 0.0
    t = torch.where(finite, t, inf)
    live = finite & (op > 0.0) & tested
    m = torch.where(live, -b / a, 0.0)
    return t, m


def pair_warp_reach(f, tiles, cfg: RenderConfig):
    """K1's per-warp pair cull as plain PyTorch: [m, G, 8] bool, False
    where the kernel's warp w skips pair j of block i (features f
    [>= 10, m, G] of blocks in tiles ``tiles`` [m]).

    For each of the patch's 4 pixel rows (dv = row - v), q is least along
    the row at du = m dv, clamped to the patch's columns; the warp skips the
    pair when that q exceeds ``t`` (:func:`_reach_threshold`) on every row.
    Conservative: a skipped pair has alpha == 0 at all 32 pixels of the
    warp, so skipping it changes no bit of K1's output. Serving and
    training never call this; the tests, ``chip_smoke.py`` and the
    profiler's bounds do (through :func:`cull_audit`).
    """
    t, m = _reach_threshold(f, cfg)
    t, m = t[..., None], m[..., None]
    u, v, a, b, c = (f[r][..., None] for r in range(5))
    w = torch.arange(KERNEL_WARPS, device=f.device)
    tx = ((tiles % cfg.tiles_x) * cfg.tile)[:, None]
    ty = (tile_rows(tiles, cfg) * cfg.tile)[:, None]
    x0 = (tx + (w % 2) * WARP_W).to(f.dtype)[:, None, :]  # [m, 1, 8]
    x1 = (tx + (w % 2) * WARP_W + WARP_W - 1).to(f.dtype)[:, None, :]
    y0 = (ty + (w // 2) * WARP_H).to(f.dtype)[:, None, :]
    lo = x0 - u
    hi = x1 - u
    reach = torch.zeros(lo.shape, dtype=torch.bool, device=f.device)
    for r in range(WARP_H):
        dv = (y0 + float(r)) - v
        du = torch.fmin(torch.fmax(m * dv, lo), hi)
        q = a * du * du + 2.0 * b * du * dv + c * dv * dv
        reach |= ~(q > t)
    return reach


def cull_audit(pair_feat, blocks, tiles, cfg: RenderConfig, chunk: int = 256):
    """K1's cull over the listed blocks (``blocks``, ``tiles`` [m] int64:
    the pair list's block and its tile), ``chunk`` blocks at a time: a dict
    of (pair, warp) counts, ``total``, ``skipped`` (dropped by
    :func:`pair_warp_reach`), ``zero`` (alpha == 0 at all 32 of the warp's
    pixels) and ``unsafe`` (dropped with a non-zero alpha somewhere: 0 if
    the cull is conservative)."""
    G = cfg.pair_block
    dev = pair_feat.device
    cols = torch.arange(G, device=dev)
    wpix = warp_pixels(cfg, dev)
    n = {"total": 0, "skipped": 0, "zero": 0, "unsafe": 0}
    for c0 in range(0, blocks.shape[0], chunk):
        blk, tile = blocks[c0:c0 + chunk], tiles[c0:c0 + chunk]
        f = pair_feat[:FEAT_ROWS, blk[:, None] * G + cols]
        reach = pair_warp_reach(f, tile, cfg)  # [m, G, 8]
        px, py = _tile_pixels(tile, cfg)
        alpha = _block_alpha(f, px, py, cfg)[0][:, :, wpix]  # [m, G, 8, 32]
        nonzero = (alpha != 0).any(dim=3)
        n["total"] += reach.numel()
        n["skipped"] += int((~reach).sum())
        n["zero"] += int((~nonzero).sum())
        n["unsafe"] += int((nonzero & ~reach).sum())
    return n


def _tile_pixels(tiles, cfg: RenderConfig):
    """Pixel centres (px, py), each [len(tiles), tile*tile] f32."""
    t = cfg.tile
    lane = torch.arange(t * t, device=tiles.device)
    px = ((tiles % cfg.tiles_x) * t)[:, None] + lane % t
    py = (tile_rows(tiles, cfg) * t)[:, None] + lane // t
    return px.to(torch.float32), py.to(torch.float32)


def _running_sum(start, terms):
    """start [m, P] + terms[:, 0] + terms[:, 1] + ... in order, for terms
    [m, G, P]: every prefix, [m, G, P] (a cumulative sum along a
    non-innermost dimension, which PyTorch takes in order)."""
    return torch.cumsum(torch.cat([start[:, None, :], terms], dim=1),
                        dim=1)[:, 1:]


def _block_transmittance(alpha, T_in, cfg: RenderConfig):
    """``(T_excl [m, G, P], T_out [m, P])`` of one block of each of m tiles
    for alpha [m, G, P] and the block-start T_in [m, P], in the kernels'
    order of operations: "cumprod" is the sequential product ``T_in * (1 -
    a_0) * (1 - a_1) ...``; "log" takes ``s = log1p(-alpha)``, its
    sequential running sum S from 0, ``T_excl = exp(S - s) * T_in`` and
    ``T_out = T_in * exp(S_total)``. Cumulative ops along a non-innermost
    dimension, which PyTorch evaluates in order on CPU and CUDA."""
    if cfg.transmittance_math == "log":
        s = torch.log1p(-alpha)
        S = _running_sum(torch.zeros_like(T_in), s)
        return torch.exp(S - s) * T_in[:, None, :], T_in * torch.exp(S[:, -1])
    prod = torch.cumprod(torch.cat([T_in[:, None, :], 1.0 - alpha], dim=1),
                         dim=1)
    return prod[:, :-1], prod[:, -1]


def composite_pairs_plain(pair_feat, tile_start, tile_count, cfg: RenderConfig,
                          tile_chunk: int = 0, with_state: bool = False):
    """Plain PyTorch compositor with the kernel's semantics (any device).

    Walks every tile's blocks in order, all tiles of a chunk at once:
    step k composites the k-th block of each tile that still has one, is
    not saturated and lies inside the pair list. Within a block T is
    :func:`_block_transmittance` and each sum the sequential ``acc + w_0
    c_0 + w_1 c_1 ...``: cumulative ops along a non-innermost dimension,
    which PyTorch evaluates in order on CPU and CUDA. So every rounding,
    and every ``T > transmittance_min`` decision, is the kernel's.
    ``tile_chunk`` > 0 bounds memory to that many tiles at a time.
    ``with_state`` also returns the block-start state (module docstring;
    zero at blocks not composited): ``(out, state)``.
    """
    _check_cfg(cfg)
    dev = pair_feat.device
    n_pairs = pair_feat.shape[1]
    G = cfg.pair_block
    P = cfg.tile * cfg.tile
    num_tiles = tile_start.shape[0]
    f32 = torch.float32
    out = torch.zeros(num_tiles, 8, P, dtype=f32, device=dev)
    out[:, 4] = 1.0
    nblk = (tile_count.to(torch.int64) + G - 1) // G
    cols = torch.arange(G, device=dev)
    if with_state:
        state = torch.zeros(pair_feat.shape[1] // G, STATE_ROWS, P,
                            dtype=f32, device=dev)
    chunk = tile_chunk if tile_chunk > 0 else max(num_tiles, 1)
    for c0 in range(0, num_tiles, chunk):
        tiles = torch.arange(c0, min(c0 + chunk, num_tiles), device=dev)
        px, py = _tile_pixels(tiles, cfg)
        T = torch.ones(tiles.shape[0], P, dtype=f32, device=dev)
        acc = torch.zeros(tiles.shape[0], 4, P, dtype=f32, device=dev)
        cnt = torch.zeros(tiles.shape[0], dtype=f32, device=dev)
        nb = nblk[tiles]
        start = tile_start[tiles].to(torch.int64)
        k = 0
        while True:
            go = (k < nb) & (start + (k + 1) * G <= n_pairs)
            if k > 0:
                go &= T.amax(dim=1) > cfg.transmittance_min
            idx = torch.nonzero(go).squeeze(1)
            if idx.numel() == 0:
                break
            pcol = start[idx, None] + k * G + cols  # [m, G]
            if with_state:
                blk = pcol[:, 0] // G
                state[blk, 0:4] = acc[idx]
                state[blk, 4] = T[idx]
            f = pair_feat[:FEAT_ROWS, pcol]  # [10, m, G]
            alpha = _block_alpha(f, px[idx], py[idx], cfg)[0]  # [m, G, P]
            T_excl, T_out = _block_transmittance(alpha, T[idx], cfg)
            w = torch.where(T_excl > cfg.transmittance_min,
                            alpha * T_excl, 0.0)
            for ch in range(4):
                # Sequential running sum acc + w_0 c_0 + w_1 c_1 + ..., in
                # the kernel's order (same cumulative-op argument as T).
                acc[idx, ch] = _running_sum(
                    acc[idx, ch], w * f[6 + ch][:, :, None])[:, G - 1]
            T[idx] = T_out
            cnt[idx] += 1.0
            k += 1
        out[tiles, 0:4] = acc
        out[tiles, 4] = T
        out[tiles, 5] = cnt[:, None]
    return (out, state) if with_state else out


def tile_block_offsets(fwd_out):
    """[num_tiles + 1] int32: the exclusive prefix over tiles of the blocks
    the forward composited (its row 5), on the tensor's device with no host
    sync. The backward's work list: composited block i belongs to the tile
    t with ``off[t] <= i < off[t + 1]``; ``off[-1]`` is their number."""
    off = torch.zeros(fwd_out.shape[0] + 1, dtype=torch.int32,
                      device=fwd_out.device)
    torch.cumsum(fwd_out[:, 5, 0].to(torch.int32), 0, dtype=torch.int32,
                 out=off[1:])
    return off


def composited_blocks(tile_start, tile_off, n: int, cfg: RenderConfig):
    """The first ``n`` entries of the composited-block list of
    :func:`tile_block_offsets`, in list order (ascending block index), on
    the device with no host sync: ``(block, tile, rank, valid)``, each
    ``[n]``, where ``block`` indexes the pair list's blocks (0 where not
    ``valid``), ``rank`` is the block's place in its tile and ``valid`` is
    True for the entries that exist (``i < off[-1]``). Entry i is the block
    the backward kernel's item i runs (the kernel finds its tile by a
    binary search in ``tile_off``)."""
    item = torch.arange(n, device=tile_off.device)
    off = tile_off.long()
    valid = item < off[-1]
    tile = torch.clamp(torch.searchsorted(off, item, right=True) - 1, 0,
                       tile_start.shape[0] - 1)
    rank = item - off[tile]
    block = tile_start.long()[tile] // cfg.pair_block + rank
    return torch.where(valid, block, 0), tile, rank, valid


def active_blocks(tile_start, tile_off, cfg: RenderConfig):
    """Every composited block (:func:`composited_blocks`): ``(block, tile,
    rank)``, each ``[off[-1]]`` int64. Reads the list's length on the
    host."""
    return composited_blocks(tile_start, tile_off, int(tile_off[-1]),
                             cfg)[:3]


def composite_pairs_bwd_plain(pair_feat, tile_start, tile_count, fwd_out,
                              state, gout, cfg: RenderConfig,
                              block_chunk: int = 0, kb: int = 0):
    """Plain PyTorch backward with the kernel's semantics (any device).

    The VJP of :func:`composite_pairs_plain` as ``_bwd_kernel`` computes it
    (``raster_pallas.py:243-346``). Every block the forward composited (the
    list of :func:`active_blocks`) is run at once, from the forward's
    block-start ``state`` (T_in and the four prefix sums), and per (pair,
    pixel):

    * T and ``w`` as the forward builds them from T_in, in either
      ``transmittance_math`` (:func:`_block_transmittance`);
    * ``gP`` = sum_c gC_c * prefix_c including this pair, a running sum
      that starts each block at ``gC . prefix`` and adds ``gdotc * w``;
    * the suffix ``gS = sum_c gC_c * C_final_c - gP``, with ``C_final`` the
      RAW forward rows 0-3 (not the clamped image);
    * ``dalpha = [alive] gdotc T_excl - (gS + gT T_final) /
      max(1 - alpha, 1 - alpha_max)``, passed to ``a_raw`` only where
      ``a_raw < alpha_max`` (strict) and ``min(a_raw, alpha_max) >=
      alpha_cutoff``;
    * the per-pair rows are sums over the tile's pixels.

    Every per-(pair, pixel) term is evaluated in the CUDA kernel's order;
    the kernel differs by the order of the pixel sums (each thread's
    pixels, then across the warp by shuffles, then over warps), by fused
    multiply-adds in the ten partials and by the division's fast path.
    Returns ``[10, padded_pairs]`` f32, exact zeros outside the composited
    blocks; with ``kb`` > 0 the compact layout (module docstring), ``[10,
    kb*G]``. Reads rows 0-4 of ``gout``; ``tile_count`` is not read (the
    forward's row 5 names the blocks). ``block_chunk`` > 0 bounds memory
    to that many blocks at a time.
    """
    _check_cfg(cfg)
    dev = pair_feat.device
    G = cfg.pair_block
    f32 = torch.float32
    blocks, tile, _ = active_blocks(tile_start, tile_block_offsets(fwd_out),
                                    cfg)
    if kb > 0:  # item i at columns i*G: the first kb composited blocks
        blocks, tile = blocks[:kb], tile[:kb]
        dest = torch.arange(blocks.shape[0], device=dev)
    else:
        dest = blocks
    dfeat = torch.zeros(FEAT_ROWS, kb * G if kb > 0 else pair_feat.shape[1],
                        dtype=f32, device=dev)
    cols = torch.arange(G, device=dev)
    one_minus_max = 1.0 - cfg.alpha_max  # the kernel gets this same float
    chunk = block_chunk if block_chunk > 0 else max(blocks.shape[0], 1)
    for c0 in range(0, blocks.shape[0], chunk):
        blk = blocks[c0:c0 + chunk]
        tiles = tile[c0:c0 + chunk]
        px, py = _tile_pixels(tiles, cfg)
        gC = gout[tiles, 0:4]  # [m, 4, P]
        fo = fwd_out[tiles]
        gS_full = (gC[:, 0] * fo[:, 0] + gC[:, 1] * fo[:, 1]
                   + gC[:, 2] * fo[:, 2] + gC[:, 3] * fo[:, 3])  # [m, P]
        gTT = gout[tiles, 4] * fo[:, 4]
        st = state[blk]  # [m, 5, P]
        pcol = blk[:, None] * G + cols  # [m, G]
        dcol = dest[c0:c0 + chunk, None] * G + cols
        f = pair_feat[:FEAT_ROWS, pcol]  # [10, m, G]
        alpha, du, dv, g, a_raw, a = _block_alpha(f, px, py, cfg)
        T_excl = _block_transmittance(alpha, st[:, 4], cfg)[0]
        alive = T_excl > cfg.transmittance_min
        w = torch.where(alive, alpha * T_excl, 0.0)
        gc = [gC[:, ch][:, None, :] for ch in range(4)]  # [m, 1, P]
        rgb = [f[6 + ch][:, :, None] for ch in range(4)]  # [m, G, 1]
        gdotc = gc[0] * rgb[0] + gc[1] * rgb[1] + gc[2] * rgb[2] \
            + gc[3] * rgb[3]
        gP_in = (gC[:, 0] * st[:, 0] + gC[:, 1] * st[:, 1]
                 + gC[:, 2] * st[:, 2] + gC[:, 3] * st[:, 3])
        gS = gS_full[:, None, :] - _running_sum(gP_in, gdotc * w)
        one_minus = torch.clamp(1.0 - alpha, min=one_minus_max)
        dalpha = torch.where(alive, gdotc * T_excl, 0.0) \
            - (gS + gTT[:, None, :]) / one_minus
        gate = (a_raw < cfg.alpha_max) & (a >= cfg.alpha_cutoff)
        ga = torch.where(gate, dalpha, 0.0)
        ca, cb, cc, op = (f[r][:, :, None] for r in (2, 3, 4, 5))
        dq = ga * op * (-0.5) * g
        rows = [
            -torch.sum(dq * (2.0 * ca * du + 2.0 * cb * dv), dim=2),
            -torch.sum(dq * (2.0 * cc * dv + 2.0 * cb * du), dim=2),
            torch.sum(dq * du * du, dim=2),
            torch.sum(2.0 * dq * du * dv, dim=2),
            torch.sum(dq * dv * dv, dim=2),
            torch.sum(ga * g, dim=2),
        ] + [torch.sum(gc[ch] * w, dim=2) for ch in range(4)]
        dfeat[:, dcol] = torch.stack(rows)
    return dfeat


def _check_inputs(pair_feat, tile_start, tile_count, cfg: RenderConfig):
    _check_cfg(cfg)
    num_tiles = cfg.num_tiles
    if pair_feat.dtype != torch.float32 or pair_feat.dim() != 2 \
            or pair_feat.shape[0] < FEAT_ROWS:
        raise ValueError(
            f"pair_feat must be [>= {FEAT_ROWS}, pairs] float32, got "
            f"{tuple(pair_feat.shape)} {pair_feat.dtype}")
    for name, a in (("tile_start", tile_start), ("tile_count", tile_count)):
        if a.dtype != torch.int32 or tuple(a.shape) != (num_tiles,):
            raise ValueError(
                f"{name} must be [{num_tiles}] int32, got "
                f"{tuple(a.shape)} {a.dtype}")
        if a.device != pair_feat.device:
            raise ValueError(f"{name} is on {a.device}, pair_feat on "
                             f"{pair_feat.device}")
    if pair_feat.shape[1] % cfg.pair_block:
        raise ValueError(
            f"pair count {pair_feat.shape[1]} is not a multiple of "
            f"pair_block {cfg.pair_block}")
    if pair_feat.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {pair_feat.device}")


def _composite_fwd(pair_feat, tile_start, tile_count, cfg: RenderConfig,
                   with_state: bool = False):
    if pair_feat.device.type == "cpu":
        return composite_pairs_plain(pair_feat, tile_start, tile_count, cfg,
                                     with_state=with_state)
    return _launch_fwd(pair_feat, tile_start, tile_count, cfg, with_state)


def composite_pairs_bwd(pair_feat, tile_start, tile_count, fwd_out, state,
                        gout, cfg: RenderConfig, kb: int = 0):
    """d pair_feat rows 0-9, ``[10, padded_pairs]`` f32, for the cotangent
    ``gout`` ``[num_tiles, 8, tile*tile]`` (rows 0-4 read) of the forward
    output ``fwd_out``, from the forward's block-start ``state``
    ``[padded_pairs / pair_block, 5, tile*tile]`` (required: nothing
    rebuilds it); with ``kb`` > 0, the compact layout ``[10, kb*G]``
    (module docstring). CPU tensors take :func:`composite_pairs_bwd_plain`;
    CUDA tensors launch the backward kernel, counted in
    ``composite_pairs.bwd_launches`` (``bwd_log_launches`` for
    ``transmittance_math="log"``; ``bwd_compact_launches`` in compact
    mode, either transmittance), or raise."""
    _check_inputs(pair_feat, tile_start, tile_count, cfg)
    P = cfg.tile * cfg.tile
    shape = (cfg.num_tiles, 8, P)
    for name, a, want in (
            ("fwd_out", fwd_out, shape), ("gout", gout, shape),
            ("state", state,
             (pair_feat.shape[1] // cfg.pair_block, STATE_ROWS, P))):
        if not isinstance(a, torch.Tensor) or a.dtype != torch.float32 \
                or tuple(a.shape) != want:
            got = (tuple(a.shape), a.dtype) if isinstance(a, torch.Tensor) \
                else type(a).__name__
            raise ValueError(f"{name} must be {list(want)} float32, got "
                             f"{got}")
        if a.device != pair_feat.device:
            raise ValueError(f"{name} is on {a.device}, pair_feat on "
                             f"{pair_feat.device}")
    if kb < 0:
        raise ValueError(f"kb must be >= 0, got {kb}")
    if pair_feat.device.type == "cpu":
        return composite_pairs_bwd_plain(pair_feat, tile_start, tile_count,
                                         fwd_out, state, gout, cfg, kb=kb)
    return _launch_bwd(pair_feat, tile_start, tile_count, fwd_out, state,
                       gout, cfg, kb)


class _CompositePairs(torch.autograd.Function):
    """K1 forward (with its block-start state), K2 backward
    (``raster_pallas.py:432-447``)."""

    @staticmethod
    def forward(ctx, pair_feat, tile_start, tile_count, cfg):
        out, state = _composite_fwd(pair_feat, tile_start, tile_count, cfg,
                                    with_state=True)
        ctx.cfg = cfg
        ctx.save_for_backward(pair_feat, tile_start, tile_count, out, state)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gout):
        pair_feat, tile_start, tile_count, out, state = ctx.saved_tensors
        d = composite_pairs_bwd(pair_feat, tile_start, tile_count, out,
                                state, gout.contiguous(), ctx.cfg)
        extra = pair_feat.shape[0] - FEAT_ROWS
        if extra:  # rows the compositor does not read carry no gradient
            d = torch.cat([d, d.new_zeros(extra, d.shape[1])])
        return d, None, None, None


def composite_pairs(pair_feat, tile_start, tile_count, cfg: RenderConfig):
    """Composite the block-aligned pair list into per-tile pixel buffers.

    Args:
        pair_feat: [>= 10, padded_pairs] f32 feature-major pair features
            (padding slots all-zero).
        tile_start: [num_tiles] int32 first pair slot of each tile (a
            multiple of ``cfg.pair_block``).
        tile_count: [num_tiles] int32 real pairs of each tile.
        cfg: static render config.

    Returns:
        [num_tiles, 8, tile*tile] f32 (see the module docstring).

    CPU tensors take the plain version. CUDA tensors launch the kernel
    (``csrc/raster_fwd.cu``: each warp skips the pairs that cannot reach
    its 8x4 pixels, :func:`pair_warp_reach`, and the result equals the
    plain version bit for bit), and count it in
    ``composite_pairs.launches`` (``log_launches`` for
    ``transmittance_math="log"``); anything the kernel does not take raises.
    With grad enabled and ``pair_feat`` requiring grad the
    call is recorded for autograd: the forward also writes its block-start
    state, saved with its output, and the backward is
    :func:`composite_pairs_bwd` (the backward kernel on CUDA, counted in
    ``composite_pairs.bwd_launches`` or ``bwd_log_launches``). Under
    ``torch.no_grad()`` nothing is recorded or saved, and no state is
    written.
    """
    _check_inputs(pair_feat, tile_start, tile_count, cfg)
    if torch.is_grad_enabled() and pair_feat.requires_grad:
        return _CompositePairs.apply(pair_feat, tile_start, tile_count, cfg)
    return _composite_fwd(pair_feat, tile_start, tile_count, cfg)


composite_pairs.launches = 0  # forward kernel (K1) launches, "cumprod"
composite_pairs.bwd_launches = 0  # backward kernel (K2) launches, "cumprod"
composite_pairs.log_launches = 0  # K1 launches, transmittance_math="log"
composite_pairs.bwd_log_launches = 0  # K2 launches, "log"
composite_pairs.bwd_compact_launches = 0  # K2 launches in compact mode
composite_pairs.bwd_ctas = 0  # CTAs of the last K2 launch (persistent grid)


def _check_kernel_args(cfg: RenderConfig, **tensors):
    if cfg.tile != KERNEL_TILE:
        raise ValueError(
            f"the CUDA compositor takes tile={KERNEL_TILE} only "
            f"(got {cfg.tile})")
    G = cfg.pair_block
    if G % 32 or not 0 < G <= MAX_PAIR_BLOCK:
        raise ValueError(
            f"pair_block must be a multiple of 32 in [32, {MAX_PAIR_BLOCK}] "
            f"(got {G})")
    for name, a in tensors.items():
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    n_pairs = tensors["pair_feat"].shape[1]
    if n_pairs >= 2**31 // FEAT_ROWS:
        raise ValueError(f"{n_pairs} pairs exceed the kernel's int32 index")


def _launch_fwd(pair_feat, tile_start, tile_count, cfg: RenderConfig,
                with_state: bool = False, skipped=None):
    """K1. ``skipped``: None (the main path), or a [1] int64 tensor on the
    card to which the kernel adds the (pair, warp) its cull skipped."""
    _check_kernel_args(cfg, pair_feat=pair_feat, tile_start=tile_start,
                       tile_count=tile_count)
    if skipped is not None and (skipped.dtype != torch.int64
                                or skipped.device != pair_feat.device
                                or skipped.numel() != 1):
        raise ValueError("skipped must be one int64 on pair_feat's device")
    from ._build import load_library

    lib = load_library("raster_fwd")
    P = cfg.tile * cfg.tile
    dev = pair_feat.device
    out = torch.empty(cfg.num_tiles, 8, P, dtype=torch.float32, device=dev)
    order = torch.empty(cfg.num_tiles, dtype=torch.int32, device=dev)
    # Only the composited blocks' rows are written (and read back).
    state = torch.empty(pair_feat.shape[1] // cfg.pair_block, STATE_ROWS, P,
                        dtype=torch.float32, device=dev) if with_state \
        else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.raster_fwd(
            pair_feat.data_ptr(), pair_feat.shape[1], pair_feat.stride(0),
            tile_start.data_ptr(), tile_count.data_ptr(), order.data_ptr(),
            out.data_ptr(), None if state is None else state.data_ptr(),
            None if skipped is None else skipped.data_ptr(),
            int(cfg.transmittance_math == "log"),
            cfg.num_tiles, cfg.tiles_x, cfg.view_tile_rows, cfg.pair_block,
            ctypes.c_float(cfg.chi2_clip), ctypes.c_float(cfg.alpha_max),
            ctypes.c_float(cfg.alpha_cutoff),
            ctypes.c_float(cfg.transmittance_min),
            ctypes.c_float(CULL_MARGIN_REL), ctypes.c_float(CULL_MARGIN_EPS),
            ctypes.c_float(CULL_MARGIN_ABS), ctypes.c_float(CULL_KAPPA_MIN),
            stream,
        )
    if err != 0:
        raise RuntimeError(f"raster_fwd launch failed: CUDA error {err}")
    if cfg.transmittance_math == "log":
        composite_pairs.log_launches += 1
    else:
        composite_pairs.launches += 1
    return (out, state) if with_state else out


def fwd_ctas_per_sm(device, log: bool = False) -> int:
    """K1's resident CTAs per SM on the CUDA ``device``, from the occupancy
    API (``raster_fwd_ctas_per_sm``), for the "cumprod" kernel or, with
    ``log``, the "log" one."""
    from ._build import load_library

    lib = load_library("raster_fwd")
    n = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = lib.raster_fwd_ctas_per_sm(int(log), ctypes.byref(n))
    if err != 0:
        raise RuntimeError(f"raster_fwd occupancy query failed: CUDA error "
                           f"{err}")
    return n.value


def _launch_bwd(pair_feat, tile_start, tile_count, fwd_out, state, gout,
                cfg: RenderConfig, kb: int = 0):
    _check_kernel_args(cfg, pair_feat=pair_feat, tile_start=tile_start,
                       tile_count=tile_count, fwd_out=fwd_out, state=state,
                       gout=gout)
    from ._build import load_library

    lib = load_library("raster_bwd")
    n_pairs = pair_feat.shape[1]
    tile_off = tile_block_offsets(fwd_out)
    # Zero-filled: the kernel writes only the composited blocks (in compact
    # mode, the first min(n, kb) blocks of columns).
    dfeat = torch.zeros(FEAT_ROWS, kb * cfg.pair_block if kb else n_pairs,
                        dtype=torch.float32, device=pair_feat.device)
    ctas = ctypes.c_int(0)
    with torch.cuda.device(pair_feat.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.raster_bwd(
            pair_feat.data_ptr(), n_pairs // cfg.pair_block,
            pair_feat.stride(0), tile_start.data_ptr(), tile_off.data_ptr(),
            cfg.num_tiles, fwd_out.data_ptr(), gout.data_ptr(),
            state.data_ptr(), dfeat.data_ptr(), dfeat.stride(0),
            int(cfg.transmittance_math == "log"), cfg.tiles_x,
            cfg.view_tile_rows, kb, cfg.pair_block,
            ctypes.c_float(cfg.chi2_clip),
            ctypes.c_float(cfg.alpha_max), ctypes.c_float(cfg.alpha_cutoff),
            ctypes.c_float(1.0 - cfg.alpha_max),
            ctypes.c_float(cfg.transmittance_min), ctypes.byref(ctas),
            stream,
        )
    if err != 0:
        raise RuntimeError(f"raster_bwd launch failed: CUDA error {err}")
    if kb:
        composite_pairs.bwd_compact_launches += 1
    elif cfg.transmittance_math == "log":
        composite_pairs.bwd_log_launches += 1
    else:
        composite_pairs.bwd_launches += 1
    composite_pairs.bwd_ctas = ctas.value
    return dfeat


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
  ``T_excl`` the product of ``(1 - alpha)`` over the pairs in front
  (the "cumprod" transmittance, computed as a sequential product);
* a tile's continuation block is skipped when the largest T over its
  pixels is ``<= transmittance_min`` (block-granular, as on the TPU: T
  keeps multiplying through every pair of a composited block).

Output ``[num_tiles, 8, tile*tile]`` f32: rows 0-2 sum w*rgb, row 3 sum
w*depth, row 4 final T, row 5 the number of blocks composited, rows 6-7
zero. A tile with no pairs gets rgb = depth = 0, T = 1, count 0.

The backward re-walks each tile's blocks front to back, rebuilding T and
the colour prefix, and emits per-pair d(u, v, a, b, c, opacity, r, g, b,
depth) ``[10, padded_pairs]``; blocks the forward skipped, dead blocks
and padding get exact zeros. It reads the cotangent of rows 0-4 only.

Feature-major pair features ``[>= 10, padded_pairs]`` f32, rows
0:u 1:v 2:conic_a 3:conic_b 4:conic_c 5:opacity 6:r 7:g 8:b 9:depth
(the JAX layout's rows 10-15 are zero padding that nothing reads).

:func:`composite_pairs` chooses by the tensors' device: CPU tensors take
:func:`composite_pairs_plain` / :func:`composite_pairs_bwd_plain`; CUDA
tensors launch the kernels (``csrc/raster_fwd.cu``, ``csrc/raster_bwd.cu``)
or raise. With grad enabled and ``pair_feat`` requiring grad it is a
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


def pack_block_meta(block_tile, block_first):
    """(tile, first/dead) arrays -> packed meta (block_first: 1 first,
    0 continuation, -1 dead; tile must already be clipped in-range)."""
    dead = (block_first < 0).to(block_tile.dtype)
    first = (block_first == 1).to(block_tile.dtype)
    return (block_tile << META_SHIFT) | (dead << 1) | first


def _check_cfg(cfg: RenderConfig):
    if cfg.transmittance_math == "log":
        raise NotImplementedError(
            "transmittance_math='log' is not ported (the port composites "
            "with the exact 'cumprod' product)")
    if cfg.transmittance_math != "cumprod":
        raise ValueError(
            f"unknown transmittance_math {cfg.transmittance_math!r}")
    if cfg.view_tile_rows:
        raise NotImplementedError(
            "view_tile_rows > 0 (batched views) is not ported yet")


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


def _tile_pixels(tiles, cfg: RenderConfig):
    """Pixel centres (px, py), each [len(tiles), tile*tile] f32."""
    t = cfg.tile
    lane = torch.arange(t * t, device=tiles.device)
    px = ((tiles % cfg.tiles_x) * t)[:, None] + lane % t
    py = ((tiles // cfg.tiles_x) * t)[:, None] + lane // t
    return px.to(torch.float32), py.to(torch.float32)


def _running_sum(start, terms):
    """start [m, P] + terms[:, 0] + terms[:, 1] + ... in order, for terms
    [m, G, P]: every prefix, [m, G, P] (a cumulative sum along a
    non-innermost dimension, which PyTorch takes in order)."""
    return torch.cumsum(torch.cat([start[:, None, :], terms], dim=1),
                        dim=1)[:, 1:]


def composite_pairs_plain(pair_feat, tile_start, tile_count, cfg: RenderConfig,
                          tile_chunk: int = 0):
    """Plain PyTorch compositor with the kernel's semantics (any device).

    Walks every tile's blocks in order, all tiles of a chunk at once:
    step k composites the k-th block of each tile that still has one and
    is not saturated. Within a block T is the sequential product
    ``T_in * (1 - a_0) * (1 - a_1) ...`` and each sum the sequential
    ``acc + w_0 c_0 + w_1 c_1 ...``: cumulative ops along a non-innermost
    dimension, which PyTorch evaluates in order on CPU and CUDA. So every
    rounding, and every ``T > transmittance_min`` decision, is the
    kernel's. ``tile_chunk`` > 0 bounds memory to that many tiles at a
    time.
    """
    _check_cfg(cfg)
    dev = pair_feat.device
    G = cfg.pair_block
    P = cfg.tile * cfg.tile
    num_tiles = tile_start.shape[0]
    f32 = torch.float32
    out = torch.zeros(num_tiles, 8, P, dtype=f32, device=dev)
    out[:, 4] = 1.0
    nblk = (tile_count.to(torch.int64) + G - 1) // G
    cols = torch.arange(G, device=dev)
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
            go = k < nb
            if k > 0:
                go &= T.amax(dim=1) > cfg.transmittance_min
            idx = torch.nonzero(go).squeeze(1)
            if idx.numel() == 0:
                break
            pcol = start[idx, None] + k * G + cols  # [m, G]
            f = pair_feat[:FEAT_ROWS, pcol]  # [10, m, G]
            alpha = _block_alpha(f, px[idx], py[idx], cfg)[0]  # [m, G, P]
            prod = torch.cumprod(
                torch.cat([T[idx][:, None, :], 1.0 - alpha], dim=1), dim=1
            )
            T_excl = prod[:, :G]
            w = torch.where(T_excl > cfg.transmittance_min,
                            alpha * T_excl, 0.0)
            for ch in range(4):
                # Sequential running sum acc + w_0 c_0 + w_1 c_1 + ..., in
                # the kernel's order (same cumulative-op argument as T).
                acc[idx, ch] = _running_sum(
                    acc[idx, ch], w * f[6 + ch][:, :, None])[:, G - 1]
            T[idx] = prod[:, G]
            cnt[idx] += 1.0
            k += 1
        out[tiles, 0:4] = acc
        out[tiles, 4] = T
        out[tiles, 5] = cnt[:, None]
    return out


def composite_pairs_bwd_plain(pair_feat, tile_start, tile_count, fwd_out,
                              gout, cfg: RenderConfig, tile_chunk: int = 0):
    """Plain PyTorch backward with the kernel's semantics (any device).

    The VJP of :func:`composite_pairs_plain` as ``_bwd_kernel`` computes it
    (``raster_pallas.py:243-346``). Walks the blocks exactly as the forward
    does (same skip decisions, same T), and per (pair, pixel):

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
    only the order of the pixel sums differs (the kernel reduces by warp
    shuffles, then over warps). Returns ``[10, padded_pairs]`` f32, exact
    zeros outside the composited blocks. Reads rows 0-4 of ``gout``.
    """
    _check_cfg(cfg)
    dev = pair_feat.device
    G = cfg.pair_block
    P = cfg.tile * cfg.tile
    num_tiles = tile_start.shape[0]
    f32 = torch.float32
    dfeat = torch.zeros(FEAT_ROWS, pair_feat.shape[1], dtype=f32, device=dev)
    nblk = (tile_count.to(torch.int64) + G - 1) // G
    cols = torch.arange(G, device=dev)
    one_minus_max = 1.0 - cfg.alpha_max  # the kernel gets this same float
    chunk = tile_chunk if tile_chunk > 0 else max(num_tiles, 1)
    for c0 in range(0, num_tiles, chunk):
        tiles = torch.arange(c0, min(c0 + chunk, num_tiles), device=dev)
        m_all = tiles.shape[0]
        px, py = _tile_pixels(tiles, cfg)
        gC = gout[tiles, 0:4]  # [m, 4, P]
        fo = fwd_out[tiles]
        gS_full = (gC[:, 0] * fo[:, 0] + gC[:, 1] * fo[:, 1]
                   + gC[:, 2] * fo[:, 2] + gC[:, 3] * fo[:, 3])  # [m, P]
        gTT = gout[tiles, 4] * fo[:, 4]
        T = torch.ones(m_all, P, dtype=f32, device=dev)
        acc = torch.zeros(m_all, 4, P, dtype=f32, device=dev)
        nb = nblk[tiles]
        start = tile_start[tiles].to(torch.int64)
        k = 0
        while True:
            go = k < nb
            if k > 0:
                go &= T.amax(dim=1) > cfg.transmittance_min
            idx = torch.nonzero(go).squeeze(1)
            if idx.numel() == 0:
                break
            pcol = start[idx, None] + k * G + cols  # [m, G]
            f = pair_feat[:FEAT_ROWS, pcol]  # [10, m, G]
            alpha, du, dv, g, a_raw, a = _block_alpha(f, px[idx], py[idx], cfg)
            prod = torch.cumprod(
                torch.cat([T[idx][:, None, :], 1.0 - alpha], dim=1), dim=1
            )
            T_excl = prod[:, :G]
            alive = T_excl > cfg.transmittance_min
            w = torch.where(alive, alpha * T_excl, 0.0)
            gc = [gC[idx, ch][:, None, :] for ch in range(4)]  # [m, 1, P]
            rgb = [f[6 + ch][:, :, None] for ch in range(4)]  # [m, G, 1]
            gdotc = gc[0] * rgb[0] + gc[1] * rgb[1] + gc[2] * rgb[2] \
                + gc[3] * rgb[3]
            ai = acc[idx]
            gP_in = (gc[0][:, 0] * ai[:, 0] + gc[1][:, 0] * ai[:, 1]
                     + gc[2][:, 0] * ai[:, 2] + gc[3][:, 0] * ai[:, 3])
            gS = gS_full[idx][:, None, :] - _running_sum(gP_in, gdotc * w)
            one_minus = torch.clamp(1.0 - alpha, min=one_minus_max)
            dalpha = torch.where(alive, gdotc * T_excl, 0.0) \
                - (gS + gTT[idx][:, None, :]) / one_minus
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
            dfeat[:, pcol] = torch.stack(rows)
            for ch in range(4):
                acc[idx, ch] = _running_sum(ai[:, ch], w * rgb[ch])[:, G - 1]
            T[idx] = prod[:, G]
            k += 1
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


def _composite_fwd(pair_feat, tile_start, tile_count, cfg: RenderConfig):
    if pair_feat.device.type == "cpu":
        return composite_pairs_plain(pair_feat, tile_start, tile_count, cfg)
    return _launch_fwd(pair_feat, tile_start, tile_count, cfg)


def composite_pairs_bwd(pair_feat, tile_start, tile_count, fwd_out, gout,
                        cfg: RenderConfig):
    """d pair_feat rows 0-9, ``[10, padded_pairs]`` f32, for the cotangent
    ``gout`` ``[num_tiles, 8, tile*tile]`` (rows 0-4 read) of the forward
    output ``fwd_out``. CPU tensors take :func:`composite_pairs_bwd_plain`;
    CUDA tensors launch the backward kernel, counted in
    ``composite_pairs.bwd_launches``, or raise."""
    _check_inputs(pair_feat, tile_start, tile_count, cfg)
    shape = (cfg.num_tiles, 8, cfg.tile * cfg.tile)
    for name, a in (("fwd_out", fwd_out), ("gout", gout)):
        if a.dtype != torch.float32 or tuple(a.shape) != shape:
            raise ValueError(f"{name} must be {list(shape)} float32, got "
                             f"{tuple(a.shape)} {a.dtype}")
        if a.device != pair_feat.device:
            raise ValueError(f"{name} is on {a.device}, pair_feat on "
                             f"{pair_feat.device}")
    if pair_feat.device.type == "cpu":
        return composite_pairs_bwd_plain(pair_feat, tile_start, tile_count,
                                         fwd_out, gout, cfg)
    return _launch_bwd(pair_feat, tile_start, tile_count, fwd_out, gout, cfg)


class _CompositePairs(torch.autograd.Function):
    """K1 forward, K2 backward (``raster_pallas.py:432-447``)."""

    @staticmethod
    def forward(ctx, pair_feat, tile_start, tile_count, cfg):
        out = _composite_fwd(pair_feat, tile_start, tile_count, cfg)
        ctx.cfg = cfg
        ctx.save_for_backward(pair_feat, tile_start, tile_count, out)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gout):
        pair_feat, tile_start, tile_count, out = ctx.saved_tensors
        d = composite_pairs_bwd(pair_feat, tile_start, tile_count, out,
                                gout.contiguous(), ctx.cfg)
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

    CPU tensors take the plain version. CUDA tensors launch the kernel,
    and count it in ``composite_pairs.launches``; anything the kernel does
    not take raises. With grad enabled and ``pair_feat`` requiring grad the
    call is recorded for autograd: its backward is
    :func:`composite_pairs_bwd` (the backward kernel on CUDA, counted in
    ``composite_pairs.bwd_launches``). Under ``torch.no_grad()`` nothing is
    recorded or saved.
    """
    _check_inputs(pair_feat, tile_start, tile_count, cfg)
    if torch.is_grad_enabled() and pair_feat.requires_grad:
        return _CompositePairs.apply(pair_feat, tile_start, tile_count, cfg)
    return _composite_fwd(pair_feat, tile_start, tile_count, cfg)


composite_pairs.launches = 0  # forward kernel (K1) launches
composite_pairs.bwd_launches = 0  # backward kernel (K2) launches


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


def _launch_fwd(pair_feat, tile_start, tile_count, cfg: RenderConfig):
    _check_kernel_args(cfg, pair_feat=pair_feat, tile_start=tile_start,
                       tile_count=tile_count)
    from ._build import load_library

    lib = load_library("raster_fwd")
    P = cfg.tile * cfg.tile
    out = torch.empty(cfg.num_tiles, 8, P, dtype=torch.float32,
                      device=pair_feat.device)
    with torch.cuda.device(pair_feat.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.raster_fwd(
            pair_feat.data_ptr(), pair_feat.shape[1], pair_feat.stride(0),
            tile_start.data_ptr(), tile_count.data_ptr(), out.data_ptr(),
            cfg.num_tiles, cfg.tiles_x, cfg.pair_block,
            ctypes.c_float(cfg.chi2_clip), ctypes.c_float(cfg.alpha_max),
            ctypes.c_float(cfg.alpha_cutoff),
            ctypes.c_float(cfg.transmittance_min), stream,
        )
    if err != 0:
        raise RuntimeError(f"raster_fwd launch failed: CUDA error {err}")
    composite_pairs.launches += 1
    return out


def _launch_bwd(pair_feat, tile_start, tile_count, fwd_out, gout,
                cfg: RenderConfig):
    _check_kernel_args(cfg, pair_feat=pair_feat, tile_start=tile_start,
                       tile_count=tile_count, fwd_out=fwd_out, gout=gout)
    from ._build import load_library

    lib = load_library("raster_bwd")
    n_pairs = pair_feat.shape[1]
    # Zero-filled: blocks the kernel never visits (skipped, dead) read 0.
    dfeat = torch.zeros(FEAT_ROWS, n_pairs, dtype=torch.float32,
                        device=pair_feat.device)
    with torch.cuda.device(pair_feat.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.raster_bwd(
            pair_feat.data_ptr(), n_pairs, pair_feat.stride(0),
            tile_start.data_ptr(), tile_count.data_ptr(), fwd_out.data_ptr(),
            gout.data_ptr(), dfeat.data_ptr(), dfeat.stride(0),
            cfg.num_tiles, cfg.tiles_x, cfg.pair_block,
            ctypes.c_float(cfg.chi2_clip), ctypes.c_float(cfg.alpha_max),
            ctypes.c_float(cfg.alpha_cutoff),
            ctypes.c_float(1.0 - cfg.alpha_max),
            ctypes.c_float(cfg.transmittance_min), stream,
        )
    if err != 0:
        raise RuntimeError(f"raster_bwd launch failed: CUDA error {err}")
    composite_pairs.bwd_launches += 1
    return dfeat

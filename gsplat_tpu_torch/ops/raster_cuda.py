"""Tile compositing: the Hopper forward kernel and its plain PyTorch version.

Counterpart of ``gsplat_tpu/ops/raster_pallas.py`` (the forward
``_fwd_kernel``, ``:192-240``, launched by ``_fwd_pallas`` at ``:349-370``).
Front-to-back alpha compositing of the tile-major, depth-ordered,
block-aligned pair list that ``ops/binning.py`` emits:

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

Feature-major pair features ``[>= 10, padded_pairs]`` f32, rows
0:u 1:v 2:conic_a 3:conic_b 4:conic_c 5:opacity 6:r 7:g 8:b 9:depth
(the JAX layout's rows 10-15 are zero padding that nothing reads).

:func:`composite_pairs` chooses by the tensors' device: CPU tensors take
:func:`composite_pairs_plain`; CUDA tensors launch the kernel
(``csrc/raster_fwd.cu``) or raise. This slice is forward-only: a CUDA
input that requires grad raises until the backward kernel is ported.
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
    """alpha [m, G, P] for features f [10, m, G] and pixel centres [m, P].

    Operation order matches the CUDA kernel, which is built with
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
    a = torch.clamp(op * g, max=cfg.alpha_max)
    return torch.where(a >= cfg.alpha_cutoff, a, 0.0)


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
    t = cfg.tile
    P = t * t
    num_tiles = tile_start.shape[0]
    f32 = torch.float32
    out = torch.zeros(num_tiles, 8, P, dtype=f32, device=dev)
    out[:, 4] = 1.0
    nblk = (tile_count.to(torch.int64) + G - 1) // G
    lane = torch.arange(P, device=dev)
    cols = torch.arange(G, device=dev)
    chunk = tile_chunk if tile_chunk > 0 else max(num_tiles, 1)
    for c0 in range(0, num_tiles, chunk):
        tiles = torch.arange(c0, min(c0 + chunk, num_tiles), device=dev)
        px = ((tiles % cfg.tiles_x) * t)[:, None] + lane % t
        py = ((tiles // cfg.tiles_x) * t)[:, None] + lane // t
        px, py = px.to(f32), py.to(f32)
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
            alpha = _block_alpha(f, px[idx], py[idx], cfg)  # [m, G, P]
            prod = torch.cumprod(
                torch.cat([T[idx][:, None, :], 1.0 - alpha], dim=1), dim=1
            )
            T_excl = prod[:, :G]
            w = torch.where(T_excl > cfg.transmittance_min,
                            alpha * T_excl, 0.0)
            for ch in range(4):
                # Sequential running sum acc + w_0 c_0 + w_1 c_1 + ..., in
                # the kernel's order (same cumulative-op argument as T).
                acc[idx, ch] = torch.cumsum(torch.cat(
                    [acc[idx, ch][:, None, :], w * f[6 + ch][:, :, None]],
                    dim=1), dim=1)[:, G]
            T[idx] = prod[:, G]
            cnt[idx] += 1.0
            k += 1
        out[tiles, 0:4] = acc
        out[tiles, 4] = T
        out[tiles, 5] = cnt[:, None]
    return out


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
    not take raises.
    """
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
    if pair_feat.device.type == "cpu":
        return composite_pairs_plain(pair_feat, tile_start, tile_count, cfg)
    if pair_feat.device.type != "cuda":
        raise ValueError(f"unsupported device {pair_feat.device}")
    return _launch_fwd(pair_feat, tile_start, tile_count, cfg)


composite_pairs.launches = 0


def _launch_fwd(pair_feat, tile_start, tile_count, cfg: RenderConfig):
    if pair_feat.requires_grad:
        raise NotImplementedError("backward kernel not ported yet")
    if cfg.tile != KERNEL_TILE:
        raise ValueError(
            f"the CUDA compositor takes tile={KERNEL_TILE} only "
            f"(got {cfg.tile})")
    G = cfg.pair_block
    if G % 32 or not 0 < G <= MAX_PAIR_BLOCK:
        raise ValueError(
            f"pair_block must be a multiple of 32 in [32, {MAX_PAIR_BLOCK}] "
            f"(got {G})")
    for name, a in (("pair_feat", pair_feat), ("tile_start", tile_start),
                    ("tile_count", tile_count)):
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    n_pairs = pair_feat.shape[1]
    if n_pairs >= 2**31 // FEAT_ROWS:
        raise ValueError(f"{n_pairs} pairs exceed the kernel's int32 index")

    from ._build import load_library

    lib = load_library("raster_fwd")
    P = cfg.tile * cfg.tile
    out = torch.empty(cfg.num_tiles, 8, P, dtype=torch.float32,
                      device=pair_feat.device)
    with torch.cuda.device(pair_feat.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.raster_fwd(
            pair_feat.data_ptr(), n_pairs, pair_feat.stride(0),
            tile_start.data_ptr(), tile_count.data_ptr(), out.data_ptr(),
            cfg.num_tiles, cfg.tiles_x, G,
            ctypes.c_float(cfg.chi2_clip), ctypes.c_float(cfg.alpha_max),
            ctypes.c_float(cfg.alpha_cutoff),
            ctypes.c_float(cfg.transmittance_min), stream,
        )
    if err != 0:
        raise RuntimeError(f"raster_fwd launch failed: CUDA error {err}")
    composite_pairs.launches += 1
    return out

"""Feature compositing (Feature 3DGS, Zhou et al. 2024): the Hopper kernels
F1 and F2 and their plain PyTorch versions.

A gaussian may carry a feature vector ``f`` of C floats (the pool's
``f_sem`` leaf, [N, C], C a multiple of 32). Its feature map is
composited with the RGB frame's own weights,

    F_c(p) = sum over the tile's pairs j of w_j(p) f_{g(j), c},

with ``w`` exactly K1's (``raster_cuda``: the same alpha, cutoffs,
``transmittance_min`` and block-granular saturation; only the blocks K1
composited, its output row 5) and ``g(j) = depth_order[pair_slot[j]]``
the pair's gaussian. The map is ``[C, H, W]`` f32.

The backward takes the map's cotangent ``gF`` ``[C, H, W]`` and gives

* ``d f`` ``[N, C]``: ``sum_p w_j(p) gF(p)`` summed over each gaussian's
  pairs;
* the feature channels' part of each composited pair's alpha gradient,
  ``[alive] ((gF . f_j) T_excl - (gF . F - gP) / max(1 - alpha, 1 -
  alpha_max))`` with ``gP`` the running ``gF . (prefix of F)`` including
  the pair (K2's formula with the features as further colour channels,
  and no final-transmittance term; past saturation every later weight is
  0, so the exact gradient is 0 there and ``[alive]`` keeps it so rather
  than the rounding left in ``gF . F - gP``), gated as K2 gates it and
  carried to the six geometry partials (u, v, conic, opacity), which it
  ADDS to rows 0-5 of K2's ``[10, pairs]`` output in place, before the
  keyed reduction sums them per gaussian.

No ``[C, pairs]`` buffer: the kernels read a pair's feature row by its
gaussian inside the kernel (``csrc/raster_feat.cu``; its header gives the
design). The plain versions, the CPU path, gather per block of tiles.

Scope: tile 16, ``pair_block`` a multiple of 32 up to 256,
``transmittance_math="cumprod"``, one view at a time (no
``view_tile_rows``), the whole backward list (``bwd_pairs = 0``);
:func:`check_config` raises otherwise, on either device.

F1 equals :func:`composite_features_plain` bit for bit (the same sums in
the same order). F2 adds with float atomics (``d f`` over the gaussian's
pairs and the warps of a tile, the geometry partials over the channel
groups), so it is not deterministic: two launches may differ at rounding
level.
"""

from __future__ import annotations

import ctypes

import torch

from ..config import RenderConfig
from . import raster_cuda as rc

CHANNEL_GROUP = 32  # channels one CTA composites; C must be a multiple
MAX_PAIR_BLOCK = 256


def check_config(cfg: RenderConfig, channels: int):
    """Raise ``ValueError`` unless the feature compositors take ``cfg`` and
    ``channels`` (module docstring)."""
    why = []
    if cfg.tile != 16:
        why.append(f"tile 16 (got {cfg.tile})")
    G = cfg.pair_block
    if G % 32 or not 0 < G <= MAX_PAIR_BLOCK:
        why.append(f"a pair_block that is a multiple of 32 up to "
                   f"{MAX_PAIR_BLOCK} (got {G})")
    if cfg.transmittance_math != "cumprod":
        why.append(f"transmittance_math='cumprod' (got "
                   f"{cfg.transmittance_math!r})")
    if cfg.view_tile_rows:
        why.append("one view at a time (batched views are not supported)")
    if cfg.bwd_pairs:
        why.append("bwd_pairs=0 (the compacted backward is not supported)")
    if channels % CHANNEL_GROUP or channels <= 0:
        why.append(f"a multiple of {CHANNEL_GROUP} channels (got "
                   f"{channels})")
    if why:
        raise ValueError("feature compositing takes " + "; ".join(why))


def _pair_rows(f_sem, depth_order, pair_slot):
    """(the feature rows [*, C] of the pairs ``pair_slot`` [*] by their
    gaussian, zero at padding; the gaussian index, -1 at padding)."""
    n = depth_order.shape[0]
    slot = pair_slot.to(torch.int64)
    g = torch.where(slot >= 0,
                    depth_order.to(torch.int64)[torch.clamp(slot, 0, n - 1)],
                    -1)
    rows = f_sem[torch.clamp(g, 0)]
    return torch.where((g >= 0)[..., None], rows, 0.0), g


def _tile_planes(x, cfg: RenderConfig):
    """[C, H, W] image planes -> [num_tiles, C, tile*tile] (zero past the
    image's edge)."""
    C = x.shape[0]
    t = cfg.tile
    pad = x.new_zeros(C, cfg.padded_height, cfg.padded_width)
    pad[:, :cfg.height, :cfg.width] = x
    return pad.reshape(C, cfg.tiles_y, t, cfg.tiles_x, t).permute(
        1, 3, 0, 2, 4).reshape(cfg.num_tiles, C, t * t)


def _image_planes(tiles, cfg: RenderConfig):
    """[num_tiles, C, tile*tile] -> [C, H, W]."""
    C = tiles.shape[1]
    t = cfg.tile
    return tiles.reshape(cfg.tiles_y, cfg.tiles_x, C, t, t).permute(
        2, 0, 3, 1, 4).reshape(C, cfg.padded_height, cfg.padded_width)[
            :, :cfg.height, :cfg.width].contiguous()


def _walk(fwd_out, tile_start, cfg: RenderConfig):
    """The composited blocks step by step: for k = 0, 1, ... the tiles that
    composited a k-th block, with their blocks' pair columns [m, G]."""
    nblk = fwd_out[:, 5, 0].to(torch.int64)
    start = tile_start.to(torch.int64)
    cols = torch.arange(cfg.pair_block, device=fwd_out.device)
    k = 0
    while True:
        idx = torch.nonzero(k < nblk).squeeze(1)
        if idx.numel() == 0:
            return
        yield idx, start[idx, None] + k * cfg.pair_block + cols
        k += 1


def composite_features_plain(pair_feat, pair_slot, depth_order, f_sem,
                             tile_start, fwd_out, cfg: RenderConfig):
    """Plain PyTorch F1 (any device): the feature map ``[C, H, W]``.

    Walks the blocks K1 composited (``fwd_out`` row 5), all tiles at once,
    with K1's alpha and transmittance (``raster_cuda._block_alpha``,
    ``_block_transmittance``) and each channel's sum a sequential running
    sum over the pairs in list order, as F1 adds them."""
    dev = pair_feat.device
    C = f_sem.shape[1]
    P = cfg.tile * cfg.tile
    f32 = torch.float32
    acc = torch.zeros(cfg.num_tiles, C, P, dtype=f32, device=dev)
    T = torch.ones(cfg.num_tiles, P, dtype=f32, device=dev)
    px, py = rc._tile_pixels(torch.arange(cfg.num_tiles, device=dev), cfg)
    for idx, pcol in _walk(fwd_out, tile_start, cfg):
        f = pair_feat[:rc.FEAT_ROWS, pcol]  # [10, m, G]
        alpha = rc._block_alpha(f, px[idx], py[idx], cfg)[0]
        T_excl, T_out = rc._block_transmittance(alpha, T[idx], cfg)
        w = torch.where(T_excl > cfg.transmittance_min, alpha * T_excl, 0.0)
        rows = _pair_rows(f_sem, depth_order, pair_slot[pcol])[0]  # [m,G,C]
        a = acc[idx]
        for c in range(C):
            a[:, c] = rc._running_sum(a[:, c], w * rows[:, :, c, None])[
                :, -1]
        acc[idx] = a
        T[idx] = T_out
    return _image_planes(acc, cfg)


def composite_features_bwd_plain(pair_feat, pair_slot, depth_order, f_sem,
                                 tile_start, fwd_out, fmap, gfmap, dgeo,
                                 cfg: RenderConfig):
    """Plain PyTorch F2 (any device): adds the feature channels' part of
    the geometry gradient into rows 0-5 of ``dgeo`` (K2's ``[10, pairs]``
    output) in place and returns ``d f_sem`` ``[N, C]`` (module
    docstring). Walks each tile from its start, carrying T and ``gP``."""
    dev = pair_feat.device
    N, C = f_sem.shape
    P = cfg.tile * cfg.tile
    f32 = torch.float32
    gF = _tile_planes(gfmap, cfg)  # [tiles, C, P]
    gS_full = torch.sum(gF * _tile_planes(fmap, cfg), dim=1)  # [tiles, P]
    T = torch.ones(cfg.num_tiles, P, dtype=f32, device=dev)
    gP = torch.zeros(cfg.num_tiles, P, dtype=f32, device=dev)
    dfs = torch.zeros(N, C, dtype=f32, device=dev)
    px, py = rc._tile_pixels(torch.arange(cfg.num_tiles, device=dev), cfg)
    one_minus_max = 1.0 - cfg.alpha_max
    for idx, pcol in _walk(fwd_out, tile_start, cfg):
        f = pair_feat[:rc.FEAT_ROWS, pcol]  # [10, m, G]
        alpha, du, dv, g, a_raw, a = rc._block_alpha(f, px[idx], py[idx],
                                                     cfg)
        T_excl, T_out = rc._block_transmittance(alpha, T[idx], cfg)
        alive = T_excl > cfg.transmittance_min
        w = torch.where(alive, alpha * T_excl, 0.0)
        rows, gid = _pair_rows(f_sem, depth_order, pair_slot[pcol])
        gFt = gF[idx]  # [m, C, P]
        gdotf = torch.einsum("mgc,mcp->mgp", rows, gFt)
        run = rc._running_sum(gP[idx], gdotf * w)  # [m, G, P]
        gS = gS_full[idx][:, None, :] - run
        one_minus = torch.clamp(1.0 - alpha, min=one_minus_max)
        dalpha = torch.where(alive, gdotf * T_excl - gS / one_minus, 0.0)
        gate = (a_raw < cfg.alpha_max) & (a >= cfg.alpha_cutoff)
        ga = torch.where(gate, dalpha, 0.0)
        ca, cb, cc, op = (f[r][:, :, None] for r in (2, 3, 4, 5))
        dq = ga * op * (-0.5) * g
        geo = torch.stack([
            -torch.sum(dq * (2.0 * ca * du + 2.0 * cb * dv), dim=2),
            -torch.sum(dq * (2.0 * cc * dv + 2.0 * cb * du), dim=2),
            torch.sum(dq * du * du, dim=2),
            torch.sum(2.0 * dq * du * dv, dim=2),
            torch.sum(dq * dv * dv, dim=2),
            torch.sum(ga * g, dim=2),
        ])  # [6, m, G]
        dgeo[:6, pcol] += geo
        dpair = torch.einsum("mgp,mcp->mgc", w, gFt)  # [m, G, C]
        keep = gid >= 0
        dfs.index_add_(0, gid[keep], dpair[keep])
        gP[idx] = run[:, -1]
        T[idx] = T_out
    return dfs


def weight_counts(pair_feat, tile_start, fwd_out, cfg: RenderConfig):
    """(the composited (pair, pixel) whose weight is not 0, the pairs with
    such a pixel) of the frame K1 composited into ``fwd_out``: what F1 and
    F2 at least work on, counted on K1's walk as the plain versions take
    it (plain PyTorch, any device)."""
    dev = pair_feat.device
    T = torch.ones(cfg.num_tiles, cfg.tile * cfg.tile, dtype=torch.float32,
                   device=dev)
    px, py = rc._tile_pixels(torch.arange(cfg.num_tiles, device=dev), cfg)
    pair_pixels = contrib = torch.zeros((), dtype=torch.int64, device=dev)
    for idx, pcol in _walk(fwd_out, tile_start, cfg):
        alpha = rc._block_alpha(pair_feat[:rc.FEAT_ROWS, pcol], px[idx],
                                py[idx], cfg)[0]
        T_excl, T_out = rc._block_transmittance(alpha, T[idx], cfg)
        nz = (T_excl > cfg.transmittance_min) & (alpha > 0)  # [m, G, P]
        pair_pixels = pair_pixels + nz.sum()
        contrib = contrib + nz.any(dim=2).sum()
        T[idx] = T_out
    return int(pair_pixels), int(contrib)


def _check_tensors(pair_feat, pair_slot, depth_order, f_sem, tile_start,
                   fwd_out, cfg: RenderConfig, **more):
    # (no tile_count: the blocks walked are K1's row 5)
    rc._check_inputs(pair_feat, tile_start, tile_start, cfg)
    check_config(cfg, f_sem.shape[1] if f_sem.dim() == 2 else 0)
    if f_sem.dtype != torch.float32 or f_sem.dim() != 2:
        raise ValueError(f"f_sem must be [N, C] float32, got "
                         f"{tuple(f_sem.shape)} {f_sem.dtype}")
    n_pairs = pair_feat.shape[1]
    want = {"pair_slot": ((n_pairs,), torch.int32),
            "depth_order": ((f_sem.shape[0],), torch.int32),
            "fwd_out": ((cfg.num_tiles, 8, cfg.tile * cfg.tile),
                        torch.float32)}
    C, H, W = f_sem.shape[1], cfg.height, cfg.width
    for name in more:
        want[name] = ((C, H, W), torch.float32)
    for name, a in dict(pair_slot=pair_slot, depth_order=depth_order,
                        fwd_out=fwd_out, **more).items():
        shape, dtype = want[name]
        if tuple(a.shape) != shape or a.dtype != dtype:
            raise ValueError(f"{name} must be {list(shape)} {dtype}, got "
                             f"{tuple(a.shape)} {a.dtype}")
        if a.device != pair_feat.device:
            raise ValueError(f"{name} is on {a.device}, pair_feat on "
                             f"{pair_feat.device}")
    if f_sem.device != pair_feat.device:
        raise ValueError(f"f_sem is on {f_sem.device}, pair_feat on "
                         f"{pair_feat.device}")


def composite_features(pair_feat, pair_slot, depth_order, f_sem, tile_start,
                       fwd_out, cfg: RenderConfig):
    """The feature map ``[C, H, W]`` of the frame K1 composited into
    ``fwd_out`` from the gathered pair rows ``pair_feat`` ``[>= 10,
    pairs]``: F1 on CUDA tensors (counted in
    ``composite_features.launches``), :func:`composite_features_plain` on
    CPU tensors. ``pair_slot`` [pairs] and ``depth_order`` [N] are the
    binning's (int32), ``f_sem`` [N, C] the features by gaussian."""
    _check_tensors(pair_feat, pair_slot, depth_order, f_sem, tile_start,
                   fwd_out, cfg)
    if pair_feat.device.type == "cpu":
        return composite_features_plain(pair_feat, pair_slot, depth_order,
                                        f_sem, tile_start, fwd_out, cfg)
    return _launch(pair_feat, pair_slot, depth_order, f_sem, tile_start,
                   fwd_out, cfg)


def composite_features_bwd(pair_feat, pair_slot, depth_order, f_sem,
                           tile_start, fwd_out, fmap, gfmap, dgeo,
                           cfg: RenderConfig):
    """F2 on CUDA tensors (counted in ``composite_features.bwd_launches``),
    :func:`composite_features_bwd_plain` on CPU tensors: adds into rows
    0-5 of ``dgeo`` (K2's output, ``[10, pairs]``) and returns ``d f_sem``
    ``[N, C]``."""
    _check_tensors(pair_feat, pair_slot, depth_order, f_sem, tile_start,
                   fwd_out, cfg, fmap=fmap, gfmap=gfmap)
    if tuple(dgeo.shape) != (rc.FEAT_ROWS, pair_feat.shape[1]) \
            or dgeo.dtype != torch.float32:
        raise ValueError(f"dgeo must be [{rc.FEAT_ROWS}, "
                         f"{pair_feat.shape[1]}] float32, got "
                         f"{tuple(dgeo.shape)} {dgeo.dtype}")
    if pair_feat.device.type == "cpu":
        return composite_features_bwd_plain(
            pair_feat, pair_slot, depth_order, f_sem, tile_start, fwd_out,
            fmap, gfmap, dgeo, cfg)
    return _launch(pair_feat, pair_slot, depth_order, f_sem, tile_start,
                   fwd_out, cfg, fmap=fmap, gfmap=gfmap, dgeo=dgeo)


composite_features.launches = 0  # F1 launches
composite_features.bwd_launches = 0  # F2 launches


def _launch(pair_feat, pair_slot, depth_order, f_sem, tile_start, fwd_out,
            cfg: RenderConfig, fmap=None, gfmap=None, dgeo=None):
    """F1 (``fmap`` None: returns the map) or F2 (returns ``d f_sem``)."""
    from ._build import load_library

    for name, a in (("pair_feat", pair_feat), ("pair_slot", pair_slot),
                    ("depth_order", depth_order), ("f_sem", f_sem),
                    ("tile_start", tile_start), ("fwd_out", fwd_out),
                    ("fmap", fmap), ("gfmap", gfmap), ("dgeo", dgeo)):
        if a is not None and not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    lib = load_library("raster_feat")
    dev = pair_feat.device
    C = f_sem.shape[1]
    common = (ctypes.c_float(cfg.chi2_clip), ctypes.c_float(cfg.alpha_max),
              ctypes.c_float(cfg.alpha_cutoff))
    margins = (ctypes.c_float(rc.CULL_MARGIN_REL),
               ctypes.c_float(rc.CULL_MARGIN_EPS),
               ctypes.c_float(rc.CULL_MARGIN_ABS),
               ctypes.c_float(rc.CULL_KAPPA_MIN))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        if fmap is None:
            out = torch.empty(C, cfg.height, cfg.width, dtype=torch.float32,
                              device=dev)
            err = lib.feat_fwd(
                pair_feat.data_ptr(), pair_feat.stride(0),
                pair_slot.data_ptr(), depth_order.data_ptr(),
                f_sem.data_ptr(), C, tile_start.data_ptr(),
                fwd_out.data_ptr(), out.data_ptr(), cfg.num_tiles,
                cfg.tiles_x, cfg.height, cfg.width, cfg.tile, cfg.pair_block,
                *common, ctypes.c_float(cfg.transmittance_min), *margins,
                stream)
        else:
            out = torch.zeros_like(f_sem)
            err = lib.feat_bwd(
                pair_feat.data_ptr(), pair_feat.stride(0),
                pair_slot.data_ptr(), depth_order.data_ptr(),
                f_sem.data_ptr(), C, tile_start.data_ptr(),
                fwd_out.data_ptr(), fmap.data_ptr(), gfmap.data_ptr(),
                dgeo.data_ptr(), dgeo.stride(0), out.data_ptr(),
                cfg.num_tiles, cfg.tiles_x, cfg.height, cfg.width, cfg.tile,
                cfg.pair_block, *common, ctypes.c_float(1.0 - cfg.alpha_max),
                ctypes.c_float(cfg.transmittance_min), *margins, stream)
    if err != 0:
        raise RuntimeError(f"raster_feat launch failed: CUDA error {err}")
    if fmap is None:
        composite_features.launches += 1
    else:
        composite_features.bwd_launches += 1
    return out


def feat_resources(device, pair_block: int = 128) -> dict:
    """F1's and F2's registers, local (spill) bytes and resident CTAs per
    SM at ``pair_block`` on the CUDA ``device``."""
    from ._build import load_library

    lib = load_library("raster_feat")
    out = (ctypes.c_int * 6)()
    with torch.cuda.device(device):
        err = lib.feat_resources(pair_block, out)
    if err != 0:
        raise RuntimeError(f"feat_resources failed: CUDA error {err}")
    return {name: {"registers": out[3 * i], "local_bytes": out[3 * i + 1],
                   "ctas_per_sm": out[3 * i + 2]}
            for i, name in enumerate(("F1", "F2"))}

"""Instruction-class ablations of the forward compositor (K1): the Hopper
kernels and their plain PyTorch versions.

Counterpart of four of the bodies that ``scripts/profile_kernel.py`` times
through ``run_variant`` (its ``pallas_call`` at ``:365``). Each takes one
class of work out of K1 (``raster_cuda.composite_pairs``), so that K1's
time minus the variant's reads off that class's cost on the card:

* ``empty`` (``_kernel_empty``, ``:222``): no feature is read and nothing
  is computed; T stays 1. The launch and per-CTA floor.
* ``no-compute`` (``_kernel_no_compute``, ``:173``): each block's feature
  rows are staged as K1 stages them, and only row 0 (u) is reduced:
  ``T = 1 + sum over the tile's blocks of sum_j u_j``, with NO skip rule.
  The reduction order is fixed (see :func:`_block_sum`).
* ``no-transc`` (``_kernel_no_transc``, ``:50``): K1 with the
  transcendentals replaced by cheap arithmetic: ``g = 1 / (1 + q/2)`` where
  ``q <= chi2_clip``, ``s = -alpha``, ``T_excl = (1 + (cum_incl - s)) T_in``
  with ``cum_incl`` the block's running sum of s, and the block's outgoing
  ``T = T_in (1 + sum s)``.
* ``no-mxu`` (``_kernel_no_mxu``, ``:145``): K1's alpha (with exp) but no
  per-pair transmittance: ``w = alpha T_in`` where ``T_in > T_min``, and the
  block's outgoing ``T = T_in exp(sum log1p(-alpha))``. On Hopper this
  removes K1's dependent per-pair T chain (there is no matrix unit in K1).

``no-transc`` and ``no-mxu`` skip a continuation block when the tile's
largest T is ``<= transmittance_min`` (K1's ``__syncthreads_or`` rule). The
TPU bodies gate on ``first | max(T_in) > T_min`` and ignore the dead bit;
that is K1's rule on a layout with no dead blocks, which the profiler's
workload is.

Output ``[num_tiles, 8, tile*tile]`` f32 for every variant. Rows 0-3 are
the sums of ``w * (r, g, b, depth)`` (zero for ``empty`` and
``no-compute``), row 4 the final T. The TPU bodies write only rows 0-4
(``empty`` and ``no-compute`` only row 4) and leave tiles with no block
unwritten; interpret mode fills what is unwritten with NaN. Here every row
is defined: row 5 is the number of blocks composited, as K1's row 5 is
(0 for ``empty``), rows 6-7 are 0, and a tile with no block gets T = 1 and
zeros, as in K1.

:func:`ablate` chooses by the tensors' device: CPU tensors take
:func:`ablate_plain`; CUDA tensors launch the kernel
(``csrc/raster_ablate.cu``) and count it in ``ablate.launches[variant]``,
or raise.
"""

from __future__ import annotations

import ctypes

import torch

from ..config import RenderConfig
from .raster_cuda import (FEAT_ROWS, _block_alpha, _check_inputs,
                          _check_kernel_args, _running_sum, _tile_pixels)

# Variant name -> the kernel's template argument (raster_ablate.cu).
VARIANTS = {"empty": 0, "no-compute": 1, "no-transc": 2, "no-mxu": 3}
WARP = 32


def _check_variant(variant):
    if variant not in VARIANTS:
        raise ValueError(f"unknown ablation {variant!r}; ported: "
                         f"{', '.join(VARIANTS)}")


def _block_sum(x):
    """Sum of each row of x [m, G] in the kernel's order: lane l of a warp
    adds x[l], x[l+32], x[l+64], ... in turn, then five xor-shuffle steps
    (16, 8, 4, 2, 1) add the lanes; every lane ends with the same float
    (each step adds the same two values on both lanes). Returns [m]."""
    m, G = x.shape
    if G % WARP:
        raise ValueError(f"pair_block must be a multiple of {WARP} for "
                         f"no-compute (got {G})")
    cols = x.reshape(m, G // WARP, WARP)
    s = cols[:, 0]
    for r in range(1, G // WARP):
        s = s + cols[:, r]
    lane = torch.arange(WARP, device=x.device)
    for off in (16, 8, 4, 2, 1):
        s = s + s[:, lane ^ off]
    return s[:, 0]


def _rational_alpha(f, px, py, cfg: RenderConfig):
    """no-transc's alpha [m, G, P]: K1's with exp(-q/2) replaced by
    1 / (1 + q/2), in the kernel's order of operations."""
    u, v, ca, cb, cc, op = (f[r][:, :, None] for r in range(6))
    du = px[:, None, :] - u
    dv = py[:, None, :] - v
    q = ca * du * du + 2.0 * cb * du * dv + cc * dv * dv
    g = torch.where(q <= cfg.chi2_clip, torch.reciprocal(1.0 + 0.5 * q), 0.0)
    a = torch.clamp(op * g, max=cfg.alpha_max)
    return torch.where(a >= cfg.alpha_cutoff, a, 0.0)


def ablate_plain(variant, pair_feat, tile_start, tile_count,
                 cfg: RenderConfig, tile_chunk: int = 0):
    """Plain PyTorch version of the ablation ``variant`` (any device).

    Walks the blocks as :func:`raster_cuda.composite_pairs_plain` does, all
    tiles of a chunk at once, and evaluates every per-(pair, pixel) term in
    the kernel's order with sequential running sums (cumulative ops along a
    non-innermost dimension), so on the card it rounds as the kernel does.
    ``tile_chunk`` > 0 bounds memory to that many tiles at a time.
    """
    _check_variant(variant)
    dev = pair_feat.device
    G = cfg.pair_block
    P = cfg.tile * cfg.tile
    num_tiles = tile_start.shape[0]
    f32 = torch.float32
    out = torch.zeros(num_tiles, 8, P, dtype=f32, device=dev)
    out[:, 4] = 1.0
    if variant == "empty":
        return out
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
            if k > 0 and variant != "no-compute":
                go &= T.amax(dim=1) > cfg.transmittance_min
            idx = torch.nonzero(go).squeeze(1)
            if idx.numel() == 0:
                break
            pcol = start[idx, None] + k * G + cols  # [m, G]
            if variant == "no-compute":
                T[idx] = T[idx] + _block_sum(pair_feat[0, pcol])[:, None]
                cnt[idx] += 1.0
                k += 1
                continue
            f = pair_feat[:FEAT_ROWS, pcol]  # [10, m, G]
            T_in = T[idx]  # [m, P]
            zero = torch.zeros_like(T_in)
            if variant == "no-transc":
                alpha = _rational_alpha(f, px[idx], py[idx], cfg)
                s = -alpha
                incl = _running_sum(zero, s)  # [m, G, P]
                T_excl = (1.0 + (incl - s)) * T_in[:, None, :]
                w = torch.where(T_excl > cfg.transmittance_min,
                                alpha * T_excl, 0.0)
                T[idx] = T_in * (1.0 + incl[:, G - 1])
            else:  # no-mxu
                alpha = _block_alpha(f, px[idx], py[idx], cfg)[0]
                w = torch.where(T_in[:, None, :] > cfg.transmittance_min,
                                alpha * T_in[:, None, :], 0.0)
                logs = _running_sum(zero, torch.log1p(-alpha))[:, G - 1]
                T[idx] = T_in * torch.exp(logs)
            for ch in range(4):
                acc[idx, ch] = _running_sum(
                    acc[idx, ch], w * f[6 + ch][:, :, None])[:, G - 1]
            cnt[idx] += 1.0
            k += 1
        out[tiles, 0:4] = acc
        out[tiles, 4] = T
        out[tiles, 5] = cnt[:, None]
    return out


def ablate(variant, pair_feat, tile_start, tile_count, cfg: RenderConfig):
    """The ablation ``variant`` of K1 on the pair list (arguments as
    :func:`raster_cuda.composite_pairs`; output as the module docstring).

    CPU tensors take :func:`ablate_plain`. CUDA tensors launch the kernel
    and count it in ``ablate.launches[variant]``; anything the kernel does
    not take raises.
    """
    _check_variant(variant)
    _check_inputs(pair_feat, tile_start, tile_count, cfg)
    if pair_feat.device.type == "cpu":
        return ablate_plain(variant, pair_feat, tile_start, tile_count, cfg)
    _check_kernel_args(cfg, pair_feat=pair_feat, tile_start=tile_start,
                       tile_count=tile_count)
    from ._build import load_library

    lib = load_library("raster_ablate")
    out = torch.empty(cfg.num_tiles, 8, cfg.tile * cfg.tile,
                      dtype=torch.float32, device=pair_feat.device)
    with torch.cuda.device(pair_feat.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.raster_ablate(
            VARIANTS[variant], pair_feat.data_ptr(), pair_feat.shape[1],
            pair_feat.stride(0), tile_start.data_ptr(), tile_count.data_ptr(),
            out.data_ptr(), cfg.num_tiles, cfg.tiles_x, cfg.pair_block,
            ctypes.c_float(cfg.chi2_clip), ctypes.c_float(cfg.alpha_max),
            ctypes.c_float(cfg.alpha_cutoff),
            ctypes.c_float(cfg.transmittance_min), stream,
        )
    if err != 0:
        raise RuntimeError(
            f"raster_ablate ({variant}) launch failed: CUDA error {err}")
    ablate.launches[variant] += 1
    return out


ablate.launches = {v: 0 for v in VARIANTS}  # kernel launches per variant

"""Instruction-class ablations and alternative designs of the forward
compositor (K1): the Hopper kernels and their plain PyTorch versions.

Counterpart of the eight bodies besides ``full`` that
``scripts/profile_kernel.py`` times through ``run_variant`` (its
``pallas_call`` at ``:365``). The first five take one class of work out of
K1 (``raster_cuda.composite_pairs``), so that K1's time minus the variant's
reads off that class's cost on the card:

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
* ``no-input`` (``_kernel_no_input``, ``:184``): K1's arithmetic on iota
  features, row r of pair j of every block being ``j * 1e-3 + r`` (f32), with
  log-space transmittance: ``s = log1p(-alpha)``, ``T_excl = exp(cum_incl -
  s) T_in``, outgoing ``T = T_in exp(sum s)``. ``pair_feat`` is never read.
  With these features alpha is non-zero only near pixel (0, 0): every other
  tile composites its blocks with alpha = 0 everywhere.

The other three compute K1's function another way (alternative designs of
K1; :data:`K1_FUNCTION`):

* ``cumprod`` (``_kernel_cumprod``, ``:90``): ``T_excl = (within * gpre) *
  T_in``, ``within`` the exclusive product of ``1 - alpha`` inside each group
  of 8 pairs, ``gpre`` the exclusive product of the group totals; outgoing
  ``T = T_in * (product of all group totals)``.
* ``pg-roll`` and ``pg-log`` (``_kernel_pg``, ``:231``): the TPU body's
  matrix form, pixels on the rows of a tensor-core product and pairs on
  its reduction axis, 8 pairs a k-step (:data:`PG_CHUNK`; lane quad q
  of the fragments holds pairs 2q, 2q+1 of a step). ``roll``: each
  lane's two ``1 - alpha`` multiplied, a two-step scan over the quad,
  and T before the step (``T_in`` times the earlier steps' totals, in
  order) times the lane's exclusive prefix. ``log``: the inclusive prefix
  of ``s = log1p(-alpha)`` within the step as a product with the
  inclusive triangular mask in two TF32 passes (``s = s_hi + s_lo``,
  :func:`tf32_split_plain`), the running sum of the earlier steps added
  in f32, ``T_excl = exp(cum - s) T_in``. The channel sums: w and the
  colours split into TF32 hi and lo parts, accumulated k-step by k-step
  (hi.hi + hi.lo in 4 columns, lo.hi + lo.lo in 4 more, added at the
  block's end). :func:`_pg_block` is that arithmetic; the tensor cores'
  own sums do not follow IEEE order, so kernel and plain version agree
  within tolerance, not bit for bit.

``no-transc``, ``no-mxu``, ``no-input``, ``cumprod`` and ``pg-*`` skip a
continuation block when the tile's largest T is ``<= transmittance_min``
(K1's ``__syncthreads_or`` rule). The TPU bodies gate on ``first | max(T_in)
> T_min`` and ignore the dead bit; that is K1's rule on a layout with no
dead blocks, which the profiler's workload is.

Output ``[num_tiles, 8, tile*tile]`` f32 for every variant. Rows 0-3 are
the sums of ``w * (r, g, b, depth)`` (zero for ``empty`` and
``no-compute``), row 4 the final T. The TPU bodies write only rows 0-4
(``empty`` and ``no-compute`` only row 4; the pg bodies rows 5-7 from a
scratch they never set) and leave tiles with no block unwritten; interpret
mode fills what is unwritten with NaN. Here every row is defined: row 5 is
the number of blocks composited, as K1's row 5 is (0 for ``empty``), rows
6-7 are 0, and a tile with no block gets T = 1 and zeros, as in K1.

The kernels (``csrc/raster_ablate.cu``): the six :data:`K1_BODIES` are
K1's own kernel (``csrc/raster_fwd_kernel.cuh``) with another body, so each
walks as K1 does (tiles heaviest first, pair-major staging, 8x4-pixel
warps, the per-warp pair cull) minus one class of work. A body culls only
(pair, warp) whose alpha under its own definition is exactly 0 at the
warp's 32 pixels (no-transc with its own threshold, :data:`CULLS`), so
the cull changes no value of the function above: no-input, which reads
no feature, culls nothing and walks every pair; empty and no-compute walk
none. pg-roll and pg-log keep their own template (tensor cores, every
(pair, pixel), no cull).

:func:`ablate` chooses by the tensors' device: CPU tensors take
:func:`ablate_plain`; CUDA tensors launch the kernel and count it in
``ablate.launches[variant]``, or raise.
"""

from __future__ import annotations

import ctypes

import torch

from ..config import RenderConfig
from .raster_cuda import (CULL_KAPPA_MIN, CULL_MARGIN_ABS, CULL_MARGIN_EPS,
                          CULL_MARGIN_REL, FEAT_ROWS, _block_alpha,
                          _check_inputs, _check_kernel_args, _rational_alpha,
                          _running_sum, _tile_pixels)

# Variant name -> the kernel's template argument (raster_ablate.cu).
VARIANTS = {"empty": 0, "no-compute": 1, "no-transc": 2, "no-mxu": 3,
            "no-input": 4, "cumprod": 5, "pg-roll": 6, "pg-log": 7}
# The variants that compute K1's function (composite_pairs_plain's).
K1_FUNCTION = ("cumprod", "pg-roll", "pg-log")
# The variants built from K1's own kernel (csrc/raster_fwd_kernel.cuh), K1
# minus one class of work; pg-roll and pg-log have their own template, on
# tensor cores, and compute every (pair, pixel) of a composited block.
K1_BODIES = ("empty", "no-compute", "no-transc", "no-mxu", "no-input",
             "cumprod")
PG_VARIANTS = ("pg-roll", "pg-log")
# The bodies that walk only the (pair, warp) their cull reaches: K1's cull
# (raster_cuda.pair_warp_reach), no-transc's for its own alpha
# (rational=True). Their kernels count what they skip, as K1's does.
CULLS = {"no-transc": True, "no-mxu": False, "cumprod": False}
# The tile and largest pair block the kernels take.
ABLATE_TILE, ABLATE_MAX_G = 16, 256
WARP = 32
CUMPROD_GROUP = 8  # pairs per group of the two-level product
PG_CHUNK = 8  # pairs per k-step of the pg kernels' m16n8k8 products


def _check_variant(variant):
    if variant not in VARIANTS:
        raise ValueError(f"unknown ablation {variant!r}; known: "
                         f"{', '.join(VARIANTS)}")


def _check_lanes(G):
    if G % WARP:
        raise ValueError(f"pair_block must be a multiple of {WARP} for "
                         f"no-compute and pg-* (got {G})")


def _block_sum(x):
    """Sum of each row of x [m, G] in the kernel's order: lane l of a warp
    adds x[l], x[l+32], x[l+64], ... in turn, then five xor-shuffle steps
    (16, 8, 4, 2, 1) add the lanes; every lane ends with the same float
    (each step adds the same two values on both lanes). Returns [m]."""
    m, G = x.shape
    _check_lanes(G)
    cols = x.reshape(m, G // WARP, WARP)
    s = cols[:, 0]
    for r in range(1, G // WARP):
        s = s + cols[:, r]
    lane = torch.arange(WARP, device=x.device)
    for off in (16, 8, 4, 2, 1):
        s = s + s[:, lane ^ off]
    return s[:, 0]


def tf32_round(x):
    """x (f32) rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it: to the
    nearest, ties away from zero, as an f32 whose low 13 mantissa bits are
    zero (on the bits: add 0x1000, clear the low 13). NaN and Inf pass
    through; a finite x that rounds past the largest TF32 becomes Inf."""
    bits = x.view(torch.int32)
    rounded = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return torch.where(torch.isfinite(x), rounded, x)


def tf32_split_plain(x):
    """(hi, lo), each TF32: hi = :func:`tf32_round` (x), lo = tf32_round(x
    - hi), so hi + lo is x to about 2^-22 of |x| (any device)."""
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


def _pg_prefix_roll(alpha, T_in):
    """pg-roll's (T_excl, T_out) for alpha [m, P, K, 8] (K k-steps of 8
    pairs) and T_in [m, P], in the kernel's association: lane q's two
    factors 1 - alpha multiplied, an inclusive scan of those over the four
    lanes in two steps (lane q takes lane q-1's, then q-2's, on the
    left), its exclusive prefix, and T before each k-step the sequential
    product of T_in and the earlier k-steps' totals."""
    m, P, K, _ = alpha.shape
    keep = 1.0 - alpha
    x = keep[..., 0::2] * keep[..., 1::2]  # [m, P, K, 4]: lane q's product
    x = torch.cat([x[..., :1], x[..., :-1] * x[..., 1:]], dim=-1)
    x = torch.cat([x[..., :2], x[..., :-2] * x[..., 2:]], dim=-1)
    before = torch.cat([torch.ones_like(x[..., :1]), x[..., :-1]], dim=-1)
    run = torch.cumprod(torch.cat([T_in[:, None], x[..., 3].transpose(1, 2)],
                                  dim=1), dim=1)  # [m, K + 1, P], in order
    first = run[:, :-1].transpose(1, 2)[..., None] * before
    T_excl = torch.stack([first, first * keep[..., 0::2]], dim=-1)
    return T_excl.reshape(m, P, K, PG_CHUNK), run[:, -1]


def _pg_prefix_log(alpha, T_in):
    """pg-log's (T_excl, T_out) for alpha [m, P, K, 8] and T_in [m, P]: s =
    log1p(-alpha); within each k-step the inclusive prefix of s_hi plus
    that of s_lo, each summed in order (the two products with the
    triangular mask); cum = S + prefix with S the running sum of the
    earlier k-steps' last cum, from 0; T_excl = exp(cum - s) T_in, T_out =
    T_in exp(S after the last)."""
    s = torch.log1p(-alpha)
    hi, lo = tf32_split_plain(s)
    pre = [hi[..., 0] + lo[..., 0]]
    run_hi, run_lo = hi[..., 0], lo[..., 0]
    for j in range(1, PG_CHUNK):  # in order, on every device
        run_hi, run_lo = run_hi + hi[..., j], run_lo + lo[..., j]
        pre.append(run_hi + run_lo)
    pre = torch.stack(pre, dim=-1)
    # S before each k-step: a sequential running sum (cumulative op along
    # a non-innermost dimension), [m, K + 1, P].
    S = torch.cumsum(torch.cat([torch.zeros_like(T_in)[:, None],
                                pre[..., -1].transpose(1, 2)], dim=1), dim=1)
    cum = S[:, :-1].transpose(1, 2)[..., None] + pre
    T_excl = torch.exp(cum - s) * T_in[:, :, None, None]
    return T_excl, T_in * torch.exp(S[:, -1])


def _iota_features(G, m, dev):
    """no-input's features [10, m, G]: row r of pair j is j * 1e-3 + r in
    f32, as the TPU body and the kernel form them."""
    j = torch.arange(G, dtype=torch.float32, device=dev) * 1e-3
    rows = torch.arange(FEAT_ROWS, dtype=torch.float32, device=dev)
    return (j[None, :] + rows[:, None])[:, None, :].expand(FEAT_ROWS, m, G)


def _cumprod_transmittance(alpha, T_in):
    """cumprod's (T_excl [m, G, P], T_out [m, P]) for alpha [m, G, P]: the
    within-group products and the group prefix, each a sequential product
    starting at 1, as the kernel keeps them."""
    m, G, P = alpha.shape
    mg = (1.0 - alpha).reshape(m, G // CUMPROD_GROUP, CUMPROD_GROUP, P)
    ones = torch.ones_like(mg[:, :, :1])
    within = torch.cumprod(torch.cat([ones, mg[:, :, :-1]], dim=2), dim=2)
    gtot = within[:, :, -1] * mg[:, :, -1]  # [m, K, P]
    gpre = torch.cumprod(torch.cat([ones[:, :1, 0], gtot], dim=1), dim=1)
    T_excl = (within * gpre[:, :-1, None, :]).reshape(m, G, P) \
        * T_in[:, None, :]
    return T_excl, T_in * gpre[:, -1]


def _block_weights(variant, f, px, py, T_in, cfg: RenderConfig):
    """(w [m, G, P], outgoing T [m, P]) of one block for the variants that
    walk the pairs in order: no-transc, no-mxu, no-input and cumprod."""
    G = f.shape[2]
    zero = torch.zeros_like(T_in)
    if variant == "no-transc":
        alpha = _rational_alpha(f, px, py, cfg)
        s = -alpha
        incl = _running_sum(zero, s)  # [m, G, P]
        T_excl = (1.0 + (incl - s)) * T_in[:, None, :]
        T_out = T_in * (1.0 + incl[:, G - 1])
    elif variant == "no-mxu":
        alpha = _block_alpha(f, px, py, cfg)[0]
        T_excl = T_in[:, None, :]  # w = alpha T_in where T_in > T_min
        logs = _running_sum(zero, torch.log1p(-alpha))[:, G - 1]
        T_out = T_in * torch.exp(logs)
    elif variant == "no-input":
        alpha = _block_alpha(f, px, py, cfg)[0]
        s = torch.log1p(-alpha)
        incl = _running_sum(zero, s)
        T_excl = torch.exp(incl - s) * T_in[:, None, :]
        T_out = T_in * torch.exp(incl[:, G - 1])
    else:  # cumprod
        alpha = _block_alpha(f, px, py, cfg)[0]
        T_excl, T_out = _cumprod_transmittance(alpha, T_in)
    w = torch.where(T_excl > cfg.transmittance_min, alpha * T_excl, 0.0)
    return w, T_out


def _pg_block(variant, f, px, py, T_in, cfg: RenderConfig):
    """(the block's channel sums [m, 4, P], outgoing T [m, P]) for pg-roll
    and pg-log, in the kernels' arithmetic: T by :func:`_pg_prefix_roll`
    or :func:`_pg_prefix_log`, w = alpha T_excl where T_excl > T_min, and
    the sums of the tensor-core products, k-step by k-step: D += w_hi B,
    D += w_lo B with B = [hi | lo of the colours] (8 columns; each
    product's 8 pairs in order), then hi columns + lo columns."""
    G = f.shape[2]
    _check_lanes(G)
    alpha = _block_alpha(f, px, py, cfg)[0].transpose(1, 2)  # [m, P, G]
    m, P, _ = alpha.shape
    K = G // PG_CHUNK
    alpha = alpha.reshape(m, P, K, PG_CHUNK)
    prefix = _pg_prefix_roll if variant == "pg-roll" else _pg_prefix_log
    T_excl, T_out = prefix(alpha, T_in)
    w = torch.where(T_excl > cfg.transmittance_min, alpha * T_excl, 0.0)
    col = f[6:10].permute(1, 2, 0).reshape(m, 1, K, PG_CHUNK, 4)
    B = torch.cat(tf32_split_plain(col), dim=-1)  # [m, 1, K, 8, 8]
    prods = []
    for part in tf32_split_plain(w):  # [m, P, K, 8]
        d = part[..., 0, None] * B[..., 0, :]
        for k in range(1, PG_CHUNK):
            d = d + part[..., k, None] * B[..., k, :]
        prods.append(d)  # [m, P, K, 8]
    D = torch.zeros_like(prods[0][:, :, 0])
    for k in range(K):
        D = (D + prods[0][:, :, k]) + prods[1][:, :, k]
    return (D[..., :4] + D[..., 4:]).transpose(1, 2), T_out


def ablate_plain(variant, pair_feat, tile_start, tile_count,
                 cfg: RenderConfig, tile_chunk: int = 0):
    """Plain PyTorch version of the ablation ``variant`` (any device).

    Walks the blocks as :func:`raster_cuda.composite_pairs_plain` does, all
    tiles of a chunk at once, and evaluates every per-(pair, pixel) term in
    the kernel's order with sequential running sums and products
    (cumulative ops along a non-innermost dimension) or, for pg-*, the
    kernel's scan and reduction order, so on the card it rounds as the
    kernel does. ``no-input`` never reads ``pair_feat``. ``tile_chunk`` > 0
    bounds memory to that many tiles at a time.
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
            elif variant in PG_VARIANTS:
                sums, T[idx] = _pg_block(variant, pair_feat[:FEAT_ROWS, pcol],
                                         px[idx], py[idx], T[idx], cfg)
                acc[idx] = acc[idx] + sums
            else:
                f = _iota_features(G, idx.numel(), dev) \
                    if variant == "no-input" else pair_feat[:FEAT_ROWS, pcol]
                w, T[idx] = _block_weights(variant, f, px[idx], py[idx],
                                           T[idx], cfg)
                for ch in range(4):
                    acc[idx, ch] = _running_sum(
                        acc[idx, ch], w * f[6 + ch][:, :, None])[:, G - 1]
            cnt[idx] += 1.0
            k += 1
        out[tiles, 0:4] = acc
        out[tiles, 4] = T
        out[tiles, 5] = cnt[:, None]
    return out


def ablate(variant, pair_feat, tile_start, tile_count, cfg: RenderConfig,
           skipped=None):
    """The ablation ``variant`` of K1 on the pair list (arguments as
    :func:`raster_cuda.composite_pairs`; output as the module docstring).

    CPU tensors take :func:`ablate_plain`. CUDA tensors launch the kernel
    and count it in ``ablate.launches[variant]``; anything the kernel does
    not take raises (tile 16, ``pair_block`` a multiple of 32 up to 256).
    ``skipped``: None, or a [1] int64 tensor on the card to which the
    bodies of :data:`CULLS` add the (pair, warp) their cull skipped.
    """
    _check_variant(variant)
    _check_inputs(pair_feat, tile_start, tile_count, cfg)
    if pair_feat.device.type == "cpu":
        return ablate_plain(variant, pair_feat, tile_start, tile_count, cfg)
    _check_kernel_args(cfg, pair_feat=pair_feat, tile_start=tile_start,
                       tile_count=tile_count)
    if cfg.tile != ABLATE_TILE or cfg.pair_block > ABLATE_MAX_G:
        raise ValueError(
            f"the ablation kernels take tile {ABLATE_TILE} and a pair_block "
            f"up to {ABLATE_MAX_G} (got tile {cfg.tile}, pair_block "
            f"{cfg.pair_block})")
    if skipped is not None and (skipped.dtype != torch.int64
                                or skipped.device != pair_feat.device
                                or skipped.numel() != 1):
        raise ValueError("skipped must be one int64 on pair_feat's device")
    from ._build import load_library

    lib = load_library("raster_ablate")
    dev = pair_feat.device
    out = torch.empty(cfg.num_tiles, 8, cfg.tile * cfg.tile,
                      dtype=torch.float32, device=dev)
    order = torch.empty(cfg.num_tiles, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.raster_ablate(
            VARIANTS[variant], pair_feat.data_ptr(), pair_feat.shape[1],
            pair_feat.stride(0), tile_start.data_ptr(), tile_count.data_ptr(),
            order.data_ptr(), out.data_ptr(),
            None if skipped is None else skipped.data_ptr(), cfg.num_tiles,
            cfg.tiles_x, cfg.tile, cfg.pair_block,
            ctypes.c_float(cfg.chi2_clip), ctypes.c_float(cfg.alpha_max),
            ctypes.c_float(cfg.alpha_cutoff),
            ctypes.c_float(cfg.transmittance_min),
            ctypes.c_float(CULL_MARGIN_REL), ctypes.c_float(CULL_MARGIN_EPS),
            ctypes.c_float(CULL_MARGIN_ABS), ctypes.c_float(CULL_KAPPA_MIN),
            stream,
        )
    if err != 0:
        raise RuntimeError(
            f"raster_ablate ({variant}) launch failed: CUDA error {err}")
    ablate.launches[variant] += 1
    return out


ablate.launches = {v: 0 for v in VARIANTS}  # kernel launches per variant


def tf32_split(x):
    """:func:`tf32_split_plain` of a contiguous f32 tensor, on a CUDA tensor
    by the pg kernels' own rounding (a probe kernel in
    ``csrc/raster_ablate.cu``, counted in ``tf32_split.launches``), on a
    CPU tensor by the plain version."""
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("tf32_split takes a contiguous float32 tensor")
    if x.device.type == "cpu":
        return tf32_split_plain(x)
    from ._build import load_library

    lib = load_library("raster_ablate")
    hi, lo = torch.empty_like(x), torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = lib.raster_ablate_tf32_split(
            x.data_ptr(), hi.data_ptr(), lo.data_ptr(), x.numel(),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"tf32_split launch failed: CUDA error {err}")
    tf32_split.launches += 1
    return hi, lo


tf32_split.launches = 0


def pg_resources(variant, device) -> dict:
    """The pg kernel's resources on the CUDA ``device``: registers, static
    shared bytes, local bytes a thread (spills) and resident CTAs per SM
    (``cudaFuncGetAttributes`` and the occupancy API)."""
    if variant not in PG_VARIANTS:
        raise ValueError(f"pg_resources takes pg-roll or pg-log, not "
                         f"{variant!r}")
    from ._build import load_library

    lib = load_library("raster_ablate")
    vals = (ctypes.c_int * 4)()
    with torch.cuda.device(device):
        err = lib.raster_ablate_pg_resources(VARIANTS[variant], vals)
    if err != 0:
        raise RuntimeError(f"raster_ablate_pg_resources failed: CUDA error "
                           f"{err}")
    return dict(zip(("registers", "shared_bytes", "local_bytes",
                     "ctas_per_sm"), vals))

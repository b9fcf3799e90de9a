"""Surfel compositing (2D Gaussian Splatting, Huang et al. 2024): the Hopper
kernels S1 and S2 and their plain PyTorch versions.

The pairs are binning's (``ops.binning``: tile-major, front to back by
the surfel's centre depth, each tile's run from ``tile_start``, padding
slots -1). A pair's row is read by its surfel, ``rows[pair_slot[j]]``,
from the depth-ordered table ``rows`` ``[N, ROW_STRIDE]`` whose first
``SURFEL_ROWS`` columns are ``ops.surfel``'s (``T_u``, ``T_v``, ``T_w``,
centre ``c``, opacity, rgb, normal; zero for an invalid surfel) and the
rest zero. At pixel ``(x, y)`` (integer coordinates):

* ``k = x T_w - T_u``, ``l = y T_w - T_v``, ``p = k x l``; no hit where
  ``p_2 = 0``, else ``s = (p_0 / p_2, p_1 / p_2)``,
  ``rho3 = s . s``, ``rho2 = F |c - (x, y)|^2`` (``F`` the low-pass
  ``filter_inv_square``);
* ``rho = min(rho3, rho2)``; the depth is ``s_0 T_w0 + s_1 T_w1 + T_w2``
  where ``rho3 <= rho2``, else the centre's ``T_w2``; no hit nearer than
  ``dist_near``;
* ``alpha = min(op exp(-rho / 2), alpha_max)``, zeroed below
  ``alpha_cutoff``;
* ``w = alpha T_excl`` while ``T_excl > transmittance_min`` (the product
  of ``1 - alpha`` over the pairs in front), else 0;
* ``m = far / (far - near) (1 - near / z)`` (``dist_near``, ``dist_far``).

S1's output ``[num_tiles, OUT_ROWS, tile*tile]`` f32, each a sum over the
tile's pairs in list order: rows 0-2 ``sum w rgb``, 3 ``sum w z``, 4
``A = sum w`` (the alpha map), 5-7 ``sum w n``, 8 the distortion ``sum_i
w_i (m_i^2 A_i + M2_i - 2 m_i M1_i)`` with ``A_i``, ``M1_i = sum_{j<i} w_j
m_j``, ``M2_i = sum_{j<i} w_j m_j^2`` the sums in front, 9 ``M1``, 10
``M2`` (of every pair), 11 the index past the last pair with a non-zero
weight (from the tile's start; 0 where none). The distortion's sums take
``m - m0`` for ``m``, with ``m0`` the pixel's first contributing pair's
``m``: the distortion is unchanged by the shift (it is ``sum_{j<i} w_i
w_j (m_i - m_j)^2``), and where a pixel's ``m`` are close (about 1, their
differences about 1e-2) the sums that cancel in ``m^2 A + M2 - 2 m M1``
and ``A M2 - M1^2`` stay small; rows 9-10 hold the shifted sums.

S2 takes the cotangent ``gout`` of rows 0-8 and gives per pair the
gradient of ``T_u``, ``T_v``, ``T_w`` (9), ``c`` (2), opacity, rgb (3) and
normal (3), ``[SURFEL_ROWS, pairs]`` (zero for the pairs it does not
reach). With ``gw_i = gC . rgb_i + gZ z_i + gA + gN . n_i + gD (m_i^2 A +
M2 - 2 m_i M1)`` (``A``, ``M1``, ``M2`` the pixel's totals: the exact
derivative of the distortion by ``w_i``) and ``gS_i = sum_{j>i} w_j
gw_j`` (the pixel's total ``gC . C + gZ Z + gA A + gN . N + 2 gD (A M2 -
M1^2)`` less the running sum),

    d alpha_i = [alive] (gw_i T_excl - gS_i / max(1 - alpha_i, 1 -
    alpha_max)),

gated where ``op exp(-rho/2) < alpha_max``; ``d z_i = w_i gZ + 2 gD w_i
(m_i A - M1) far near / ((far - near) z_i^2)``, ``d rgb_i = w_i gC``,
``d n_i = w_i gN``, and ``d alpha`` and ``d z`` carried back through the
intersection to ``T`` and ``c``.

The kernels' per-warp pair cull (``csrc/raster_surfel.cu``) skips a
(pair, warp) only where no pixel of the warp's 8x4 patch can reach the
alpha cutoff: :func:`surfel_warp_reach` is its plain version, exact by
construction (module test: every dropped (pair, warp) has alpha 0 at its
32 pixels).

S1 equals :func:`composite_surfels_plain` bit for bit on the card (the
same sums in the same order, ``-fmad=false``). S2 sums each pair's
per-pixel terms over the tile's warps in a fixed order: deterministic,
but not the plain version's order, so equal to it within rounding.

Scope: tile 16, ``transmittance_math="cumprod"``, one view at a time (no
``view_tile_rows``), the rect cull, no truncation, no compacted backward,
no 2D filter (``aa_mode="none"``), the kernel compositor; :func:`check_config`
raises otherwise, on either device.
"""

from __future__ import annotations

import ctypes

import torch

from ..config import RenderConfig, SurfelConfig
from . import raster_cuda as rc
from .surfel import SURFEL_ROWS

ROW_STRIDE = 20  # floats a row of the kernels' table (16-byte rows)
OUT_ROWS = 12
WARP_W, WARP_H = rc.WARP_W, rc.WARP_H  # K1's 8x4-pixel warps
TILE = 16
# The cull's margins: on rho_max (relative, absolute) and on the boxes
# (pixels, relative to the box's coordinates), and the least -d / T_w2^2
# for which the disc's box is trusted.
REACH_RHO_REL = 1e-3
REACH_RHO_ABS = 1e-3
REACH_PIX_ABS = 0.5
REACH_PIX_REL = 2e-3
REACH_D_MIN = 1e-3


def check_config(cfg: RenderConfig):
    """Raise ``ValueError`` unless the surfel compositors take ``cfg``
    (module docstring)."""
    why = []
    if cfg.tile != TILE:
        why.append(f"tile {TILE} (got {cfg.tile})")
    if cfg.transmittance_math != "cumprod":
        why.append(f"transmittance_math='cumprod' (got "
                   f"{cfg.transmittance_math!r})")
    if cfg.view_tile_rows:
        why.append("one view at a time (batched views are not supported)")
    if cfg.bwd_pairs:
        why.append("bwd_pairs=0 (the compacted backward is not supported)")
    if cfg.cull_mode != "rect":
        why.append(f"cull_mode='rect' (got {cfg.cull_mode!r})")
    if cfg.tile_rank_cap:
        why.append("tile_rank_cap=0 (truncation is not supported)")
    if cfg.aa_mode != "none":
        why.append(f"aa_mode='none': surfels carry their own low-pass "
                   f"filter (got {cfg.aa_mode!r})")
    if cfg.backend not in ("auto", "pallas"):
        why.append(f"the kernel compositor, backend 'auto' or 'pallas' "
                   f"(got {cfg.backend!r})")
    if why:
        raise ValueError("surfel compositing takes " + "; ".join(why))


def table(rows: torch.Tensor) -> torch.Tensor:
    """The kernels' ``[N, ROW_STRIDE]`` table of ``[N, SURFEL_ROWS]`` rows
    (zero columns after)."""
    return torch.nn.functional.pad(rows, (0, ROW_STRIDE - rows.shape[1])
                                   ).contiguous()


def _consts(cfg: RenderConfig, sc: SurfelConfig) -> dict:
    """The float32 constants both versions use, each rounded once."""
    f32 = lambda v: float(torch.tensor(v, dtype=torch.float32))  # noqa: E731
    return {"F": f32(sc.filter_inv_square), "near": f32(sc.dist_near),
            "kf": f32(sc.dist_far / (sc.dist_far - sc.dist_near)),
            "kd": f32(sc.dist_far * sc.dist_near
                      / (sc.dist_far - sc.dist_near))}


def _pair_rows(tab, pair_slot, pcol):
    """[m, G, ROW_STRIDE] rows of pair columns ``pcol`` [m, G] (zero at
    padding)."""
    slot = pair_slot.to(torch.int64)[pcol]
    r = tab[torch.clamp(slot, 0)]
    return torch.where((slot >= 0)[..., None], r, 0.0)


def _hit(r, px, py, cfg: RenderConfig, k: dict):
    """The per-(pair, pixel) terms of rows ``r`` [m, G, ROW_STRIDE] at
    pixels [m, P], in the kernels' order of operations: a dict of
    ``alpha`` (after the cutoff), ``a_raw``, ``g``, ``z``, ``use3``,
    ``s0``, ``s1``, ``p2``, ``k`` and ``l`` (3 each), ``dx``, ``dy``."""
    col = lambda i: r[..., i][..., None]  # noqa: E731  [m, G, 1]
    X = px[:, None, :]
    Y = py[:, None, :]
    k0 = X * col(6) - col(0)
    k1 = X * col(7) - col(1)
    k2 = X * col(8) - col(2)
    l0 = Y * col(6) - col(3)
    l1 = Y * col(7) - col(4)
    l2 = Y * col(8) - col(5)
    p0 = k1 * l2 - k2 * l1
    p1 = k2 * l0 - k0 * l2
    p2 = k0 * l1 - k1 * l0
    ok = p2 != 0.0
    q = torch.where(ok, p2, 1.0)
    s0 = p0 / q
    s1 = p1 / q
    rho3 = s0 * s0 + s1 * s1
    dx = col(9) - X
    dy = col(10) - Y
    rho2 = k["F"] * (dx * dx + dy * dy)
    use3 = rho3 <= rho2
    rho = torch.where(use3, rho3, rho2)
    z = torch.where(use3, s0 * col(6) + s1 * col(7) + col(8), col(8))
    g = torch.exp(-0.5 * rho)
    a_raw = col(11) * g
    a = torch.clamp(a_raw, max=cfg.alpha_max)
    keep = ok & (z >= k["near"]) & (a >= cfg.alpha_cutoff)
    return {"alpha": torch.where(keep, a, 0.0), "a_raw": a_raw, "g": g,
            "z": torch.where(keep, z, 1.0), "use3": use3, "s0": s0,
            "s1": s1, "p2": q, "k": (k0, k1, k2), "l": (l0, l1, l2),
            "dx": dx, "dy": dy}


def _m(z, k: dict):
    """The distortion's depth map ``kf (1 - near / z)``, its division a
    true one (PyTorch takes a number over a tensor as a reciprocal times
    the number)."""
    return k["kf"] * (1.0 - torch.full_like(z, k["near"]) / z)


def _shifted_m(on, z, k: dict, m0, has0, idx):
    """``m - m0`` [m, G, P] where ``on`` (0 elsewhere), ``m0`` the pixel's
    first contributing pair's ``m``: ``m0`` and ``has0`` [tiles, P] are
    carried from block to block and updated in place at rows ``idx``."""
    mr = torch.where(on, _m(z, k), 0.0)
    first = torch.gather(mr, 1, on.to(torch.int8).argmax(dim=1)[:, None])
    new = ~has0[idx] & on.any(dim=1)
    m0[idx] = torch.where(new, first[:, 0], m0[idx])
    has0[idx] = has0[idx] | new
    return torch.where(on, mr - m0[idx][:, None, :], 0.0)


def _excl(start, run):
    """The exclusive prefixes [m, G, P] of inclusive ``run`` from
    ``start`` [m, P]."""
    return torch.cat([start[:, None, :], run[:, :-1]], dim=1)


def _blocks(tile_start, tile_count, n_pairs, cfg: RenderConfig, tiles):
    """For k = 0, 1, ...: (the positions in ``tiles`` of those with a k-th
    block inside the list, their pair columns [m, G], the in-tile index of
    each column)."""
    G = cfg.pair_block
    dev = tile_start.device
    start = tile_start.to(torch.int64)[tiles]
    nb = (tile_count.to(torch.int64)[tiles] + G - 1) // G
    cols = torch.arange(G, device=dev)
    k = 0
    while True:
        go = (k < nb) & (start + (k + 1) * G <= n_pairs)
        idx = torch.nonzero(go).squeeze(1)
        if idx.numel() == 0:
            return
        yield idx, start[idx, None] + k * G + cols, k * G + cols
        k += 1


def _past_count(pcol_local, count):
    """[m, G, 1] True where a column lies past its tile's pair count."""
    return (pcol_local[None, :] >= count[:, None])[..., None]


def composite_surfels_plain(tab, pair_slot, tile_start, tile_count,
                            cfg: RenderConfig, sc: SurfelConfig,
                            tile_chunk: int = 0):
    """Plain PyTorch S1 (any device): ``[num_tiles, OUT_ROWS, P]``.

    Walks each tile's blocks in order, all tiles of a chunk at once; T is
    a sequential product and every sum a sequential running sum over the
    pairs in list order (cumulative ops along a non-innermost dimension,
    which PyTorch evaluates in order), as S1 adds them."""
    dev = tab.device
    P = TILE * TILE
    f32 = torch.float32
    k = _consts(cfg, sc)
    n_pairs = pair_slot.shape[0]
    num_tiles = tile_start.shape[0]
    out = torch.zeros(num_tiles, OUT_ROWS, P, dtype=f32, device=dev)
    chunk = tile_chunk if tile_chunk > 0 else max(num_tiles, 1)
    for c0 in range(0, num_tiles, chunk):
        tiles = torch.arange(c0, min(c0 + chunk, num_tiles), device=dev)
        px, py = rc._tile_pixels(tiles, cfg)
        T = torch.ones(tiles.shape[0], P, dtype=f32, device=dev)
        acc = torch.zeros(tiles.shape[0], OUT_ROWS, P, dtype=f32, device=dev)
        m0 = torch.zeros(tiles.shape[0], P, dtype=f32, device=dev)
        has0 = torch.zeros(tiles.shape[0], P, dtype=torch.bool, device=dev)
        count = tile_count.to(torch.int64)[tiles]
        for idx, pcol, local in _blocks(tile_start, tile_count, n_pairs,
                                        cfg, tiles):
            r = _pair_rows(tab, pair_slot, pcol)
            r = torch.where(_past_count(local, count[idx]), 0.0, r)
            h = _hit(r, px[idx], py[idx], cfg, k)
            alpha = h["alpha"]
            T_excl, T_out = rc._block_transmittance(alpha, T[idx], cfg)
            w = torch.where(T_excl > cfg.transmittance_min, alpha * T_excl,
                            0.0)
            on = w != 0.0
            m = _shifted_m(on, h["z"], k, m0, has0, idx)
            a = acc[idx]
            for ch in range(3):
                a[:, ch] = rc._running_sum(
                    a[:, ch], w * r[..., 12 + ch][..., None])[:, -1]
                a[:, 5 + ch] = rc._running_sum(
                    a[:, 5 + ch], w * r[..., 15 + ch][..., None])[:, -1]
            a[:, 3] = rc._running_sum(a[:, 3], w * h["z"])[:, -1]
            A = rc._running_sum(a[:, 4], w)
            wm = torch.where(on, w * m, 0.0)
            M1 = rc._running_sum(a[:, 9], wm)
            M2 = rc._running_sum(a[:, 10], torch.where(on, wm * m, 0.0))
            Ai, M1i, M2i = (_excl(a[:, r_], run) for r_, run in
                            ((4, A), (9, M1), (10, M2)))
            term = torch.where(on, w * (m * m * Ai + M2i - 2.0 * m * M1i),
                               0.0)
            a[:, 8] = rc._running_sum(a[:, 8], term)[:, -1]
            a[:, 4], a[:, 9], a[:, 10] = A[:, -1], M1[:, -1], M2[:, -1]
            last = torch.where(on, (local + 1).to(f32)[None, :, None], 0.0)
            a[:, 11] = torch.maximum(a[:, 11], last.amax(dim=1))
            acc[idx] = a
            T[idx] = T_out
        out[tiles] = acc
    return out


def composite_surfels_bwd_plain(tab, pair_slot, tile_start, tile_count,
                                fwd_out, gout, cfg: RenderConfig,
                                sc: SurfelConfig, tile_chunk: int = 0):
    """Plain PyTorch S2 (any device): ``[SURFEL_ROWS, pairs]`` (module
    docstring), each tile walked from its start with T and the running
    ``sum w gw`` carried."""
    dev = tab.device
    P = TILE * TILE
    f32 = torch.float32
    k = _consts(cfg, sc)
    n_pairs = pair_slot.shape[0]
    num_tiles = tile_start.shape[0]
    d = torch.zeros(SURFEL_ROWS, n_pairs, dtype=f32, device=dev)
    one_minus_max = 1.0 - cfg.alpha_max
    chunk = tile_chunk if tile_chunk > 0 else max(num_tiles, 1)
    for c0 in range(0, num_tiles, chunk):
        tiles = torch.arange(c0, min(c0 + chunk, num_tiles), device=dev)
        px, py = rc._tile_pixels(tiles, cfg)
        o = fwd_out[tiles]
        g = gout[tiles]
        A, M1, M2 = o[:, 4], o[:, 9], o[:, 10]
        Stot = (g[:, 0] * o[:, 0] + g[:, 1] * o[:, 1] + g[:, 2] * o[:, 2]
                + g[:, 3] * o[:, 3] + g[:, 4] * A + g[:, 5] * o[:, 5]
                + g[:, 6] * o[:, 6] + g[:, 7] * o[:, 7]
                + 2.0 * g[:, 8] * (A * M2 - M1 * M1))
        T = torch.ones(tiles.shape[0], P, dtype=f32, device=dev)
        run = torch.zeros(tiles.shape[0], P, dtype=f32, device=dev)
        m0 = torch.zeros(tiles.shape[0], P, dtype=f32, device=dev)
        has0 = torch.zeros(tiles.shape[0], P, dtype=torch.bool, device=dev)
        count = tile_count.to(torch.int64)[tiles]
        for idx, pcol, local in _blocks(tile_start, tile_count, n_pairs,
                                        cfg, tiles):
            r = _pair_rows(tab, pair_slot, pcol)
            r = torch.where(_past_count(local, count[idx]), 0.0, r)
            h = _hit(r, px[idx], py[idx], cfg, k)
            alpha = h["alpha"]
            T_excl, T_out = rc._block_transmittance(alpha, T[idx], cfg)
            alive = T_excl > cfg.transmittance_min
            on = alive & (alpha > 0.0)
            w = torch.where(on, alpha * T_excl, 0.0)
            z = h["z"]
            m = _shifted_m(on, z, k, m0, has0, idx)
            gi = g[idx][:, :, None, :]  # [m, 12, 1, P]
            col = lambda i: r[..., i][..., None]  # noqa: E731
            gw = (gi[:, 0] * col(12) + gi[:, 1] * col(13)
                  + gi[:, 2] * col(14) + gi[:, 3] * z + gi[:, 4]
                  + gi[:, 5] * col(15) + gi[:, 6] * col(16)
                  + gi[:, 7] * col(17)
                  + gi[:, 8] * (m * m * A[idx][:, None]
                                + M2[idx][:, None]
                                - 2.0 * m * M1[idx][:, None]))
            gw = torch.where(on, gw, 0.0)
            runs = rc._running_sum(run[idx], w * gw)
            gS = Stot[idx][:, None, :] - runs
            om = torch.clamp(1.0 - alpha, min=one_minus_max)
            dalpha = torch.where(on, gw * T_excl - gS / om, 0.0)
            ga = torch.where(on & (h["a_raw"] < cfg.alpha_max), dalpha, 0.0)
            op = col(11)
            d_op = ga * h["g"]
            d_rho = ga * op * h["g"] * (-0.5)
            dz = torch.where(on, w * gi[:, 3] + 2.0 * gi[:, 8] * w * (
                m * A[idx][:, None] - M1[idx][:, None]) * k["kd"]
                / (z * z), 0.0)
            use3 = h["use3"]
            s0, s1 = h["s0"], h["s1"]
            z3 = torch.where(use3, dz, 0.0)
            d_s0 = torch.where(use3, 2.0 * s0 * d_rho + dz * col(6), 0.0)
            d_s1 = torch.where(use3, 2.0 * s1 * d_rho + dz * col(7), 0.0)
            d_r2 = torch.where(use3, 0.0, d_rho) * (2.0 * k["F"])
            dp0 = d_s0 / h["p2"]
            dp1 = d_s1 / h["p2"]
            dp2 = -(d_s0 * s0 + d_s1 * s1) / h["p2"]
            k0, k1, k2 = h["k"]
            l0, l1, l2 = h["l"]
            dk = (l1 * dp2 - l2 * dp1, l2 * dp0 - l0 * dp2,
                  l0 * dp1 - l1 * dp0)
            dl = (dp1 * k2 - dp2 * k1, dp2 * k0 - dp0 * k2,
                  dp0 * k1 - dp1 * k0)
            X = px[idx][:, None, :]
            Y = py[idx][:, None, :]
            parts = [-dk[0], -dk[1], -dk[2], -dl[0], -dl[1], -dl[2],
                     X * dk[0] + Y * dl[0] + z3 * s0,
                     X * dk[1] + Y * dl[1] + z3 * s1,
                     X * dk[2] + Y * dl[2] + dz,
                     d_r2 * h["dx"], d_r2 * h["dy"], d_op,
                     w * gi[:, 0], w * gi[:, 1], w * gi[:, 2],
                     w * gi[:, 5], w * gi[:, 6], w * gi[:, 7]]
            d[:, pcol] = torch.stack([torch.sum(x, dim=2) for x in parts])
            run[idx] = runs[:, -1]
            T[idx] = T_out
    return d


def surfel_warp_reach(r, tiles, cfg: RenderConfig, sc: SurfelConfig):
    """The kernels' per-warp cull for rows ``r`` [m, G, ROW_STRIDE] of
    pairs in tiles ``tiles`` [m]: [m, G, warps] bool, False where no pixel
    of the warp's 8x4 patch can reach ``alpha_cutoff``, in the kernels'
    order of operations.

    ``op exp(-rho / 2)`` reaches the cutoff only where ``rho <= rho_max =
    2 ln(op / cutoff)``, widened by ``REACH_RHO_REL`` and ``_ABS``. Then
    ``rho2 <= rho_max`` is a disc about ``c``, and ``rho3 <= rho_max`` the
    projection of the surfel's disc of radius ``sqrt(rho_max)``: an
    ellipse where the disc lies in front of the camera (``d = rho_max
    (T_w0^2 + T_w1^2) - T_w2^2 < 0``), whose bounding box comes from the
    disc's dual conic (``ops.surfel``'s footprint, at that radius). Each
    box is widened by ``REACH_PIX_ABS`` pixels plus ``REACH_PIX_REL`` of
    its coordinates' size; a (pair, warp) is reached where either box
    meets the warp's patch. Where ``d > -REACH_D_MIN T_w2^2`` (the disc
    reaches near the camera plane) or a box is not finite, every warp is
    reached."""
    k = _consts(cfg, sc)
    col = lambda i: r[..., i]  # noqa: E731
    op = col(11)
    can = op >= cfg.alpha_cutoff
    rho = 2.0 * torch.log(torch.where(can, op, 1.0) / cfg.alpha_cutoff)
    rho = rho * (1.0 + REACH_RHO_REL) + REACH_RHO_ABS
    # the low-pass disc
    rl = torch.sqrt(rho / k["F"])
    rl = rl + REACH_PIX_ABS + REACH_PIX_REL * (
        torch.abs(col(9)) + torch.abs(col(10)) + rl)
    lx0, lx1 = col(9) - rl, col(9) + rl
    ly0, ly1 = col(10) - rl, col(10) + rl
    # the ellipse
    w0, w1, w2 = col(6), col(7), col(8)
    d = rho * (w0 * w0 + w1 * w1) - w2 * w2
    trust = d < -REACH_D_MIN * (w2 * w2)
    dd = torch.where(trust, d, -1.0)
    cx = (rho * (col(0) * w0 + col(1) * w1) - col(2) * w2) / dd
    cy = (rho * (col(3) * w0 + col(4) * w1) - col(5) * w2) / dd
    hx = cx * cx - (rho * (col(0) * col(0) + col(1) * col(1))
                    - col(2) * col(2)) / dd
    hy = cy * cy - (rho * (col(3) * col(3) + col(4) * col(4))
                    - col(5) * col(5)) / dd
    hx = torch.sqrt(torch.clamp(hx, min=0.0))
    hy = torch.sqrt(torch.clamp(hy, min=0.0))
    hx = hx + REACH_PIX_ABS + REACH_PIX_REL * (torch.abs(cx) + hx)
    hy = hy + REACH_PIX_ABS + REACH_PIX_REL * (torch.abs(cy) + hy)
    ex0, ex1, ey0, ey1 = cx - hx, cx + hx, cy - hy, cy + hy
    fin = (torch.isfinite(ex0) & torch.isfinite(ex1) & torch.isfinite(ey0)
           & torch.isfinite(ey1))
    every = can & ~(trust & fin)
    # the warps' patches
    wx, wy = rc._warp_origins(TILE, r.device)
    ox = ((tiles % cfg.tiles_x) * TILE)[:, None] + wx[None, :]  # [m, W]
    oy = ((tiles // cfg.tiles_x) * TILE)[:, None] + wy[None, :]
    X0 = ox.to(torch.float32)[:, None, :]
    Y0 = oy.to(torch.float32)[:, None, :]
    X1 = X0 + (WARP_W - 1)
    Y1 = Y0 + (WARP_H - 1)

    def meets(x0, x1, y0, y1):
        return ((x0[..., None] <= X1) & (x1[..., None] >= X0)
                & (y0[..., None] <= Y1) & (y1[..., None] >= Y0))

    hit = meets(lx0, lx1, ly0, ly1) | (fin[..., None]
                                       & meets(ex0, ex1, ey0, ey1))
    return can[..., None] & (every[..., None] | hit)


def _check_tensors(tab, pair_slot, tile_start, tile_count, cfg, **more):
    check_config(cfg)
    if tab.dtype != torch.float32 or tab.dim() != 2 \
            or tab.shape[1] != ROW_STRIDE:
        raise ValueError(f"the row table must be [N, {ROW_STRIDE}] "
                         f"float32, got {tuple(tab.shape)} {tab.dtype}")
    want = {"pair_slot": ((pair_slot.shape[0],), torch.int32),
            "tile_start": ((cfg.num_tiles,), torch.int32),
            "tile_count": ((cfg.num_tiles,), torch.int32),
            "fwd_out": ((cfg.num_tiles, OUT_ROWS, TILE * TILE),
                        torch.float32),
            "gout": ((cfg.num_tiles, OUT_ROWS, TILE * TILE), torch.float32)}
    for name, a in dict(pair_slot=pair_slot, tile_start=tile_start,
                        tile_count=tile_count, **more).items():
        shape, dtype = want[name]
        if tuple(a.shape) != shape or a.dtype != dtype:
            raise ValueError(f"{name} must be {list(shape)} {dtype}, got "
                             f"{tuple(a.shape)} {a.dtype}")
        if a.device != tab.device:
            raise ValueError(f"{name} is on {a.device}, the table on "
                             f"{tab.device}")
    if tab.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {tab.device}")


def composite_surfels(tab, pair_slot, tile_start, tile_count,
                      cfg: RenderConfig, sc: SurfelConfig):
    """S1's output (module docstring): the kernel on CUDA tensors (counted
    in ``composite_surfels.launches``), :func:`composite_surfels_plain`
    on CPU tensors. ``tab`` [N, ROW_STRIDE] is the depth-ordered table
    (:func:`table`), ``pair_slot``, ``tile_start``, ``tile_count`` the
    binning's (int32)."""
    _check_tensors(tab, pair_slot, tile_start, tile_count, cfg)
    if tab.device.type == "cpu":
        return composite_surfels_plain(tab, pair_slot, tile_start,
                                       tile_count, cfg, sc)
    return _launch(tab, pair_slot, tile_start, tile_count, cfg, sc)


def composite_surfels_bwd(tab, pair_slot, tile_start, tile_count, fwd_out,
                          gout, cfg: RenderConfig, sc: SurfelConfig):
    """S2's per-pair gradients ``[SURFEL_ROWS, pairs]`` for the cotangent
    ``gout`` of S1's output ``fwd_out``: the kernel on CUDA tensors
    (counted in ``composite_surfels.bwd_launches``),
    :func:`composite_surfels_bwd_plain` on CPU tensors."""
    _check_tensors(tab, pair_slot, tile_start, tile_count, cfg,
                   fwd_out=fwd_out, gout=gout)
    if tab.device.type == "cpu":
        return composite_surfels_bwd_plain(tab, pair_slot, tile_start,
                                           tile_count, fwd_out, gout, cfg,
                                           sc)
    return _launch(tab, pair_slot, tile_start, tile_count, cfg, sc,
                   fwd_out=fwd_out, gout=gout)


composite_surfels.launches = 0  # S1 launches
composite_surfels.bwd_launches = 0  # S2 launches


class _Consts(ctypes.Structure):
    """``csrc/raster_surfel.cu``'s ``Consts``, by reference."""
    _fields_ = [("alpha_max", ctypes.c_float),
                ("alpha_cutoff", ctypes.c_float),
                ("one_minus_max", ctypes.c_float),
                ("t_min", ctypes.c_float), ("F", ctypes.c_float),
                ("near", ctypes.c_float), ("kf", ctypes.c_float),
                ("kd", ctypes.c_float),
                ("rho_rel", ctypes.c_float), ("rho_abs", ctypes.c_float),
                ("pix_abs", ctypes.c_float), ("pix_rel", ctypes.c_float),
                ("d_min", ctypes.c_float), ("pair_block", ctypes.c_int)]


def _pack(cfg: RenderConfig, sc: SurfelConfig) -> _Consts:
    k = _consts(cfg, sc)
    return _Consts(cfg.alpha_max, cfg.alpha_cutoff, 1.0 - cfg.alpha_max,
                   cfg.transmittance_min, k["F"], k["near"], k["kf"],
                   k["kd"], REACH_RHO_REL,
                   REACH_RHO_ABS, REACH_PIX_ABS, REACH_PIX_REL, REACH_D_MIN,
                   cfg.pair_block)


def _launch(tab, pair_slot, tile_start, tile_count, cfg: RenderConfig,
            sc: SurfelConfig, fwd_out=None, gout=None):
    """S1 (``gout`` None: returns its output) or S2 (returns the per-pair
    gradients)."""
    from ._build import load_library

    for name, a in (("tab", tab), ("pair_slot", pair_slot),
                    ("tile_start", tile_start), ("tile_count", tile_count),
                    ("fwd_out", fwd_out), ("gout", gout)):
        if a is not None and not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    n_pairs = pair_slot.shape[0]
    if n_pairs * SURFEL_ROWS >= 2**31:
        raise ValueError(f"{n_pairs} pairs exceed the kernel's int32 index")
    lib = load_library("raster_surfel")
    dev = tab.device
    consts = _pack(cfg, sc)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        if gout is None:
            out = torch.empty(cfg.num_tiles, OUT_ROWS, TILE * TILE,
                              dtype=torch.float32, device=dev)
            err = lib.surfel_fwd(
                tab.data_ptr(), pair_slot.data_ptr(), n_pairs,
                tile_start.data_ptr(), tile_count.data_ptr(),
                out.data_ptr(), cfg.num_tiles, cfg.tiles_x,
                ctypes.byref(consts), stream)
        else:
            out = torch.zeros(SURFEL_ROWS, n_pairs, dtype=torch.float32,
                              device=dev)
            err = lib.surfel_bwd(
                tab.data_ptr(), pair_slot.data_ptr(), n_pairs,
                tile_start.data_ptr(), tile_count.data_ptr(),
                fwd_out.data_ptr(), gout.data_ptr(), out.data_ptr(),
                cfg.num_tiles, cfg.tiles_x, ctypes.byref(consts), stream)
    if err != 0:
        raise RuntimeError(f"raster_surfel launch failed: CUDA error {err}")
    if gout is None:
        composite_surfels.launches += 1
    else:
        composite_surfels.bwd_launches += 1
    return out


def surfel_resources(device) -> dict:
    """S1's and S2's registers, local (spill) bytes and resident CTAs per
    SM on the CUDA ``device``."""
    from ._build import load_library

    lib = load_library("raster_surfel")
    out = (ctypes.c_int * 6)()
    with torch.cuda.device(device):
        err = lib.surfel_resources(out)
    if err != 0:
        raise RuntimeError(f"surfel_resources failed: CUDA error {err}")
    return {name: {"registers": out[3 * i], "local_bytes": out[3 * i + 1],
                   "ctas_per_sm": out[3 * i + 2]}
            for i, name in enumerate(("S1", "S2"))}

"""Plain PyTorch reference of a 2D Gaussian Splatting frame and training
step (Huang, Yu, Chen, Geiger, Gao, "2D Gaussian Splatting for
Geometrically Accurate Radiance Fields", SIGGRAPH 2024,
arXiv:2403.17888).

A surfel has a centre ``p``, a rotation ``R`` from its normalised
quaternion (tangents ``t_u``, ``t_v``, normal ``t_w``: its columns), two
scales ``exp(scale_raw)``, opacity ``sigmoid(opacity_raw)`` and SH colour
as in 3DGS. Its points are ``P(u, v) = p + s_u t_u u + s_v t_v v``, its
value ``G(u, v) = exp(-(u^2 + v^2) / 2)``. With ``W`` the world-to-pixel
map (intrinsics times view), ``M = W [s_u t_u, s_v t_v, p]`` maps ``(u, v,
1)`` to homogeneous pixels; its rows are ``T_u``, ``T_v``, ``T_w``.

* Ray-splat intersection (the paper's eq. 9-10, as the authors' code
  computes it): for pixel ``(x, y)``, ``k = x T_w - T_u``, ``l = y T_w -
  T_v``, ``(u, v) = (k x l)_{0,1} / (k x l)_2``; its depth ``T_w . (u, v,
  1)``.
* Low-pass filter (eq. 11): ``G^ = max(G(u, v), exp(-F |x - c|^2 / 2))``
  with ``F = 2`` (``sigma = sqrt(2)/2``, the authors' ``FilterInvSquare``);
  where the filter wins the depth is the centre's.
* Footprint: the authors' ``compute_aabb`` at 3 sigma: ``c`` the centre of
  the projected disc's bounding box, a square pixel radius
  ``ceil(max(half widths, 3 / sqrt(F)))``, binned into tiles by
  ``render.py``'s rectangle rule.
* Compositing front to back in the binned depth order with
  ``render.py``'s alpha rules (``alpha_max``, ``alpha_cutoff``,
  ``transmittance_min``), ``alpha = o G^``, ``w_i = alpha_i T_i``: five
  maps, ``rgb``, the alpha ``A = sum w``, the expected depth ``sum w z /
  sum w``, the normal ``N = sum w n`` (``n = +-t_w`` turned to face the
  camera, in camera space), and the distortion ``D = sum_i w_i (m_i^2
  A_i + M2_i - 2 m_i M1_i)`` over the prefix sums ``A_i = sum_{j<i}
  w_j``, ``M1_i = sum_{j<i} w_j m_j``, ``M2_i = sum_{j<i} w_j m_j^2`` with
  ``m = f / (f - n) (1 - n / z)``, ``n = 0.2``, ``f = 100``; the sums
  take ``m - m0``, ``m0`` the pixel's first contributing pair's ``m`` (the
  distortion, ``sum_{j<i} w_i w_j (m_i - m_j)^2``, does not change, and
  the terms that cancel stay small).
* Loss: ``0.8 L1 + 0.2 D-SSIM + lambda_d mean(D) + lambda_n mean(1 -
  N . N_d)``, ``N_d`` the normals of the expected depth map (unprojected
  with the intrinsics, central differences, cross product, normalised,
  zero on the border) times the detached alpha map.

Departures from the paper, each the authors' code's choice or a
benchmark's need:

* the distortion is the authors' code's squared form of the paper's
  ``sum_ij w_i w_j |z_i - z_j|`` in the mapped depth ``m``;
* the surface depth is the expected depth (``depth_ratio = 0``, the
  authors' advice for unbounded scenes); the median depth is not used;
* both geometric terms are on from step 0 (the authors turn them on at
  iterations 3,000 and 7,000): the window stands for a step past 7,000;
* the renderer's rules are the port's (``render.py``: rectangle binning,
  ``alpha_cutoff`` 1/128, ``transmittance_min`` 5e-5 with the pair that
  crosses it kept), not the authors' CUDA rasterizer's (1/255, 1e-4);
  an intersection nearer than ``n`` adds nothing (the authors' code);
* a surfel whose 3-sigma disc reaches behind the camera plane, or whose
  normal is perpendicular to the view ray, is culled;
* normals are compared in camera space (the authors' in world space: the
  same dot product).

Everything is float32 by default, with TF32 off in every function that
renders, and every function takes a ``dtype``: float32 is the reference,
a lower precision the control. It imports nothing of the program: only
torch and ``reference/render.py``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from . import render as ref

SIGMA_CUT = 3.0  # the footprint's compute_aabb cutoff
GRAD_BUDGET = 2**24  # (pair slot, pixel) entries a chunk under autograd
FRAME_BUDGET = 2**26


@dataclass(frozen=True)
class Surfels:
    """2DGS's constants: the low-pass filter's ``1 / sigma^2``, the
    distortion's depth range and the two loss weights."""

    filter_inv_square: float = 2.0
    dist_near: float = 0.2
    dist_far: float = 100.0
    lambda_dist: float = 100.0
    lambda_normal: float = 0.05

    @classmethod
    def from_config(cls, render: dict, train: dict | None = None):
        names = cls.__dataclass_fields__
        got = {k: v for k, v in {**render, **(train or {})}.items()
               if k in names}
        return cls(**got)


def _tf32_off():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _rotmat(q_raw):
    q = q_raw / (torch.linalg.vector_norm(q_raw, dim=-1, keepdim=True) + 1e-9)
    x, y, z, w = q.unbind(-1)
    return [[1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]]


def project(params: dict, alive, cam: ref.Camera, rnd: ref.Renderer,
            sf: Surfels, dtype):
    """Every surfel's screen-space row: a dict of ``rows`` [N, 18] (T_u,
    T_v, T_w, c, opacity, rgb, normal; zero where invalid), ``depth``,
    ``valid`` and the tile rectangle ``rect`` [N, 4] int64, as
    ``render.bin_pairs`` reads them."""
    dev = params["pos"].device
    p = {k: v.to(dtype) for k, v in params.items()}
    c2w = torch.as_tensor(cam.c2w, dtype=torch.float32, device=dev).to(dtype)
    R, t = c2w[:3, :3], c2w[:3, 3]
    H, W = cam.height, cam.width
    fx, fy, cx, cy = cam.fx, cam.fy, cam.cx, cam.cy

    opacity = torch.clamp(torch.sigmoid(p["opacity_raw"]), 0.0, 0.999)
    valid = opacity >= rnd.alpha_cutoff * 0.5
    if alive is not None:
        valid = valid & alive
    d = p["pos"] - t[None, :]
    x = d[:, 0] * R[0, 0] + d[:, 1] * R[1, 0] + d[:, 2] * R[2, 0]
    y = d[:, 0] * R[0, 1] + d[:, 1] * R[1, 1] + d[:, 2] * R[2, 1]
    z = d[:, 0] * R[0, 2] + d[:, 1] * R[1, 2] + d[:, 2] * R[2, 2]
    g = rnd.pix_guard
    valid = valid & (z > 0) & (z > rnd.near) & (z < rnd.far)
    valid = valid & (fx * x > z * (-g - cx)) & (fx * x < z * (W + g - cx))
    valid = valid & (fy * y > z * (-g - cy)) & (fy * y < z * (H + g - cy))
    valid = valid & torch.isfinite(x) & torch.isfinite(y) & torch.isfinite(z)
    x = torch.where(valid, x, 0.0)
    y = torch.where(valid, y, 0.0)
    z = torch.where(valid, z, 1.0)

    rot = _rotmat(p["q_raw"])
    s = torch.clamp(torch.exp(p["scale_raw"]), min=1e-6)

    def cam_vec(col):  # R^T of the world vector rot[:, col]
        v = [rot[j][col] for j in range(3)]
        return [v[0] * R[0, k] + v[1] * R[1, k] + v[2] * R[2, k]
                for k in range(3)]

    tu, tv, tw = cam_vec(0), cam_vec(1), cam_vec(2)
    au = [a * s[:, 0] for a in tu]
    av = [a * s[:, 1] for a in tv]
    Tu = [fx * au[0] + cx * au[2], fx * av[0] + cx * av[2], fx * x + cx * z]
    Tv = [fy * au[1] + cy * au[2], fy * av[1] + cy * av[2], fy * y + cy * z]
    Tw = [au[2], av[2], z]
    cos = -(x * tw[0] + y * tw[1] + z * tw[2])
    valid = valid & (cos != 0.0)
    sign = torch.where(cos > 0.0, 1.0, -1.0).to(dtype)
    normal = [a * sign for a in tw]

    r2 = SIGMA_CUT * SIGMA_CUT
    dd = r2 * (Tw[0] * Tw[0] + Tw[1] * Tw[1]) - Tw[2] * Tw[2]
    valid = valid & (dd < 0.0) & torch.isfinite(dd)
    dd = torch.where(valid, dd, -1.0)
    f0, f2 = r2 / dd, -1.0 / dd
    cu = f0 * (Tu[0] * Tw[0] + Tu[1] * Tw[1]) + f2 * Tu[2] * Tw[2]
    cv = f0 * (Tv[0] * Tw[0] + Tv[1] * Tw[1]) + f2 * Tv[2] * Tw[2]

    with torch.no_grad():  # integer footprint: no gradient path
        hx = cu * cu - (f0 * (Tu[0] * Tu[0] + Tu[1] * Tu[1])
                        + f2 * Tu[2] * Tu[2])
        hy = cv * cv - (f0 * (Tv[0] * Tv[0] + Tv[1] * Tv[1])
                        + f2 * Tv[2] * Tv[2])
        ext = torch.sqrt(torch.clamp(torch.maximum(hx, hy).float(),
                                     min=1e-4))
        rad = torch.ceil(torch.clamp(
            ext, min=SIGMA_CUT / math.sqrt(sf.filter_inv_square)))
        fu, fv = cu.float(), cv.float()
        valid = valid & torch.isfinite(rad) & torch.isfinite(fu) \
            & torch.isfinite(fv)
        fu = torch.where(valid, fu, 0.0)
        fv = torch.where(valid, fv, 0.0)
        rad = torch.where(valid, rad, 0.0)
        umin, umax = torch.floor(fu - rad), torch.floor(fu + rad)
        vmin, vmax = torch.floor(fv - rad), torch.floor(fv + rad)
        valid = valid & (umax >= 0) & (umin < W) & (vmax >= 0) & (vmin < H)

        def pix(a, hi):
            return torch.clamp(torch.where(valid, a, 0.0), 0, hi).to(
                torch.int64)

        T = rnd.tile
        rect = torch.stack([pix(umin, W - 1) // T, pix(vmin, H - 1) // T,
                            pix(umax, W - 1) // T, pix(vmax, H - 1) // T], -1)
        rect[:, 2:] = torch.where(valid[:, None], rect[:, 2:], rect[:, :2] - 1)

    rgb = ref.sh_colors(p["f_dc"], p["f_rest"], p["pos"], t)
    rows = torch.stack([*Tu, *Tv, *Tw, cu, cv, opacity, rgb[:, 0], rgb[:, 1],
                        rgb[:, 2], *normal], dim=-1)
    rows = torch.where(valid[:, None], rows, 0.0)
    return {"rows": rows, "depth": z, "valid": valid, "rect": rect}


MAPS = 9  # rgb 3, sum w z, sum w, sum w n 3, distortion


def composite_chunk(rows, bn: ref.Binning, tiles, K: int, rnd: ref.Renderer,
                    sf: Surfels, count_work: bool = False):
    """Composite the pairs of ``tiles`` (each with at most K pairs) front to
    back, ``render.SUB`` pairs at a time, stopping once every pixel of the
    chunk is saturated. ``rows`` [V, 18] of the visible surfels in depth
    order. Returns (maps [m, P, MAPS], with ``count_work`` the [3] counts
    of ``render.composite_chunk``; else None)."""
    dev, dtype = rows.device, rows.dtype
    tile = rnd.tile
    P = tile * tile
    m = tiles.shape[0]
    px, py = ref._tile_pixels(tiles, bn, tile, dtype)
    start, cnt = bn.start[tiles], bn.count[tiles]
    Tc = torch.ones(m, P, dtype=dtype, device=dev)
    acc = torch.zeros(m, P, MAPS, dtype=dtype, device=dev)
    M1 = torch.zeros(m, P, dtype=dtype, device=dev)
    M2 = torch.zeros(m, P, dtype=dtype, device=dev)
    m0 = torch.zeros(m, P, dtype=dtype, device=dev)
    has0 = torch.zeros(m, P, dtype=torch.bool, device=dev)
    kf =sf.dist_far / (sf.dist_far - sf.dist_near)
    work = torch.zeros(3, dtype=torch.int64, device=dev) if count_work \
        else None
    for k0 in range(0, K, ref.SUB):
        j = k0 + torch.arange(min(ref.SUB, K - k0), device=dev)
        ok = j[None, :] < cnt[:, None]  # [m, k]
        idx = torch.where(ok, start[:, None] + j[None, :], 0)
        f = rows[bn.gauss[idx]]  # [m, k, 18]

        def c(i):
            return f[..., i:i + 1]

        X = px[:, None, :]
        Y = py[:, None, :]
        k_ = (X * c(6) - c(0), X * c(7) - c(1), X * c(8) - c(2))
        l_ = (Y * c(6) - c(3), Y * c(7) - c(4), Y * c(8) - c(5))
        p0 = k_[1] * l_[2] - k_[2] * l_[1]
        p1 = k_[2] * l_[0] - k_[0] * l_[2]
        p2 = k_[0] * l_[1] - k_[1] * l_[0]
        hit = p2 != 0.0
        q = torch.where(hit, p2, 1.0)
        su, sv = p0 / q, p1 / q
        rho3 = su * su + sv * sv
        dx, dy = c(9) - X, c(10) - Y
        rho2 = sf.filter_inv_square * (dx * dx + dy * dy)
        use3 = rho3 <= rho2
        rho = torch.where(use3, rho3, rho2)
        z = torch.where(use3, su * c(6) + sv * c(7) + c(8), c(8))
        a = torch.clamp(c(11) * torch.exp(-0.5 * rho), max=rnd.alpha_max)
        keep = (hit & (z >= sf.dist_near) & (a >= rnd.alpha_cutoff)
                & ok[..., None])
        a = torch.where(keep, a, 0.0)
        z = torch.where(keep, z, 1.0)
        prod = torch.cumprod(torch.cat([Tc[:, None, :], 1.0 - a], dim=1),
                             dim=1)
        t_ex = prod[:, :-1]
        live = t_ex > rnd.transmittance_min
        w = torch.where(live, a * t_ex, 0.0)  # [m, k, P]
        on = w != 0.0
        mr = torch.where(on, kf * (1.0 - sf.dist_near / z), 0.0)
        # the shift m0: the pixel's first contributing pair's m (a constant
        # of the distortion's, which the shift does not change)
        first = torch.gather(mr.detach(), 1,
                             on.to(torch.int8).argmax(dim=1)[:, None])[:, 0]
        new = ~has0 & on.any(dim=1)
        m0 = torch.where(new, first, m0)
        has0 = has0 | new
        mm = torch.where(on, mr - m0[:, None, :], 0.0)
        wm = w * mm
        # exclusive prefix sums of w, w m, w m^2 from the carries
        A_ex = acc[..., 4][:, None, :] + torch.cumsum(w, dim=1) - w
        M1_ex = M1[:, None, :] + torch.cumsum(wm, dim=1) - wm
        M2_ex = M2[:, None, :] + torch.cumsum(wm * mm, dim=1) - wm * mm
        dist = torch.sum(w * (mm * mm * A_ex + M2_ex - 2.0 * mm * M1_ex),
                         dim=1)
        chans = torch.cat([f[..., 12:15], torch.zeros_like(f[..., :2]),
                           f[..., 15:18]], dim=-1)  # [m, k, 8]
        sums = torch.einsum("mkp,mkc->mpc", w, chans)
        zsum = torch.sum(w * z, dim=1)
        asum = torch.sum(w, dim=1)
        acc = acc + torch.cat([sums[..., 0:3], zsum[..., None],
                               asum[..., None], sums[..., 5:8],
                               dist[..., None]], dim=-1)
        M1 = M1 + torch.sum(wm, dim=1)
        M2 = M2 + torch.sum(wm * mm, dim=1)
        if count_work:
            hitp = live & (a > 0)
            work[0] += torch.sum(hitp)
            work[1] += torch.sum(ok & live.any(dim=2))
            work[2] += torch.sum(hitp.any(dim=2))
        Tc = prod[:, -1]
        if not bool(torch.any(Tc > rnd.transmittance_min)):
            break
    return acc, work


def _assemble(tiles_out, bn: ref.Binning, cam: ref.Camera, tile: int):
    """[num_tiles, P, n] -> [H, W, n]."""
    n = tiles_out.shape[-1]
    t = tile
    img = tiles_out.reshape(bn.tiles_y, bn.tiles_x, t, t, n).permute(
        0, 2, 1, 3, 4).reshape(bn.tiles_y * t, bn.tiles_x * t, n)
    return img[: cam.height, : cam.width]


def _to_tiles(img, bn: ref.Binning, cam: ref.Camera, tile: int):
    """[H, W, n] -> [num_tiles, P, n], zero past the image's edge."""
    n = img.shape[-1]
    t = tile
    pad = torch.zeros(bn.tiles_y * t, bn.tiles_x * t, n, dtype=img.dtype,
                      device=img.device)
    pad[: cam.height, : cam.width] = img
    return pad.reshape(bn.tiles_y, t, bn.tiles_x, t, n).permute(
        0, 2, 1, 3, 4).reshape(bn.tiles_x * bn.tiles_y, t * t, n)


def _maps(raw):
    """The named maps of [H, W, MAPS] sums."""
    return {"rgb": torch.clamp(raw[..., 0:3], 0.0, 1.0),
            "depth": raw[..., 3], "alpha": raw[..., 4],
            "normal": raw[..., 5:8], "dist": raw[..., 8]}


def _composite(proj, cam, rnd, sf, budget, count_work=False):
    """(the binning, the chunks, the raw maps [H, W, MAPS], the work
    counts) of projected surfels, without autograd."""
    with torch.no_grad():
        bn = ref.bin_pairs(proj, cam, rnd)
        rows = proj["rows"][bn.vis]
        P = rnd.tile * rnd.tile
        chunks = ref._tile_chunks(bn, budget, P)
        out = torch.zeros(bn.tiles_x * bn.tiles_y, P, MAPS,
                          dtype=rows.dtype, device=rows.device)
        work = torch.zeros(3, dtype=torch.int64, device=rows.device)
        for tiles, K in chunks:
            acc, w = composite_chunk(rows, bn, tiles, K, rnd, sf, count_work)
            out[tiles] = acc
            if count_work:
                work += w
    return bn, chunks, _assemble(out, bn, cam, rnd.tile), work


def render(params: dict, alive, cam: ref.Camera, rnd: ref.Renderer,
           sf: Surfels, dtype=torch.float32, count_work: bool = False):
    """(the maps: ``rgb`` [H, W, 3] clamped to [0, 1], ``depth`` (sum w z),
    ``alpha``, ``normal`` [H, W, 3], ``dist``, in ``dtype``; with
    ``count_work`` ``render.render``'s work counts, else None)."""
    _tf32_off()
    with torch.no_grad():
        proj = project(params, alive, cam, rnd, sf, dtype)
        bn, _, raw, work = _composite(proj, cam, rnd, sf, FRAME_BUDGET,
                                      count_work)
    counts = None
    if count_work:
        counts = {"gaussians": int(bn.vis.shape[0]),
                  "pairs": int(bn.gauss.shape[0]),
                  "live_pairs": int(work[1]),
                  "contrib_pairs": int(work[2]),
                  "pair_pixels": int(work[0]),
                  "pixels": cam.height * cam.width}
    return _maps(raw), counts


def depth_to_normal(depth, cam: ref.Camera):
    """The normals [H, W, 3] (camera space) of a depth map: each pixel
    unprojected to ``depth ((x - cx) / fx, (y - cy) / fy, 1)``, central
    differences down the rows and along the columns, their cross product
    normalised (``x / max(|x|, 1e-12)``), zero on the border."""
    H, W = depth.shape
    dev, dtype = depth.device, depth.dtype
    xs = (torch.arange(W, device=dev, dtype=dtype) - cam.cx) / cam.fx
    ys = (torch.arange(H, device=dev, dtype=dtype) - cam.cy) / cam.fy
    pts = torch.stack([depth * xs[None, :], depth * ys[:, None], depth], -1)
    dr = pts[2:, 1:-1] - pts[:-2, 1:-1]
    dc = pts[1:-1, 2:] - pts[1:-1, :-2]
    n = torch.cross(dr, dc, dim=-1)
    n = n / torch.clamp(torch.linalg.vector_norm(n, dim=-1, keepdim=True),
                        min=1e-12)
    out = torch.zeros(H, W, 3, dtype=dtype, device=dev)
    out[1:-1, 1:-1] = n
    return out


def geometry_terms(maps: dict, cam: ref.Camera):
    """(mean distortion, mean normal error) of a frame's maps: the expected
    depth ``sum w z / sum w`` (0 where the alpha is 0), its normals times
    the detached alpha, ``1 - N . N_d``."""
    alpha = maps["alpha"]
    hit = alpha > 0.0
    depth = torch.where(hit, maps["depth"] / torch.where(hit, alpha, 1.0),
                        0.0)
    nd = depth_to_normal(depth, cam) * alpha.detach()[..., None]
    return (torch.mean(maps["dist"]),
            torch.mean(1.0 - torch.sum(maps["normal"] * nd, dim=-1)))


def loss_fn(target_rgb, cam: ref.Camera, t: dict, sf: Surfels):
    """The training loss as a function of the raw maps [H, W, MAPS]."""
    photo = ref.photo_loss(target_rgb, t["lambda_l1"], t["lambda_ssim"])

    def fn(raw):
        maps = _maps(raw)
        dist, normal = geometry_terms(maps, cam)
        return (photo(maps["rgb"]) + sf.lambda_dist * dist
                + sf.lambda_normal * normal)
    return fn


def render_grad(params: dict, alive, cam: ref.Camera, rnd: ref.Renderer,
                sf: Surfels, target_rgb, t: dict, dtype=torch.float32):
    """The loss of the frame against ``target_rgb`` and its gradient with
    respect to every leaf, as ``render.render_grad`` works it out: the
    maps without autograd; the loss and its gradient with respect to the
    raw maps; then tile chunk by tile chunk the composite again under
    autograd, back-propagated with those map gradients into the visible
    surfels' rows, and those through the surfel transform and the SH
    colour into the leaves. ``t``: the traffic's ``train`` block. Returns
    (loss, {leaf: float32 gradient}, the first pass's maps)."""
    _tf32_off()
    leaves = {k: v.detach().to(dtype).requires_grad_(True)
              for k, v in params.items()}
    proj = project(leaves, alive, cam, rnd, sf, dtype)
    bn, chunks, raw, _ = _composite(proj, cam, rnd, sf, GRAD_BUDGET)
    rows = proj["rows"][bn.vis]
    rows_leaf = rows.detach().requires_grad_(True)
    raw = raw.detach().requires_grad_(True)
    loss = loss_fn(target_rgb, cam, t, sf)(raw)
    loss.backward()
    g_tiles = _to_tiles(raw.grad, bn, cam, rnd.tile)
    for tiles, K in chunks:
        acc = composite_chunk(rows_leaf, bn, tiles, K, rnd, sf)[0]
        torch.autograd.backward(acc, g_tiles[tiles])
    g_rows = rows_leaf.grad if rows_leaf.grad is not None \
        else torch.zeros_like(rows_leaf)
    torch.autograd.backward(rows, g_rows)
    grads = {k: (v.grad if v.grad is not None else torch.zeros_like(v))
             .float() for k, v in leaves.items()}
    return float(loss.detach()), grads, _maps(raw.detach())

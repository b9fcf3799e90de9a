"""Plain PyTorch reference of a 3DGS frame: covariance, SH colour,
projection, binning into (gaussian, tile) pairs and front-to-back
compositing, computed in blocks of tiles so that a frame of millions of
gaussians fits.

It is written from the published method (Kerbl et al. 2023) with the
renderer's stated constants, and follows the order of operations of the
port's plain stages (``gsplat_tpu_torch/ops/gaussian.py``, ``sh.py``,
``projection.py`` and ``rasterize.py::rasterize_dense``, frozen here) so
that its float32 rounding stays close to the program's. It imports
nothing of the program. Every function takes a ``dtype``: float32 is the
reference, a lower precision is the control that must fail the
comparison.

Binning rule: a valid gaussian covers every tile of its pixel rectangle
``floor(u +- rx)``, ``floor(v +- ry)`` with ``r = ceil(sqrt(k2 * s))``
and ``k2 = min(chi2_clip, 2 ln(opacity / alpha_cutoff))``. Within a tile
the pairs go front to back by depth (ties by index). A pixel (integer
coordinates, as the renderer's) takes ``w = alpha * T`` while the
transmittance in front of the pair stays above ``transmittance_min``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2_0 = 1.0925484305920792
SH_C2_1 = 0.31539156525252005
SH_C2_2 = 0.5462742152960396
SH_C3_0 = 0.5900435899266435
SH_C3_1 = 2.890611442640554
SH_C3_2 = 0.4570457994644658
SH_C3_3 = 0.3731763325901154
SH_C3_4 = 1.445305721320277

# Blocking, so that a frame of millions of gaussians fits: the pairs of a
# tile chunk are composited SUB at a time, and a chunk holds at most
# FRAME_BUDGET (pair slot, pixel) entries, GRAD_BUDGET under autograd
# (which keeps about ten such tensors for the backward).
SUB = 512
FRAME_BUDGET = 2**27
GRAD_BUDGET = 2**25


@dataclass(frozen=True)
class Camera:
    """A pinhole view: c2w [4, 4] (numpy or tensor), intrinsics, size."""

    c2w: object
    fx: float
    fy: float
    cx: float
    cy: float
    height: int
    width: int


@dataclass(frozen=True)
class Renderer:
    """The renderer's constants (a configuration's ``render`` block)."""

    tile: int = 16
    near: float = 0.01
    far: float = 100.0
    pix_guard: float = 32.0
    min_conic: float = 1e-6
    chi2_clip: float = 6.25
    alpha_max: float = 0.99
    alpha_cutoff: float = 1.0 / 128.0
    transmittance_min: float = 5e-5

    @classmethod
    def from_config(cls, block: dict) -> "Renderer":
        names = cls.__dataclass_fields__
        return cls(**{k: v for k, v in block.items() if k in names})


def _maximum(x, lo):
    return torch.clamp(x, min=lo)


def cov3d(scale_raw, q_raw):
    """Packed world covariance [N, 6] (xx, xy, xz, yy, yz, zz) of
    R diag(exp(s)^2) R^T, quaternions (x, y, z, w) with a +1e-9 norm guard."""
    q = q_raw / (torch.linalg.vector_norm(q_raw, dim=-1, keepdim=True) + 1e-9)
    x, y, z, w = q.unbind(-1)
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - z * w)
    r02 = 2 * (x * z + y * w)
    r10 = 2 * (x * y + z * w)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - x * w)
    r20 = 2 * (x * z - y * w)
    r21 = 2 * (y * z + x * w)
    r22 = 1 - 2 * (x * x + y * y)
    s2 = _maximum(torch.exp(scale_raw), 1e-6) ** 2
    s0, s1, s2_ = s2.unbind(-1)

    def sig(a0, a1, a2, b0, b1, b2):
        return s0 * a0 * b0 + s1 * a1 * b1 + s2_ * a2 * b2

    return torch.stack([
        sig(r00, r01, r02, r00, r01, r02), sig(r00, r01, r02, r10, r11, r12),
        sig(r00, r01, r02, r20, r21, r22), sig(r10, r11, r12, r10, r11, r12),
        sig(r10, r11, r12, r20, r21, r22), sig(r20, r21, r22, r20, r21, r22),
    ], dim=-1)


def sh_colors(f_dc, f_rest, pos, cam_pos):
    """RGB [N, 3] = sigmoid(sum_k f_k Y_k(dir)), dir = pos - camera,
    degree 3 (f_rest [N, 45] laid out [15 R, 15 G, 15 B])."""
    d = pos - cam_pos[None, :]
    norm = torch.sqrt(_maximum(torch.sum(d * d, dim=-1, keepdim=True), 1e-24))
    d = d / (norm + 1e-8)
    x, y, z = d.unbind(-1)
    xx, yy, zz, xy, xz, yz = x * x, y * y, z * z, x * y, x * z, y * z
    basis = torch.stack([
        torch.full_like(x, SH_C0), -SH_C1 * y, SH_C1 * z, -SH_C1 * x,
        SH_C2_0 * xy, SH_C2_0 * yz, SH_C2_1 * (3 * zz - 1), SH_C2_0 * xz,
        SH_C2_2 * (xx - yy), SH_C3_0 * y * (3 * xx - yy), SH_C3_1 * x * y * z,
        SH_C3_2 * y * (4 * zz - xx - yy),
        SH_C3_3 * z * (2 * zz - 3 * xx - 3 * yy),
        SH_C3_2 * x * (4 * zz - xx - yy), SH_C3_4 * z * (xx - yy),
        SH_C3_0 * x * (xx - 3 * yy),
    ], dim=-1)  # [N, 16]
    k = 1 + f_rest.shape[-1] // 3
    rest = f_rest.reshape(f_rest.shape[0], 3, k - 1).transpose(1, 2)
    coeffs = torch.cat([f_dc[:, None, :], rest], dim=1)  # [N, K, 3]
    raw = torch.sum(basis[:, :k, None] * coeffs, dim=1)
    return torch.sigmoid(raw)


def project(params: dict, alive, cam: Camera, rnd: Renderer, dtype,
            filter2d=None):
    """Screen-space splats of every gaussian: a dict of uv [N, 2], depth,
    conic [N, 3], opacity, rgb [N, 3], valid [N] and the tile rectangle
    (tx0, ty0, tx1, ty1) [N, 4] int64 (empty for invalid gaussians).

    ``filter2d``, where a model's reference gives one, maps each splat's
    2D covariance and opacity ``(sa, sb, sc, opacity)`` to new ones
    before the eigenvalue clamp (an anti-aliasing filter); plain 3DGS has
    none."""
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
    u = fx * x / z + cx
    v = fy * y / z + cy

    # EWA: Sigma2D = M Sigma M^T with rows M_r = J_r R^T.
    invz = 1.0 / _maximum(z, 1e-6)
    invz2 = invz * invz
    zero = torch.zeros_like(invz)
    ju = (fx * invz, zero, -fx * x * invz2)
    jv = (zero, fy * invz, -fy * y * invz2)
    mu = [ju[0] * R[k, 0] + ju[1] * R[k, 1] + ju[2] * R[k, 2] for k in range(3)]
    mv = [jv[0] * R[k, 0] + jv[1] * R[k, 1] + jv[2] * R[k, 2] for k in range(3)]
    xx, xy, xz, yy, yz, zz = cov3d(p["scale_raw"], p["q_raw"]).unbind(-1)

    def quad(a, b):
        return (a[0] * (xx * b[0] + xy * b[1] + xz * b[2])
                + a[1] * (xy * b[0] + yy * b[1] + yz * b[2])
                + a[2] * (xz * b[0] + yz * b[1] + zz * b[2]))

    sa, sc = quad(mu, mu), quad(mv, mv)
    sb = 0.5 * (quad(mu, mv) + quad(mv, mu))
    valid = valid & torch.isfinite(sa) & torch.isfinite(sb) & torch.isfinite(sc)
    sa = torch.where(valid, sa, 1.0)
    sb = torch.where(valid, sb, 0.0)
    sc = torch.where(valid, sc, 1.0)
    if filter2d is not None:
        sa, sb, sc, opacity = filter2d(sa, sb, sc, opacity)

    # Eigenvalues clamped to [1e-6, 1e4]; the input is kept where neither
    # clamp acts.
    m = 0.5 * (sa + sc)
    dd = 0.5 * (sa - sc)
    r = torch.sqrt(dd * dd + sb * sb + 1e-30)
    l1r, l2r = m - r, m + r
    l1, l2 = torch.clamp(l1r, 1e-6, 1e4), torch.clamp(l2r, 1e-6, 1e4)
    keep = (l1r >= 1e-6) & (l2r <= 1e4)
    f = (l2 - l1) / (2.0 * r)
    mn = 0.5 * (l1 + l2)
    sa, sc, sb = (torch.where(keep, sa, mn + f * dd),
                  torch.where(keep, sc, mn - f * dd),
                  torch.where(keep, sb, f * sb))

    with torch.no_grad():  # integer footprint: no gradient path
        fu, fv, fa, fc = (x.float() for x in (u, v, sa, sc))
        k2 = torch.clamp(2.0 * torch.log(
            torch.clamp(opacity, min=1e-12) / rnd.alpha_cutoff),
            max=rnd.chi2_clip)
        valid = valid & (k2 > 0.0)
        k2 = torch.clamp(k2, min=0.0)
        rx = torch.ceil(torch.sqrt(k2 * torch.clamp(fa, 1e-12, 1e4)))
        ry = torch.ceil(torch.sqrt(k2 * torch.clamp(fc, 1e-12, 1e4)))
        umin, umax = torch.floor(fu - rx), torch.floor(fu + rx)
        vmin, vmax = torch.floor(fv - ry), torch.floor(fv + ry)
        valid = valid & (umax >= 0) & (umin < W) & (vmax >= 0) & (vmin < H)

        def pix(a, hi):
            return torch.clamp(torch.where(valid, a, 0.0), 0, hi).to(
                torch.int64)

        T = rnd.tile
        rect = torch.stack([pix(umin, W - 1) // T, pix(vmin, H - 1) // T,
                            pix(umax, W - 1) // T, pix(vmax, H - 1) // T], -1)
        rect[:, 2:] = torch.where(valid[:, None], rect[:, 2:], rect[:, :2] - 1)

    det = _maximum(sa * sc - sb * sb, 1e-12)
    inv = 1.0 / det
    conic = torch.stack([_maximum(sc * inv, rnd.min_conic), -sb * inv,
                         _maximum(sa * inv, rnd.min_conic)], dim=-1)
    rgb = sh_colors(p["f_dc"], p["f_rest"], p["pos"], t)
    return {"uv": torch.stack([u, v], -1), "depth": z, "conic": conic,
            "opacity": opacity, "rgb": rgb, "valid": valid, "rect": rect}


@dataclass
class Binning:
    """Pairs of the visible gaussians, tile-major, front to back in a tile:
    ``gauss`` [P] indexes the visible gaussians ``vis`` (depth order);
    ``start``/``count`` [num_tiles]."""

    vis: torch.Tensor
    gauss: torch.Tensor
    start: torch.Tensor
    count: torch.Tensor
    tiles_x: int
    tiles_y: int


def bin_pairs(splats: dict, cam: Camera, rnd: Renderer) -> Binning:
    dev = splats["depth"].device
    valid = splats["valid"]
    key = torch.where(valid, splats["depth"].float(), torch.inf)
    order = torch.argsort(key, stable=True)
    vis = order[: int(valid.sum())]
    rect = splats["rect"][vis]
    nu = rect[:, 2] - rect[:, 0] + 1
    nv = rect[:, 3] - rect[:, 1] + 1
    cnt = nu * nv
    total = int(cnt.sum())
    TX = -(-cam.width // rnd.tile)
    TY = -(-cam.height // rnd.tile)
    g = torch.repeat_interleave(torch.arange(vis.shape[0], device=dev), cnt,
                                output_size=total)
    off = torch.cumsum(cnt, 0) - cnt
    local = torch.arange(total, device=dev) - off[g]
    tile = (rect[g, 1] + local // nu[g]) * TX + rect[g, 0] + local % nu[g]
    del local
    srt = torch.sort(tile * max(vis.shape[0], 1) + g)[0]
    del tile
    gauss = srt % max(vis.shape[0], 1)
    tiles = srt // max(vis.shape[0], 1)
    count = torch.bincount(tiles, minlength=TX * TY)
    start = torch.cumsum(count, 0) - count
    return Binning(vis, gauss, start, count, TX, TY)


def _tile_pixels(tiles, bn: Binning, tile: int, dtype):
    lane = torch.arange(tile * tile, device=tiles.device)
    px = (tiles % bn.tiles_x * tile)[:, None] + lane % tile
    py = (tiles // bn.tiles_x * tile)[:, None] + lane // tile
    return px.to(dtype), py.to(dtype)


def _tile_chunks(bn: Binning, budget: int, P: int):
    """Tiles heaviest first, cut into chunks of at most ``budget``
    (pair slot, pixel) entries: [(tiles, K)]."""
    order = torch.argsort(bn.count, descending=True, stable=True)
    counts = bn.count[order].tolist()
    chunks, i, n = [], 0, len(counts)
    while i < n and counts[i] > 0:
        K = counts[i]
        m = max(1, budget // (K * P))
        chunks.append((order[i:i + m], K))
        i += m
    return chunks


def composite_chunk(feat, bn: Binning, tiles, K: int, rnd: Renderer,
                    count_work: bool = False):
    """Composite the pairs of ``tiles`` (each with at most K pairs) front
    to back, ``SUB`` pairs at a time, stopping once every pixel of the
    chunk is saturated. ``feat`` [V, 9] (u, v, conic x3, opacity, rgb) of
    the visible gaussians in depth order. Returns (rgb [m, P, 3], with
    ``count_work`` [3] counts: the (pair, pixel) with a non-zero weight,
    the pairs reached while some pixel of their tile is not saturated,
    and the pairs with a non-zero weight at some pixel; else None)."""
    dev, dtype = feat.device, feat.dtype
    tile = rnd.tile
    P = tile * tile
    m = tiles.shape[0]
    px, py = _tile_pixels(tiles, bn, tile, dtype)
    start, cnt = bn.start[tiles], bn.count[tiles]
    Tc = torch.ones(m, P, dtype=dtype, device=dev)
    acc = torch.zeros(m, P, 3, dtype=dtype, device=dev)
    work = torch.zeros(3, dtype=torch.int64, device=dev) if count_work \
        else None
    for k0 in range(0, K, SUB):
        j = k0 + torch.arange(min(SUB, K - k0), device=dev)
        ok = j[None, :] < cnt[:, None]  # [m, k]
        idx = torch.where(ok, start[:, None] + j[None, :], 0)
        f = feat[bn.gauss[idx]]  # [m, k, 9]
        du = px[:, None, :] - f[..., 0:1]
        dv = py[:, None, :] - f[..., 1:2]
        q = (f[..., 2:3] * du * du + 2.0 * f[..., 3:4] * du * dv
             + f[..., 4:5] * dv * dv)
        gg = torch.where(q <= rnd.chi2_clip, torch.exp(-0.5 * q), 0.0)
        a = torch.clamp(f[..., 5:6] * gg, max=rnd.alpha_max)
        a = torch.where((a >= rnd.alpha_cutoff) & ok[..., None], a, 0.0)
        prod = torch.cumprod(torch.cat([Tc[:, None, :], 1.0 - a], dim=1),
                             dim=1)
        t_ex = prod[:, :-1]
        live = t_ex > rnd.transmittance_min
        w = torch.where(live, a * t_ex, 0.0)
        acc = acc + torch.einsum("mkp,mkc->mpc", w, f[..., 6:9])
        if count_work:
            hit = live & (a > 0)
            work[0] += torch.sum(hit)
            work[1] += torch.sum(ok & live.any(dim=2))
            work[2] += torch.sum(hit.any(dim=2))
        Tc = prod[:, -1]
        if not bool(torch.any(Tc > rnd.transmittance_min)):
            break
    return acc, work


def _feat(splats, vis):
    s = splats
    return torch.cat([s["uv"], s["conic"], s["opacity"][:, None], s["rgb"]],
                     dim=-1)[vis]


def _assemble(tiles_rgb, bn: Binning, cam: Camera, tile: int):
    t = tile
    img = tiles_rgb.reshape(bn.tiles_y, bn.tiles_x, t, t, 3).permute(
        0, 2, 1, 3, 4).reshape(bn.tiles_y * t, bn.tiles_x * t, 3)
    return img[: cam.height, : cam.width]


def render(params: dict, alive, cam: Camera, rnd: Renderer,
           dtype=torch.float32, count_work=False, filter2d=None):
    """The frame [H, W, 3] (float32, clamped to [0, 1]) and, with
    ``count_work``, the work counts: gaussians in view, (gaussian, tile)
    pairs and composited (pair, pixel). ``filter2d``: as :func:`project`."""
    with torch.no_grad():
        splats = project(params, alive, cam, rnd, dtype, filter2d)
        bn = bin_pairs(splats, cam, rnd)
        feat = _feat(splats, bn.vis)
        P = rnd.tile * rnd.tile
        out = torch.zeros(bn.tiles_x * bn.tiles_y, P, 3, dtype=dtype,
                          device=feat.device)
        work = torch.zeros(3, dtype=torch.int64, device=feat.device)
        for tiles, K in _tile_chunks(bn, FRAME_BUDGET, P):
            acc, w = composite_chunk(feat, bn, tiles, K, rnd,
                                     count_work=count_work)
            out[tiles] = acc
            if count_work:
                work += w
        img = torch.clamp(_assemble(out, bn, cam, rnd.tile), 0.0, 1.0)
    counts = None
    if count_work:
        counts = {"gaussians": int(bn.vis.shape[0]),
                  "pairs": int(bn.gauss.shape[0]),
                  "live_pairs": int(work[1]),
                  "contrib_pairs": int(work[2]),
                  "pair_pixels": int(work[0]),
                  "pixels": cam.height * cam.width}
    return img.float(), counts


def render_grad(params: dict, alive, cam: Camera, rnd: Renderer, loss_fn,
                dtype=torch.float32, filter2d=None):
    """Loss of the frame and its gradients with respect to ``params``.

    Two passes: the frame without autograd, the loss and its gradient with
    respect to the image, then tile chunk by tile chunk the composite
    again under autograd, back-propagated with that image gradient into
    the visible gaussians' screen-space features, and those through the
    projection and the SH colour into the parameters. Returns (loss,
    {name: grad}) in float32. ``filter2d``: as :func:`project`."""
    leaves = {k: v.detach().to(dtype).requires_grad_(True)
              for k, v in params.items()}
    splats = project(leaves, alive, cam, rnd, dtype, filter2d)
    with torch.no_grad():
        bn = bin_pairs(splats, cam, rnd)
    feat = _feat(splats, bn.vis)
    feat_leaf = feat.detach().requires_grad_(True)
    P = rnd.tile * rnd.tile
    chunks = _tile_chunks(bn, GRAD_BUDGET, P)
    with torch.no_grad():
        out = torch.zeros(bn.tiles_x * bn.tiles_y, P, 3, dtype=dtype,
                          device=feat.device)
        for tiles, K in chunks:
            out[tiles] = composite_chunk(feat_leaf, bn, tiles, K, rnd)[0]
    raw = _assemble(out, bn, cam, rnd.tile)
    img = raw.detach().requires_grad_(True)
    loss = loss_fn(torch.clamp(img, 0.0, 1.0))
    (g_img,) = torch.autograd.grad(loss, img)
    # Back to the tile layout, padded past the image's edge with zeros.
    t = rnd.tile
    g_pad = torch.zeros(bn.tiles_y * t, bn.tiles_x * t, 3, dtype=dtype,
                        device=img.device)
    g_pad[: cam.height, : cam.width] = g_img
    g_tiles = g_pad.reshape(bn.tiles_y, t, bn.tiles_x, t, 3).permute(
        0, 2, 1, 3, 4).reshape(bn.tiles_x * bn.tiles_y, P, 3)
    for tiles, K in chunks:
        acc = composite_chunk(feat_leaf, bn, tiles, K, rnd)[0]
        torch.autograd.backward(acc, g_tiles[tiles])
    g_feat = feat_leaf.grad if feat_leaf.grad is not None \
        else torch.zeros_like(feat_leaf)
    torch.autograd.backward(feat, g_feat)
    grads = {k: (v.grad if v.grad is not None else torch.zeros_like(v))
             .float() for k, v in leaves.items()}
    return float(loss.detach()), grads


# -- training: the loss and Adam, as the paper trains -----------------------

def _gaussian_window(size=11, sigma=1.5, dtype=torch.float32, device=None):
    c = torch.arange(size, dtype=torch.float64, device=device) - size // 2
    g = torch.exp(-(c ** 2) / (2 * sigma ** 2))
    g = g / g.sum()
    return (g[:, None] * g[None, :]).to(dtype)


def ssim(pred, target):
    """Mean SSIM of [H, W, C] images: 11x11 Gaussian window (sigma 1.5),
    C1 = 0.01^2, C2 = 0.03^2, zero padding, per channel."""
    p = pred.permute(2, 0, 1)[None]
    t = target.permute(2, 0, 1)[None]
    c = p.shape[1]
    win = _gaussian_window(dtype=p.dtype, device=p.device)
    k = win[None, None].expand(c, 1, 11, 11)

    def blur(x):
        return torch.nn.functional.conv2d(x, k, padding=5, groups=c)

    mu1, mu2 = blur(p), blur(t)
    s11 = blur(p * p) - mu1 * mu1
    s22 = blur(t * t) - mu2 * mu2
    s12 = blur(p * t) - mu1 * mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    num = (2 * mu1 * mu2 + c1) * (2 * s12 + c2)
    den = (mu1 * mu1 + mu2 * mu2 + c1) * (s11 + s22 + c2)
    return torch.mean(num / den)


def photo_loss(target, lambda_l1=0.8, lambda_ssim=0.2):
    """L = lambda_l1 |pred - gt|_1 + lambda_ssim (1 - SSIM) as a function
    of the predicted image."""
    def fn(img):
        tgt = target.to(img.dtype)
        return (lambda_l1 * torch.mean(torch.abs(img - tgt))
                + lambda_ssim * (1.0 - ssim(img, tgt)))
    return fn


def position_lr(step: int, t: dict) -> float:
    """The position LR: exponential decay from ``position_lr_init`` to
    ``_final`` over ``_max_steps``, times 0.01 for the first
    ``delay_mult * max_steps`` updates (3DGS's train.py)."""
    frac = min(step / t["position_lr_max_steps"], 1.0)
    lr = t["position_lr_init"] * (
        t["position_lr_final"] / t["position_lr_init"]) ** frac
    if step >= t["position_lr_max_steps"]:
        lr = t["position_lr_final"]
    if step < t["position_lr_delay_mult"] * t["position_lr_max_steps"]:
        lr *= 0.01
    return lr


def leaf_lrs(t: dict, step: int) -> dict:
    return {"pos": position_lr(step, t), "opacity_raw": t["opacity_lr"],
            "f_dc": t["feature_lr"], "f_rest": t["feature_lr"] / 20.0,
            "scale_raw": t["scaling_lr"], "q_raw": t["rotation_lr"]}


class Adam:
    """Adam (beta 0.9, 0.999) with one LR per leaf; the position gradient
    is clipped to an L2 norm of ``grad_clip_pos`` and dead slots' gradients
    are zeroed before the update."""

    def __init__(self, params: dict, t: dict, dtype=torch.float32):
        self.t = t
        self.dtype = dtype
        self.m = {k: torch.zeros_like(v, dtype=dtype) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v, dtype=dtype) for k, v in params.items()}
        self.count = 0

    def prepare(self, grads: dict, alive) -> dict:
        g = {k: v.to(self.dtype) for k, v in grads.items()}
        norm = torch.sqrt(torch.sum(g["pos"] * g["pos"]))
        g["pos"] = g["pos"] * torch.clamp(
            self.t["grad_clip_pos"] / (norm + 1e-6), max=1.0)
        if alive is not None:
            g = {k: torch.where(alive.reshape((-1,) + (1,) * (v.dim() - 1)),
                                v, 0.0) for k, v in g.items()}
        return g

    def step(self, params: dict, grads: dict) -> dict:
        b1, b2, eps = 0.9, 0.999, self.t["adam_eps"]
        lrs = leaf_lrs(self.t, self.count)
        self.count += 1
        bc1 = 1 - b1 ** self.count
        bc2 = 1 - b2 ** self.count
        out = {}
        for k, p in params.items():
            g = grads[k]
            self.m[k] = b1 * self.m[k] + (1 - b1) * g
            self.v[k] = b2 * self.v[k] + (1 - b2) * g * g
            denom = torch.sqrt(self.v[k]) / math.sqrt(bc2) + eps
            out[k] = (p.to(self.dtype)
                      - (lrs[k] / bc1) * self.m[k] / denom).to(p.dtype)
        return out

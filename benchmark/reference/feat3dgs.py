"""Plain PyTorch reference of a Feature 3DGS frame and training step
(Zhou et al., "Feature 3DGS: Supercharging 3D Gaussian Splatting to
Enable Distilled Feature Fields", CVPR 2024, arXiv:2312.03203).

Each gaussian carries, beside 3DGS's leaves, a feature vector ``f_sem``
of C floats. The frame composites the 3 colour channels and the C
feature channels with the same weights (``composite_chunk`` below: a
copy of ``render.py::composite_chunk`` that takes 3 + C channels; the
alpha and transmittance rules are unchanged), so that

    F(p) = sum_i f_i alpha_i(p) T_i(p).

The feature map ``[C, H, W]`` is resized to the teacher's size (bilinear,
``align_corners=True``) and decoded by a 1x1 convolution with bias from C
to D channels, ``dec_w`` [D, C] and ``dec_b`` [D]. The loss is

    (1 - lambda) L1(rgb) + lambda D-SSIM(rgb) + gamma L1(decoded, teacher),

and Adam trains every leaf: 3DGS's at the paper's rates, ``f_sem`` at
``semantic_feature_lr``, the decoder at ``decoder_lr``.

Departures from the paper and the authors' code, all of them about what
a benchmark can hold still:

* the teacher map is not LSeg's (that needs a download and the model):
  it is this reference's own decoded map of the unperturbed scene;
* the features and the decoder are drawn from the seed (``f_sem`` ~
  N(0, 1), the decoder as ``torch.nn.Conv2d`` draws its default), not
  zero-initialised and trained from scratch;
* the renderer is the port's (rectangle binning, ``transmittance_min``,
  block-free front-to-back compositing), as ``render.py`` is: the
  authors' CUDA rasterizer stops a pixel at T < 1e-4 per pixel, not at
  the port's saturation rule;
* the speed-up module's C = 128 is what the configuration states; the
  paper's 512-channel variant without it is not run.

Everything is float32 by default (TF32 is the caller's to turn off; the
harness does), and every function takes a ``dtype``: float32 is the
reference, a lower precision the control. It imports nothing of the
program: only torch and ``reference/render.py``.
"""

from __future__ import annotations

import math

import torch

from . import render as ref

DECODER_KEYS = ("dec_w", "dec_b")
FEATURE_KEY = "f_sem"


def composite_chunk(feat, bn: ref.Binning, tiles, K: int, rnd: ref.Renderer,
                    count_work: bool = False):
    """``render.composite_chunk`` for any number of channels: ``feat``
    [V, 6 + n] (u, v, conic x3, opacity, then the n channels: rgb and the
    features) of the visible gaussians in depth order. Returns (sums [m,
    P, n], with ``count_work`` the [3] work counts of
    ``render.composite_chunk``; else None)."""
    dev, dtype = feat.device, feat.dtype
    tile = rnd.tile
    P = tile * tile
    m = tiles.shape[0]
    n = feat.shape[1] - 6
    px, py = ref._tile_pixels(tiles, bn, tile, dtype)
    start, cnt = bn.start[tiles], bn.count[tiles]
    Tc = torch.ones(m, P, dtype=dtype, device=dev)
    acc = torch.zeros(m, P, n, dtype=dtype, device=dev)
    work = torch.zeros(3, dtype=torch.int64, device=dev) if count_work \
        else None
    for k0 in range(0, K, ref.SUB):
        j = k0 + torch.arange(min(ref.SUB, K - k0), device=dev)
        ok = j[None, :] < cnt[:, None]  # [m, k]
        idx = torch.where(ok, start[:, None] + j[None, :], 0)
        f = feat[bn.gauss[idx]]  # [m, k, 6 + n]
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
        acc = acc + torch.einsum("mkp,mkc->mpc", w, f[..., 6:])
        if count_work:
            hit = live & (a > 0)
            work[0] += torch.sum(hit)
            work[1] += torch.sum(ok & live.any(dim=2))
            work[2] += torch.sum(hit.any(dim=2))
        Tc = prod[:, -1]
        if not bool(torch.any(Tc > rnd.transmittance_min)):
            break
    return acc, work


def _feat(splats, vis, f_sem):
    """[V, 9 + C]: each visible gaussian's screen-space row and its
    features, in depth order."""
    s = splats
    return torch.cat([s["uv"], s["conic"], s["opacity"][:, None], s["rgb"],
                      f_sem.to(s["uv"].dtype)], dim=-1)[vis]


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


def _gaussian_leaves(params: dict) -> dict:
    return {k: v for k, v in params.items() if k not in DECODER_KEYS}


def render(params: dict, alive, cam: ref.Camera, rnd: ref.Renderer,
           dtype=torch.float32, count_work: bool = False):
    """(rgb [H, W, 3] clamped to [0, 1], feature map [C, H, W]) in
    ``dtype``, and with ``count_work`` ``render.render``'s work counts;
    else None."""
    with torch.no_grad():
        g = _gaussian_leaves(params)
        splats = ref.project(g, alive, cam, rnd, dtype)
        bn = ref.bin_pairs(splats, cam, rnd)
        feat = _feat(splats, bn.vis, g[FEATURE_KEY].to(dtype))
        P = rnd.tile * rnd.tile
        out = torch.zeros(bn.tiles_x * bn.tiles_y, P, feat.shape[1] - 6,
                          dtype=dtype, device=feat.device)
        work = torch.zeros(3, dtype=torch.int64, device=feat.device)
        for tiles, K in ref._tile_chunks(bn, ref.FRAME_BUDGET, P):
            acc, w = composite_chunk(feat, bn, tiles, K, rnd, count_work)
            out[tiles] = acc
            if count_work:
                work += w
        img = _assemble(out, bn, cam, rnd.tile)
    rgb = torch.clamp(img[..., :3], 0.0, 1.0)
    fmap = img[..., 3:].permute(2, 0, 1).contiguous()
    counts = None
    if count_work:
        counts = {"gaussians": int(bn.vis.shape[0]),
                  "pairs": int(bn.gauss.shape[0]),
                  "live_pairs": int(work[1]),
                  "contrib_pairs": int(work[2]),
                  "pair_pixels": int(work[0]),
                  "pixels": cam.height * cam.width}
    return rgb, fmap, counts


def decode(fmap, size: tuple, dec_w, dec_b):
    """The decoder on a [C, H, W] map: bilinear resize (``align_corners``)
    to ``size``, then the 1x1 convolution with bias: [D, h, w]."""
    x = torch.nn.functional.interpolate(fmap[None], size=size,
                                        mode="bilinear", align_corners=True)
    return torch.nn.functional.conv2d(
        x, dec_w.to(fmap.dtype)[:, :, None, None], dec_b.to(fmap.dtype))[0]


def feature_loss(teacher, gamma: float):
    """gamma L1 between the decoded map and ``teacher``, as a function of
    (feature map, dec_w, dec_b)."""
    def fn(fmap, dec_w, dec_b):
        dec = decode(fmap, tuple(teacher.shape[1:]), dec_w, dec_b)
        return gamma * torch.mean(torch.abs(dec - teacher.to(dec.dtype)))
    return fn


def render_grad(params: dict, alive, cam: ref.Camera, rnd: ref.Renderer,
                target, t: dict, dtype=torch.float32):
    """The loss of the frame against ``target`` = (rgb, teacher map) and
    its gradient with respect to every leaf of ``params`` (3DGS's six,
    ``f_sem``, ``dec_w``, ``dec_b``), as ``render.render_grad`` works it
    out: the frame without autograd; the loss and its gradient with
    respect to the rgb image, the feature map and the decoder; then tile
    chunk by tile chunk the composite again under autograd, back-propagated
    with those image gradients into the visible gaussians' rows, and those
    through the projection, the SH colour and the features into the
    leaves. ``t``: the traffic's ``train`` block (``lambda_l1``,
    ``lambda_ssim``, ``semantic_loss_weight``). Returns (loss, {leaf:
    float32 gradient})."""
    leaves = {k: v.detach().to(dtype).requires_grad_(True)
              for k, v in params.items()}
    g = _gaussian_leaves(leaves)
    splats = ref.project(g, alive, cam, rnd, dtype)
    with torch.no_grad():
        bn = ref.bin_pairs(splats, cam, rnd)
    feat = _feat(splats, bn.vis, g[FEATURE_KEY])
    feat_leaf = feat.detach().requires_grad_(True)
    n = feat.shape[1] - 6
    P = rnd.tile * rnd.tile
    chunks = ref._tile_chunks(bn, ref.GRAD_BUDGET, P)
    with torch.no_grad():
        out = torch.zeros(bn.tiles_x * bn.tiles_y, P, n, dtype=dtype,
                          device=feat.device)
        for tiles, K in chunks:
            out[tiles] = composite_chunk(feat_leaf, bn, tiles, K, rnd)[0]
    raw = _assemble(out, bn, cam, rnd.tile)
    rgb = raw[..., :3].detach().requires_grad_(True)
    fmap = raw[..., 3:].permute(2, 0, 1).detach().requires_grad_(True)
    target_rgb, teacher = target
    loss = (ref.photo_loss(target_rgb, t["lambda_l1"], t["lambda_ssim"])(
        torch.clamp(rgb, 0.0, 1.0))
        + feature_loss(teacher, t["semantic_loss_weight"])(
            fmap, leaves["dec_w"], leaves["dec_b"]))
    loss.backward()
    g_img = torch.cat([rgb.grad, fmap.grad.permute(1, 2, 0)], dim=-1)
    g_tiles = _to_tiles(g_img, bn, cam, rnd.tile)
    for tiles, K in chunks:
        acc = composite_chunk(feat_leaf, bn, tiles, K, rnd)[0]
        torch.autograd.backward(acc, g_tiles[tiles])
    g_feat = feat_leaf.grad if feat_leaf.grad is not None \
        else torch.zeros_like(feat_leaf)
    torch.autograd.backward(feat, g_feat)
    grads = {k: (v.grad if v.grad is not None else torch.zeros_like(v))
             .float() for k, v in leaves.items()}
    return float(loss.detach()), grads


class Adam:
    """Adam (beta 0.9, 0.999) with one LR per leaf: 3DGS's (the position
    on its schedule, ``render.leaf_lrs``), ``f_sem`` at
    ``semantic_feature_lr``, the decoder at ``decoder_lr``. The position
    gradient is clipped to an L2 norm of ``grad_clip_pos`` and dead slots'
    gradients are zeroed (the decoder has no slots) before the update."""

    def __init__(self, params: dict, t: dict, dtype=torch.float32):
        self.t = t
        self.dtype = dtype
        self.m = {k: torch.zeros_like(v, dtype=dtype)
                  for k, v in params.items()}
        self.v = {k: torch.zeros_like(v, dtype=dtype)
                  for k, v in params.items()}
        self.count = 0

    def lrs(self, step: int) -> dict:
        out = ref.leaf_lrs(self.t, step)
        out[FEATURE_KEY] = self.t["semantic_feature_lr"]
        out.update({k: self.t["decoder_lr"] for k in DECODER_KEYS})
        return out

    def prepare(self, grads: dict, alive) -> dict:
        g = {k: v.to(self.dtype) for k, v in grads.items()}
        norm = torch.sqrt(torch.sum(g["pos"] * g["pos"]))
        g["pos"] = g["pos"] * torch.clamp(
            self.t["grad_clip_pos"] / (norm + 1e-6), max=1.0)
        if alive is not None:
            g = {k: v if k in DECODER_KEYS else torch.where(
                alive.reshape((-1,) + (1,) * (v.dim() - 1)), v, 0.0)
                for k, v in g.items()}
        return g

    def step(self, params: dict, grads: dict) -> dict:
        b1, b2, eps = 0.9, 0.999, self.t["adam_eps"]
        lrs = self.lrs(self.count)
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

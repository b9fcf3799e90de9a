"""Plain PyTorch reference of a Scaffold-GS frame and training step (Lu, Yu,
Xu, Xiangli, Wang, Lin, Dai, "Scaffold-GS: Structured 3D Gaussians for
View-Adaptive Rendering", CVPR 2024, arXiv:2312.00109; the authors'
``generate_neural_gaussians``, ``gaussian_model.py`` and ``train.py``).

An anchor ``a`` holds a position ``x_a``, ``k`` offsets ``O_a``, a feature
``f_a`` and six scales ``l_a = exp(scale_raw_a)``. Three MLPs, each
``x @ W1.T + b1 -> ReLU -> @ W2.T + b2`` on ``z = [f_a, d]`` with ``d =
(x_a - c) / |x_a - c|`` the viewing direction from the camera centre
``c``, give per slot ``i``: the opacity ``alpha = tanh(.)``, the scale and
rotation ``(sigma, q)`` and the colour ``sigmoid(.)``. Neural gaussian
``i`` of anchor ``a``: ``mu = x_a + O_{a,i} l_a[0:3]``, ``s = l_a[3:6]
sigmoid(sigma)``, the rotation ``q / max(|q|, 1e-12)`` (w, x, y, z),
opacity ``alpha`` and the colour. A slot is kept where its anchor is
visible and ``alpha > 0``; the kept neural gaussians are rendered by
3DGS's rule (``render.py``: the EWA projection, rectangle binning,
front-to-back compositing) with their colours.

Loss: ``0.8 L1 + 0.2 D-SSIM + scaling_reg * mean over the kept slots of
s_x s_y s_z``. Adam (``ScaffoldAdam``): the offsets and the three MLPs on
the position rate's schedule form at their own rates, the features and
scales at fixed rates; the anchor positions take no update (the authors'
rate is 0) and no gradient; nothing is clipped.

Departures from the authors, each a choice of the configuration
(``configs/scaffold650k.json``'s ``assumed``):

* the anchor cull: an anchor is visible where a gaussian at ``x_a`` with
  covariance ``diag(max(l_a[0:3], 1e-6)^2)`` and full opacity passes the
  projection's validity of ``render.py`` (near, far, the guard band,
  finite values, the rectangle touching the image), not the authors'
  rasterizer's ``visible_filter`` with its near plane of 0.2;
* the anchor rotation (identity, never trained) and the anchor opacity
  (never rendered) are left out;
* masked slots keep their fixed place (slot-major: slot ``i`` of anchor
  ``a`` is row ``i A + a``) and are culled by the projection, where the
  authors compact the kept set;
* the renderer's rules are the port's (``render.py``: ``alpha_cutoff``
  1/128 and the opacity pre-filter at half of it, the clip to 0.999,
  ``transmittance_min`` 5e-5), not the authors' CUDA rasterizer's.

The decode and the frame are worked in blocks of anchors and of tiles
(``render.py``'s chunks), so that 650 k anchors fit beside the program.
Everything is float32 by default, with TF32 off in every function that
computes; every function takes a ``dtype``: float32 is the reference, a
lower precision the control. It imports nothing of the program: only
torch and ``reference/render.py`` (its binning, compositing, SSIM and
Adam).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from . import render as ref

ANCHOR_KEYS = ("pos", "offset", "anchor_feat", "scale_raw")
MLP_KEYS = ("mlp_opacity", "mlp_cov", "mlp_color")
SLOT_FIELDS = {"mlp_opacity": 1, "mlp_cov": 7, "mlp_color": 3}
FIELDS = ("mu", "s", "q", "alpha", "color")
DECODE_BLOCK = 2**17  # anchors a block of the decode


@dataclass(frozen=True)
class Scaffold:
    """The model's widths and its scaling term's weight."""

    feat_dim: int = 32
    n_offsets: int = 10
    hidden: int = 32
    scaling_reg: float = 0.01

    @classmethod
    def from_config(cls, published: dict, train: dict | None = None):
        t = train or {}
        return cls(feat_dim=published["feat_dim"],
                   n_offsets=published["n_offsets"],
                   hidden=published["hidden"],
                   scaling_reg=t.get("scaling_reg", published["scaling_reg"]))


def _tf32_off():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def mlp_shapes(sc: Scaffold) -> dict:
    """{MLP: (inputs, hidden, outputs)}."""
    return {k: (sc.feat_dim + 3, sc.hidden, m * sc.n_offsets)
            for k, m in SLOT_FIELDS.items()}


def split(flat, shape):
    """(W1 [h, i], b1 [h], W2 [o, h], b2 [o]) of a flat MLP."""
    i, h, o = shape
    a, b, c = h * i, h * i + h, h * i + h + o * h
    return flat[:a].reshape(h, i), flat[a:b], flat[b:c].reshape(o, h), \
        flat[c:]


def init_mlps(sc: Scaffold, gen: torch.Generator, device) -> dict:
    """The three MLPs drawn as ``torch.nn.Linear`` draws its default:
    weight and bias uniform in +-1/sqrt(fan_in), flat (W1, b1, W2, b2)."""
    out = {}
    for k, (i, h, o) in mlp_shapes(sc).items():
        parts = []
        for fan_in, n in ((i, h * i), (i, h), (h, o * h), (h, o)):
            u = torch.rand(n, generator=gen, device=device)
            parts.append((2.0 * u - 1.0) / math.sqrt(fan_in))
        out[k] = torch.cat(parts)
    return out


def project_activated(mu, cov, opacity, valid_in, rgb, cam: ref.Camera,
                      rnd: ref.Renderer, dtype):
    """``render.project``'s arithmetic from the packed covariance [N, 6]
    and the opacities as they are (clipped to [0, 0.999] here): the
    splats dict ``render.bin_pairs`` and the compositor read (``rgb``
    [N, 3] passed through; None for the cull)."""
    dev = mu.device
    c2w = torch.as_tensor(cam.c2w, dtype=torch.float32, device=dev).to(dtype)
    R, t = c2w[:3, :3], c2w[:3, 3]
    H, W = cam.height, cam.width
    fx, fy, cx, cy = cam.fx, cam.fy, cam.cx, cam.cy

    opacity = torch.clamp(opacity, 0.0, 0.999)
    valid = opacity >= rnd.alpha_cutoff * 0.5
    if valid_in is not None:
        valid = valid & valid_in
    d = mu - t[None, :]
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

    invz = 1.0 / torch.clamp(z, min=1e-6)
    invz2 = invz * invz
    zero = torch.zeros_like(invz)
    ju = (fx * invz, zero, -fx * x * invz2)
    jv = (zero, fy * invz, -fy * y * invz2)
    mu_r = [ju[0] * R[k, 0] + ju[1] * R[k, 1] + ju[2] * R[k, 2]
            for k in range(3)]
    mv_r = [jv[0] * R[k, 0] + jv[1] * R[k, 1] + jv[2] * R[k, 2]
            for k in range(3)]
    xx, xy, xz, yy, yz, zz = cov.unbind(-1)

    def quad(a, b):
        return (a[0] * (xx * b[0] + xy * b[1] + xz * b[2])
                + a[1] * (xy * b[0] + yy * b[1] + yz * b[2])
                + a[2] * (xz * b[0] + yz * b[1] + zz * b[2]))

    sa, sc = quad(mu_r, mu_r), quad(mv_r, mv_r)
    sb = 0.5 * (quad(mu_r, mv_r) + quad(mv_r, mu_r))
    valid = valid & torch.isfinite(sa) & torch.isfinite(sb) & torch.isfinite(sc)
    sa = torch.where(valid, sa, 1.0)
    sb = torch.where(valid, sb, 0.0)
    sc = torch.where(valid, sc, 1.0)

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

    with torch.no_grad():
        fu, fv, fa, fc = (q.float() for q in (u, v, sa, sc))
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

        def pix(q, hi):
            return torch.clamp(torch.where(valid, q, 0.0), 0, hi).to(
                torch.int64)

        T = rnd.tile
        rect = torch.stack([pix(umin, W - 1) // T, pix(vmin, H - 1) // T,
                            pix(umax, W - 1) // T, pix(vmax, H - 1) // T], -1)
        rect[:, 2:] = torch.where(valid[:, None], rect[:, 2:], rect[:, :2] - 1)

    det = torch.clamp(sa * sc - sb * sb, min=1e-12)
    inv = 1.0 / det
    conic = torch.stack([torch.clamp(sc * inv, min=rnd.min_conic), -sb * inv,
                         torch.clamp(sa * inv, min=rnd.min_conic)], dim=-1)
    return {"uv": torch.stack([u, v], -1), "depth": z, "conic": conic,
            "opacity": opacity, "rgb": rgb, "valid": valid, "rect": rect}


def cov_activated(s, q):
    """Packed covariance [N, 6] of R diag(s^2) R^T, ``q`` a unit
    quaternion (x, y, z, w), ``s`` positive: ``render.cov3d``'s arithmetic
    without the activation."""
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
    s2 = s ** 2
    s0, s1, s2_ = s2.unbind(-1)

    def sig(a0, a1, a2, b0, b1, b2):
        return s0 * a0 * b0 + s1 * a1 * b1 + s2_ * a2 * b2

    return torch.stack([
        sig(r00, r01, r02, r00, r01, r02), sig(r00, r01, r02, r10, r11, r12),
        sig(r00, r01, r02, r20, r21, r22), sig(r10, r11, r12, r10, r11, r12),
        sig(r10, r11, r12, r20, r21, r22), sig(r20, r21, r22, r20, r21, r22),
    ], dim=-1)


def visible(params: dict, alive, cam: ref.Camera, rnd: ref.Renderer, dtype):
    """[A] bool: the anchor cull (module docstring), without autograd."""
    with torch.no_grad():
        pos = params["pos"].to(dtype)
        l = torch.clamp(torch.exp(params["scale_raw"][:, :3].to(dtype)),
                        min=1e-6)
        ident = torch.zeros(pos.shape[0], 4, dtype=dtype, device=pos.device)
        ident[:, 3] = 1.0
        ones = torch.ones_like(pos[:, 0])
        return project_activated(pos, cov_activated(l, ident), ones, alive,
                                 None, cam, rnd, dtype)["valid"]


def decode(params: dict, vis, cam: ref.Camera, sc: Scaffold, dtype):
    """The neural gaussians of every anchor, slot-major (slot ``i`` of
    anchor ``a`` is row ``i A + a``): {mu [S, 3], s [S, 3], q [S, 4] (x, y,
    z, w), alpha [S], color [S, 3], keep [S]}, worked in blocks of
    ``DECODE_BLOCK`` anchors. Autograd records it where the leaves
    require grad."""
    _tf32_off()
    dev = params["pos"].device
    A, k = params["pos"].shape[0], sc.n_offsets
    c = torch.as_tensor(cam.c2w, dtype=torch.float32, device=dev)[:3, 3] \
        .to(dtype)
    shapes = mlp_shapes(sc)
    nets = {n: split(params[n].to(dtype), shapes[n]) for n in MLP_KEYS}
    parts = {f: [] for f in FIELDS}
    for a0 in range(0, A, DECODE_BLOCK):
        blk = slice(a0, min(A, a0 + DECODE_BLOCK))
        pos, off, feat, sraw = (params[n][blk].to(dtype) for n in ANCHOR_KEYS)
        n = pos.shape[0]
        dvec = pos - c[None, :]
        dvec = dvec / torch.sqrt(torch.sum(dvec * dvec, dim=-1, keepdim=True))
        z = torch.cat([feat, dvec], dim=-1)

        def head(name):
            w1, b1, w2, b2 = nets[name]
            h = torch.clamp(z @ w1.T + b1, min=0.0)
            return (h @ w2.T + b2).reshape(n, k, SLOT_FIELDS[name])

        l = torch.exp(sraw)
        cov = head("mlp_cov")
        q = cov[..., 3:]
        q = q / torch.clamp(torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True)),
                            min=1e-12)
        parts["alpha"].append(torch.tanh(head("mlp_opacity"))[..., 0])
        parts["mu"].append(pos[:, None] + off.reshape(n, k, 3) * l[:, None, :3])
        parts["s"].append(l[:, None, 3:] * torch.sigmoid(cov[..., :3]))
        parts["q"].append(q[..., [1, 2, 3, 0]])
        parts["color"].append(torch.sigmoid(head("mlp_color")))
    out = {}
    for f, ps in parts.items():
        x = torch.cat(ps)  # [A, k, ...]
        out[f] = x.transpose(0, 1).reshape((k * A,) + x.shape[2:])
    out["keep"] = (vis[None, :] & (out["alpha"].reshape(k, A) > 0)) \
        .reshape(k * A)
    return out


def scaling_term(s, keep):
    """The mean over the kept slots of s_x s_y s_z."""
    prod = torch.where(keep, s[:, 0] * s[:, 1] * s[:, 2], 0.0)
    return torch.sum(prod) / torch.clamp(torch.sum(keep.to(s.dtype)),
                                         min=1.0)


def splats(dec: dict, cam: ref.Camera, rnd: ref.Renderer, dtype):
    """The kept neural gaussians' splats (every slot, masked ones culled)."""
    cov = cov_activated(dec["s"], dec["q"])
    return project_activated(dec["mu"], cov, dec["alpha"], dec["keep"],
                             dec["color"], cam, rnd, dtype)


def _frame(sp: dict, cam: ref.Camera, rnd: ref.Renderer, dtype, count_work):
    """``render.render``'s binning and compositing of the splats."""
    bn = ref.bin_pairs(sp, cam, rnd)
    feat = ref._feat(sp, bn.vis)
    P = rnd.tile * rnd.tile
    out = torch.zeros(bn.tiles_x * bn.tiles_y, P, 3, dtype=dtype,
                      device=feat.device)
    work = torch.zeros(3, dtype=torch.int64, device=feat.device)
    for tiles, K in ref._tile_chunks(bn, ref.FRAME_BUDGET, P):
        acc, w = ref.composite_chunk(feat, bn, tiles, K, rnd,
                                     count_work=count_work)
        out[tiles] = acc
        if count_work:
            work += w
    img = torch.clamp(ref._assemble(out, bn, cam, rnd.tile), 0.0, 1.0)
    counts = None
    if count_work:
        counts = {"gaussians": int(bn.vis.shape[0]),
                  "pairs": int(bn.gauss.shape[0]),
                  "live_pairs": int(work[1]),
                  "contrib_pairs": int(work[2]),
                  "pair_pixels": int(work[0]),
                  "pixels": cam.height * cam.width}
    return img.float(), counts


def render(params: dict, alive, cam: ref.Camera, rnd: ref.Renderer,
           sc: Scaffold, dtype=torch.float32, count_work=False):
    """The frame [H, W, 3] (float32, clamped to [0, 1]) and, with
    ``count_work``, the work counts: ``render.render``'s (neural gaussians
    in view, pairs, live and contributing pairs, composited (pair, pixel),
    pixels), the anchors, the visible anchors and the kept slots."""
    with torch.no_grad():
        vis = visible(params, alive, cam, rnd, dtype)
        dec = decode(params, vis, cam, sc, dtype)
        img, counts = _frame(splats(dec, cam, rnd, dtype), cam, rnd, dtype,
                             count_work)
    if count_work:
        counts.update(anchors=int(vis.shape[0]),
                      visible_anchors=int(vis.sum()),
                      kept_slots=int(dec["keep"].sum()))
    return img, counts


def render_grad(params: dict, alive, cam: ref.Camera, rnd: ref.Renderer,
                sc: Scaffold, target, t: dict, dtype=torch.float32):
    """Loss of the frame against ``target`` and its gradients: (loss,
    {leaf: grad} of every leaf but ``pos``, the decoded fields detached).
    ``render.render_grad``'s two passes: the frame without autograd, the
    image's gradient, then tile chunk by tile chunk the composite under
    autograd into the splats' features, and those with the scaling
    term's back through the projection and the decode."""
    _tf32_off()
    leaves = {k: v.detach().to(dtype).requires_grad_(k != "pos")
              for k, v in params.items()}
    vis = visible(leaves, alive, cam, rnd, dtype)
    dec = decode(leaves, vis, cam, sc, dtype)
    sp = splats(dec, cam, rnd, dtype)
    with torch.no_grad():
        bn = ref.bin_pairs(sp, cam, rnd)
    feat = ref._feat(sp, bn.vis)
    feat_leaf = feat.detach().requires_grad_(True)
    P = rnd.tile * rnd.tile
    chunks = ref._tile_chunks(bn, ref.GRAD_BUDGET, P)
    with torch.no_grad():
        out = torch.zeros(bn.tiles_x * bn.tiles_y, P, 3, dtype=dtype,
                          device=feat.device)
        for tiles, K in chunks:
            out[tiles] = ref.composite_chunk(feat_leaf, bn, tiles, K, rnd)[0]
    raw = ref._assemble(out, bn, cam, rnd.tile)
    img = raw.detach().requires_grad_(True)
    photo = ref.photo_loss(target, t["lambda_l1"], t["lambda_ssim"])(
        torch.clamp(img, 0.0, 1.0))
    (g_img,) = torch.autograd.grad(photo, img)
    tl = rnd.tile
    g_pad = torch.zeros(bn.tiles_y * tl, bn.tiles_x * tl, 3, dtype=dtype,
                        device=img.device)
    g_pad[: cam.height, : cam.width] = g_img
    g_tiles = g_pad.reshape(bn.tiles_y, tl, bn.tiles_x, tl, 3).permute(
        0, 2, 1, 3, 4).reshape(bn.tiles_x * bn.tiles_y, P, 3)
    for tiles, K in chunks:
        acc = ref.composite_chunk(feat_leaf, bn, tiles, K, rnd)[0]
        torch.autograd.backward(acc, g_tiles[tiles])
    g_feat = feat_leaf.grad if feat_leaf.grad is not None \
        else torch.zeros_like(feat_leaf)
    reg = scaling_term(dec["s"], dec["keep"])
    weight = t.get("scaling_reg", sc.scaling_reg)
    torch.autograd.backward(
        [feat, reg], [g_feat, torch.full_like(reg, weight)])
    loss = float(photo.detach()) + weight * float(reg.detach())
    grads = {k: (v.grad if v.grad is not None else torch.zeros_like(v))
             .float() for k, v in leaves.items() if k != "pos"}
    fields = {f: dec[f].detach() for f in FIELDS + ("keep",)}
    return loss, grads, fields


def scheduled_lr(step: int, init: float, final: float, delay_mult: float,
                 max_steps: int) -> float:
    """``render.position_lr``'s schedule from ``init`` to ``final``."""
    return ref.position_lr(step, {
        "position_lr_init": init, "position_lr_final": final,
        "position_lr_delay_mult": delay_mult,
        "position_lr_max_steps": max_steps})


def leaf_lrs(t: dict, step: int) -> dict:
    """Every trained leaf's rate at ``step``: the offsets and the MLPs on
    their schedules, the features and scales fixed."""
    lrs = {"anchor_feat": t["feature_lr"], "scale_raw": t["scaling_lr"]}
    for k in ("offset",) + MLP_KEYS:
        lrs[k] = scheduled_lr(step, t[f"{k}_lr_init"], t[f"{k}_lr_final"],
                              t["lr_delay_mult"], t["lr_max_steps"])
    return lrs


class ScaffoldAdam(ref.Adam):
    """``render.Adam`` (beta 0.9, 0.999) over the trained leaves: no clip;
    the anchors' gradients zeroed at dead anchors, the MLPs' kept whole;
    the rates of :func:`leaf_lrs`; ``pos`` left as it is."""

    def prepare(self, grads: dict, alive) -> dict:
        g = {k: v.to(self.dtype) for k, v in grads.items()}
        if alive is not None:
            g = {k: (v if k in MLP_KEYS else torch.where(
                alive.reshape((-1,) + (1,) * (v.dim() - 1)), v, 0.0))
                for k, v in g.items()}
        return g

    def step(self, params: dict, grads: dict) -> dict:
        b1, b2, eps = 0.9, 0.999, self.t["adam_eps"]
        lrs = leaf_lrs(self.t, self.count)
        self.count += 1
        bc1 = 1 - b1 ** self.count
        bc2 = 1 - b2 ** self.count
        out = {}
        for k, p in params.items():
            if k not in grads:
                out[k] = p
                continue
            g = grads[k]
            self.m[k] = b1 * self.m[k] + (1 - b1) * g
            self.v[k] = b2 * self.v[k] + (1 - b2) * g * g
            denom = torch.sqrt(self.v[k]) / math.sqrt(bc2) + eps
            out[k] = (p.to(self.dtype)
                      - (lrs[k] / bc1) * self.m[k] / denom).to(p.dtype)
        return out

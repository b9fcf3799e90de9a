"""Scaffold-GS's per-view stage (Lu et al., CVPR 2024, arXiv:2312.00109):
anchors decoded into neural gaussians by three view-conditioned MLPs.

An anchor ``a`` holds a position ``x_a``, ``k`` offsets ``O_a`` (``[A,
3k]``), a feature ``f_a`` (``[A, F]``) and six scales ``l_a =
exp(scale_raw_a)``. For a view with camera centre ``c``:

* the anchor cull (:func:`anchor_visible`): an anchor is visible where a
  gaussian at ``x_a`` with covariance ``diag(l_a[0:3]^2)`` (each scale
  floored at 1e-6, as the 3DGS stages floor theirs) and full opacity
  passes the projection's validity (near, far, the guard band, finite
  values, the rectangle touching the image; the opacity pre-filter
  aside) and the anchor is alive: the 3DGS stages' validity of a
  gaussian at the anchor with raw scales ``scale_raw[:, :3]``, the
  identity rotation and opacity ``sigmoid(+inf) = 1``, which on a card is
  one P1 launch (``preprocess.preprocess_cuda``, equal to the plain chain
  bit for bit);
* ``d = (x_a - c) / |x_a - c|``, ``z = [f_a, d]``; three MLPs
  ``Linear(F + 3, H) -> ReLU -> Linear(H, m)``, float32, give per slot
  ``i`` of ``k``: the opacity ``alpha = tanh(.)`` (m = k), the scale and
  rotation ``(sigma, q) `` (m = 7k) and the colour ``sigmoid(.)`` (m =
  3k);
* neural gaussian ``i``: ``mu = x_a + O_{a,i} * l_a[0:3]``, ``s =
  l_a[3:6] * sigmoid(sigma)``, the rotation ``q / max(|q|, 1e-12)`` in
  the authors' (w, x, y, z) order, returned as the port's (x, y, z, w),
  ``alpha`` and the colour;
* the slots are slot-major: slot ``i`` of anchor ``a`` is row ``i A + a``
  of every field;
* the slot is kept where its anchor is visible and ``alpha > 0``
  (``keep``): the rest stay at their fixed place in ``[k A]``, and the
  projection (``projection.project_activated``, ``extra_valid=keep``)
  culls them, so they contribute nothing and take no gradient.

:func:`decode` runs D1 (``csrc/scaffold.cu``) on CUDA tensors: under
autograd as :class:`_Decode`, whose backward is D2 (the anchors' and the
MLPs' gradients; the weights' as per-CTA partial sums reduced in a fixed
order, so deterministic); CPU tensors take :func:`decode_plain`, the same
equations in PyTorch (``x @ W.T + b``). D1 and D2 compute in float32 with
no tensor cores; their sums run in another order than a matrix library's,
so they equal the plain decode to rounding, not bit for bit. Their
library is built and loaded at the first decode on a card.

The anchor positions take no gradient (the authors' rate is 0). The
loss adds :func:`scaling_term`, the mean over the kept slots of ``s_x
s_y s_z`` (the authors' ``scaling_reg``).

Spans: the cull and D1 run inside ``gs.decode``, D2 inside
``gs.decode_bwd`` (on autograd's thread, inside ``gs.backward``).
"""

from __future__ import annotations

import ctypes

import torch

from ..config import (ANCHOR_KEYS, MLP_KEYS, SCAFFOLD_WIDTHS, RenderConfig,
                      SLOT_FIELDS)
from ..models.gaussians import check_anchor_leaves
from ..utils.profiling import span
from .gaussian import build_cov3d_packed
from .preprocess import preprocess_cuda
from .projection import project_activated

TILE = 16


def check_params(params: dict):
    """Raise ``ValueError`` unless ``params`` hold an anchor pool's leaves
    (``models.gaussians.check_anchor_leaves``) and its three MLPs at
    widths that match them."""
    check_anchor_leaves(params)
    missing = [k for k in MLP_KEYS if k not in params]
    if missing:
        raise ValueError(f"an anchor pool renders with its MLPs: {missing} "
                         f"missing (models.gaussians.init_anchor_mlps "
                         f"draws them)")
    F, k = widths(params)
    for name, m in SLOT_FIELDS.items():
        n = params[name].numel()
        # numel = H (F + 3) + H + m k H + m k = H (F + 4 + m k) + m k
        h, rem = divmod(n - m * k, F + 4 + m * k)
        if rem or h < 1 or params[name].dim() != 1:
            raise ValueError(f"{name} has {n} floats: not an MLP "
                             f"Linear({F + 3}, H) -> Linear(H, {m * k})")


def widths(params: dict) -> tuple:
    """(feature width F, offsets a anchor k) of an anchor pool."""
    return params["anchor_feat"].shape[1], params["offset"].shape[1] // 3


def hidden_width(params: dict) -> int:
    """The MLPs' hidden width H, from the opacity MLP's floats."""
    F, k = widths(params)
    m = SLOT_FIELDS["mlp_opacity"] * k
    return (params["mlp_opacity"].numel() - m) // (F + 4 + m)


def split_mlp(flat: torch.Tensor, inputs: int, hidden: int, outputs: int):
    """(W1 [hidden, inputs], b1, W2 [outputs, hidden], b2): views of a flat
    MLP tensor (``models.gaussians.init_anchor_mlps``' layout)."""
    a = hidden * inputs
    b = a + hidden
    c = b + outputs * hidden
    return (flat[:a].view(hidden, inputs), flat[a:b],
            flat[b:c].view(outputs, hidden), flat[c:])


def check_config(cfg: RenderConfig):
    """Raise ``ValueError`` unless an anchor pool's neural gaussians can
    be rendered with ``cfg``: the kernel compositor at tile 16 with cumprod
    transmittance, one view, no compacted backward."""
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
    if cfg.backend not in ("auto", "pallas"):
        why.append(f"the kernel compositor, backend 'auto' or 'pallas' "
                   f"(got {cfg.backend!r})")
    if why:
        raise ValueError("an anchor pool (Scaffold-GS) renders with "
                         + "; ".join(why))


def anchor_visible(params: dict, c2w: torch.Tensor, fx, fy, cx, cy,
                   cfg: RenderConfig, alive=None) -> torch.Tensor:
    """[A] bool: the anchor cull (module docstring), without autograd: P1
    on a card, the plain chain (``build_cov3d_packed``,
    ``project_activated``) on the CPU."""
    with torch.no_grad():
        pos = params["pos"].detach()
        ident = torch.zeros(pos.shape[0], 4, dtype=pos.dtype,
                            device=pos.device)
        ident[:, 3] = 1.0
        pseudo = {"pos": pos, "q_raw": ident,
                  "scale_raw": params["scale_raw"][:, :3].detach().contiguous(),
                  "opacity_raw": torch.full_like(pos[:, 0], float("inf"))}
        if pos.device.type == "cuda":
            return preprocess_cuda(pseudo, c2w, fx, fy, cx, cy, cfg, alive,
                                   colour=False)[0].valid
        cov = build_cov3d_packed(pseudo["scale_raw"], ident)
        return project_activated(pos, cov, torch.ones_like(pos[:, 0]), c2w,
                                 fx, fy, cx, cy, cfg, extra_valid=alive).valid


def decode_plain(params: dict, visible: torch.Tensor, cam: torch.Tensor):
    """The decode in PyTorch: (mu [S, 3], s [S, 3], q [S, 4] (x, y, z, w),
    alpha [S], colour [S, 3], keep [S] bool) for the ``S = k A`` slots,
    slot-major; ``cam`` [3] the camera centre. Autograd records it."""
    pos, off, feat, sraw = (params[k] for k in ANCHOR_KEYS)
    A = pos.shape[0]
    F, k = widths(params)
    H = hidden_width(params)
    d = pos - cam
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    z = torch.cat([feat, d], dim=-1)

    def mlp(name):
        """[k, A, m] of the head ``name``: slot-major."""
        m = SLOT_FIELDS[name]
        w1, b1, w2, b2 = split_mlp(params[name], F + 3, H, m * k)
        h = torch.relu(z @ w1.T + b1)
        return (h @ w2.T + b2).reshape(A, k, m).transpose(0, 1)

    alpha = torch.tanh(mlp("mlp_opacity")).reshape(k * A)
    cov = mlp("mlp_cov")
    colour = torch.sigmoid(mlp("mlp_color")).reshape(k * A, 3)
    l = torch.exp(sraw)
    mu = (pos[None] + off.reshape(A, k, 3).transpose(0, 1) * l[None, :, :3]
          ).reshape(k * A, 3)
    s = (l[None, :, 3:] * torch.sigmoid(cov[..., :3])).reshape(k * A, 3)
    q = cov[..., 3:].reshape(k * A, 4)
    q = q / torch.clamp_min(torch.linalg.vector_norm(q, dim=-1,
                                                     keepdim=True), 1e-12)
    q = q[:, [1, 2, 3, 0]]
    keep = (visible[None, :] & (alpha.reshape(k, A) > 0)).reshape(k * A)
    return mu, s, q, alpha, colour, keep


def decode(params: dict, visible: torch.Tensor, cam: torch.Tensor):
    """The decode of :func:`decode_plain`'s signature: D1 (and D2 under
    autograd) on CUDA tensors, :func:`decode_plain` on CPU tensors."""
    if params["pos"].device.type != "cuda":
        return decode_plain(params, visible, cam)
    leaves = [params[k] for k in ANCHOR_KEYS[1:] + MLP_KEYS]
    if torch.is_grad_enabled() and any(t.requires_grad for t in leaves):
        return _Decode.apply(params["pos"], *leaves, visible, cam)
    with torch.no_grad():
        return decode_cuda(params, visible, cam)


def scaling_term(s: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """The mean over the kept slots of ``s_x s_y s_z`` (0 where none is
    kept): a 0-d tensor, its count a tensor (no host sync)."""
    prod = torch.where(keep, s[:, 0] * s[:, 1] * s[:, 2], 0.0)
    n = torch.clamp_min(torch.sum(keep.to(s.dtype)), 1.0)
    return torch.sum(prod) / n


def decode_view(params: dict, c2w: torch.Tensor, fx, fy, cx, cy,
                cfg: RenderConfig, alive=None):
    """A view's neural gaussians: the cull and the decode inside
    ``gs.decode`` (:func:`decode_plain`'s six fields)."""
    with span("gs.decode"):
        visible = anchor_visible(params, c2w, fx, fy, cx, cy, cfg, alive)
        return decode(params, visible, c2w[:3, 3].contiguous())


def refuse(params: dict, cfg: RenderConfig, uv_tap=None):
    """The refusals of an anchor pool's render (``ValueError``)."""
    check_params(params)
    check_config(cfg)
    if uv_tap is not None:
        raise ValueError("an anchor pool has no view-space tap: the paper "
                         "ADC's statistic is of stored gaussians, and "
                         "anchors grow by their own rule")


# -- D1 and D2 ------------------------------------------------------------

def _check(t, name: str, dev, dtype, shape):
    if not (isinstance(t, torch.Tensor) and t.device == dev
            and t.dtype == dtype and t.is_contiguous()
            and tuple(t.shape) == tuple(shape)):
        got = (f"{tuple(t.shape)} {t.dtype} on {t.device}"
               if isinstance(t, torch.Tensor) else type(t).__name__)
        raise ValueError(f"{name} must be contiguous {list(shape)} {dtype} "
                         f"on {dev}, got {got}")


def _inputs(params: dict, visible, cam):
    """D1's and D2's inputs checked: (A, the tensors by name)."""
    pos = params["pos"]
    dev = pos.device
    if dev.type != "cuda":
        raise ValueError(f"D1 and D2 run on a CUDA card, not {dev}")
    F, k = widths(params)
    H = hidden_width(params)
    if (F, k, H) != SCAFFOLD_WIDTHS:
        raise ValueError(f"D1 and D2 are built for the published widths "
                         f"(feature, offsets, hidden) {SCAFFOLD_WIDTHS}, got "
                         f"{(F, k, H)}")
    A = pos.shape[0]
    if A * k * 4 >= 2**31:
        raise ValueError(f"{A} anchors: D1 and D2 index with int32")
    ins = {"pos": pos, "offset": params["offset"],
           "anchor_feat": params["anchor_feat"],
           "scale_raw": params["scale_raw"]}
    ins = {n: t.detach() for n, t in ins.items()}
    for n, w in (("pos", 3), ("offset", 3 * k), ("anchor_feat", F),
                 ("scale_raw", 6)):
        _check(ins[n], n, dev, torch.float32, (A, w))
    for n in MLP_KEYS:
        ins[n] = params[n].detach()
        _check(ins[n], n, dev, torch.float32, (params[n].numel(),))
    _check(visible, "visible", dev, torch.bool, (A,))
    _check(cam, "cam", dev, torch.float32, (3,))
    ins["visible"], ins["cam"] = visible, cam
    return A, k, ins


class _Args(ctypes.Structure):
    """``csrc/scaffold.cu``'s ``Args``, field for field."""

    _fields_ = [(n, ctypes.c_void_p) for n in (
        "pos", "offset", "feat", "scale_raw", "w_opacity", "w_cov",
        "w_color", "visible", "cam", "mu", "s", "q", "alpha", "color",
        "keep", "g_mu", "g_s", "g_q", "g_alpha", "g_color", "d_offset",
        "d_feat", "d_scale_raw", "d_w", "partials")] + [
        ("anchors", ctypes.c_int)]


def _args(ins: dict, A: int, **ptrs) -> _Args:
    a = _Args(anchors=A)
    names = {"anchor_feat": "feat", "mlp_opacity": "w_opacity",
             "mlp_cov": "w_cov", "mlp_color": "w_color"}
    for n, t in ins.items():
        setattr(a, names.get(n, n), t.data_ptr())
    for n, t in ptrs.items():
        setattr(a, n, t.data_ptr())
    return a


def decode_cuda(params: dict, visible: torch.Tensor, cam: torch.Tensor):
    """D1 over every anchor: :func:`decode_plain`'s six fields, its
    invisible anchors' slots zero (``keep`` false). Checks every input and
    raises before any launch; counted in ``decode_cuda.launches``."""
    A, k, ins = _inputs(params, visible, cam)
    dev = params["pos"].device
    S = A * k

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    outs = {"mu": empty(S, 3), "s": empty(S, 3), "q": empty(S, 4),
            "alpha": empty(S), "color": empty(S, 3),
            "keep": empty(S, dtype=torch.bool)}
    if A > 0:
        lib = _library()
        args = _args(ins, A, **outs)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.scaffold_decode(ctypes.byref(args), stream)
        if err != 0:
            raise RuntimeError(f"scaffold_decode launch failed: CUDA error "
                               f"{err}")
        decode_cuda.launches += 1
    return (outs["mu"], outs["s"], outs["q"], outs["alpha"], outs["color"],
            outs["keep"])


decode_cuda.launches = 0  # D1 launches


def decode_bwd_cuda(params: dict, visible, cam, keep, grads):
    """D2: (d offset [A, 3k], d anchor_feat [A, F], d scale_raw [A, 6],
    {MLP leaf: d flat weights}) from the slots' gradients ``grads`` (mu,
    s, q, alpha, colour; masked slots' are not read). Counted in
    ``decode_bwd_cuda.launches`` (the partial sums and their reduction
    are one call)."""
    A, k, ins = _inputs(params, visible, cam)
    dev = params["pos"].device
    S = A * k
    _check(keep, "keep", dev, torch.bool, (S,))
    g = {}
    for n, t, w in zip(("g_mu", "g_s", "g_q", "g_alpha", "g_color"), grads,
                       (3, 3, 4, None, 3)):
        t = t.contiguous()
        _check(t, n, dev, torch.float32, (S,) if w is None else (S, w))
        g[n] = t
    F = ins["anchor_feat"].shape[1]
    sizes = [ins[n].numel() for n in MLP_KEYS]
    # D2 writes the visible anchors' rows: the others stay zero.
    d_off = torch.zeros(A, 3 * k, dtype=torch.float32, device=dev)
    d_feat = torch.zeros(A, F, dtype=torch.float32, device=dev)
    d_sc = torch.zeros(A, 6, dtype=torch.float32, device=dev)
    d_w = torch.zeros(sum(sizes), dtype=torch.float32, device=dev)
    if A > 0:
        lib = _library()
        ctas = ctypes.c_int(0)
        err = lib.scaffold_decode_bwd_ctas(ctypes.byref(ctas))
        if err != 0:
            raise RuntimeError(f"scaffold_decode_bwd_ctas failed: CUDA error "
                               f"{err}")
        partials = torch.empty(ctas.value, sum(sizes), dtype=torch.float32,
                               device=dev)
        args = _args(ins, A, keep=keep, d_offset=d_off, d_feat=d_feat,
                     d_scale_raw=d_sc, d_w=d_w, partials=partials, **g)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.scaffold_decode_bwd(ctypes.byref(args), ctas.value,
                                          stream)
        if err != 0:
            raise RuntimeError(f"scaffold_decode_bwd launch failed: CUDA "
                               f"error {err}")
        decode_bwd_cuda.launches += 1
    dws = dict(zip(MLP_KEYS, torch.split(d_w, sizes)))
    return d_off, d_feat, d_sc, dws


decode_bwd_cuda.launches = 0  # D2 calls


class _Decode(torch.autograd.Function):
    """D1 forward, D2 backward (module docstring). Inputs: pos (no
    gradient), offset, anchor_feat, scale_raw, the three flat MLPs,
    visible, cam."""

    @staticmethod
    def forward(ctx, pos, offset, feat, scale_raw, w_op, w_cov, w_col,
                visible, cam):
        params = dict(zip(ANCHOR_KEYS + MLP_KEYS,
                          (pos, offset, feat, scale_raw, w_op, w_cov,
                           w_col)))
        out = decode_cuda(params, visible, cam)
        ctx.save_for_backward(pos, offset, feat, scale_raw, w_op, w_cov,
                              w_col, visible, cam, out[5])
        ctx.mark_non_differentiable(out[5])
        return out

    @staticmethod
    def backward(ctx, g_mu, g_s, g_q, g_alpha, g_col, _g_keep):
        pos, offset, feat, scale_raw, w_op, w_cov, w_col, visible, cam, \
            keep = ctx.saved_tensors
        params = dict(zip(ANCHOR_KEYS + MLP_KEYS,
                          (pos, offset, feat, scale_raw, w_op, w_cov,
                           w_col)))
        with span("gs.decode_bwd"):
            d_off, d_feat, d_sc, dws = decode_bwd_cuda(
                params, visible, cam, keep,
                (g_mu, g_s, g_q, g_alpha, g_col))
        return (None, d_off, d_feat, d_sc, dws["mlp_opacity"],
                dws["mlp_cov"], dws["mlp_color"], None, None)


def _library():
    from ._build import load_library

    lib = load_library("scaffold")
    if lib.scaffold_args_bytes() != ctypes.sizeof(_Args):
        raise RuntimeError("csrc/scaffold.cu's Args does not match "
                           "ops/scaffold.py's _Args")
    return lib

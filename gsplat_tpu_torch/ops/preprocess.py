"""The per-gaussian stages of a view in one place: the packed covariance,
the SH colour and the projection, as the plain chain or as one kernel.

:func:`preprocess` is what ``render.render_from_params``,
``render.pair_demand`` and ``render.render_batch_from_params`` call. It
launches P1 (``csrc/preprocess.cu``, through :func:`preprocess_cuda`)
where :func:`kernel_applies` holds: the leaves are on a CUDA card, there
is no ``uv_tap``, and autograd does not record them (``torch.no_grad()``,
or no leaf, pose or intrinsic requires grad). Serving, evaluation and the
capacity probes take it; a training step's forward records autograd and
takes :func:`preprocess_plain`, the three functions P1 replaces
(``gaussian.build_cov3d_packed``, ``sh.evaluate_sh``,
``projection.project_gaussians``), as do CPU tensors. On that path a
CUDA input P1 cannot take (another dtype, shape or layout, f_rest beyond
SH degree 3, an intrinsic that is neither a number nor a 0-d float32
tensor on the card) raises in :func:`preprocess_cuda`; it never falls
back. P1 equals the plain chain on the card bit for bit (every field,
NaNs of dead slots included).

Spans: the plain chain opens ``gs.cov_sh`` (covariance, colour) and
``gs.project``; P1 launches inside ``gs.project`` and opens no
``gs.cov_sh``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..config import RenderConfig, is_surfel_pool
from ..utils.profiling import span
from .gaussian import build_cov3d_packed
from .projection import ProjectedGaussians, project_gaussians
from .sh import evaluate_sh

# The RenderConfig fields project_gaussians reads, each carried by P1's
# argument pack (:func:`pack_args`).
PACKED_FIELDS = ("height", "width", "tile", "near", "far", "pix_guard",
                 "pix_guard_v", "alpha_cutoff", "chi2_clip", "min_conic",
                 "aa_mode", "aa_dilation")
AA_MODES = {"none": 0, "dilate": 1, "mip": 2}
REST_WIDTHS = {0: 1, 9: 4, 24: 9, 45: 16}  # f_rest's width -> SH bases
_GEOMETRY = ("pos", "scale_raw", "q_raw", "opacity_raw")
_COLOUR = ("f_dc", "f_rest")
_WIDE = ("pos", "scale_raw", "q_raw", "f_dc", "f_rest")  # read as float4
_WIDTHS = {"pos": 3, "scale_raw": 3, "q_raw": 4, "opacity_raw": None,
           "f_dc": 3}


def preprocess(params: dict, c2w: torch.Tensor, fx, fy, cx, cy,
               cfg: RenderConfig, alive: torch.Tensor | None = None,
               uv_tap: torch.Tensor | None = None, colour: bool = True,
               cov3d: torch.Tensor | None = None):
    """One view's per-gaussian stages.

    Args:
        params: the leaves (pos, scale_raw, q_raw, opacity_raw, and f_dc,
            f_rest where ``colour``), one device.
        c2w: [4, 4] f32 camera-to-world on that device.
        fx, fy, cx, cy: numbers or 0-d tensors.
        alive, uv_tap: as ``project_gaussians``' ``extra_valid``,
            ``uv_tap``.
        colour: compute the SH colour (``pair_demand`` does not).
        cov3d: the packed covariance of these leaves, where a caller
            rendering several views has it from the plain chain.

    Returns:
        (ProjectedGaussians, colours [N, 3] or None, the packed covariance
        the plain chain used, or None from P1).

    A surfel pool (a two-column ``scale_raw``) is refused, before P1 or
    the plain chain sees it: its stages are ``ops.surfel``'s.
    """
    if is_surfel_pool(params):
        raise ValueError("a surfel pool (two-column scale_raw) goes through "
                         "ops.surfel, not the 3DGS stages")
    if kernel_applies(params, c2w, (fx, fy, cx, cy), uv_tap, colour):
        with span("gs.project"):
            proj, colours = preprocess_cuda(params, c2w, fx, fy, cx, cy,
                                            cfg, alive, colour)
        return proj, colours, None
    return preprocess_plain(params, c2w, fx, fy, cx, cy, cfg, alive, uv_tap,
                            colour, cov3d)


def preprocess_plain(params: dict, c2w, fx, fy, cx, cy, cfg: RenderConfig,
                     alive=None, uv_tap=None, colour: bool = True,
                     cov3d=None):
    """The plain chain: ``build_cov3d_packed`` (unless ``cov3d`` is given),
    ``evaluate_sh`` (with ``colour``) and ``project_gaussians``. Arguments
    and return as :func:`preprocess`'s."""
    pos = params["pos"]
    colours = None
    with span("gs.cov_sh"):
        if cov3d is None:
            cov3d = build_cov3d_packed(params["scale_raw"], params["q_raw"])
        if colour:
            colours = evaluate_sh(params["f_dc"], params["f_rest"], pos, c2w)
    proj = project_gaussians(pos, cov3d, params["opacity_raw"], c2w, fx, fy,
                             cx, cy, cfg, extra_valid=alive, uv_tap=uv_tap)
    return proj, colours, cov3d


def _number(x) -> bool:
    return isinstance(x, (int, float)) and not isinstance(x, bool)


def kernel_applies(params: dict, c2w: torch.Tensor, intrinsics, uv_tap,
                   colour: bool) -> bool:
    """Whether :func:`preprocess` launches P1: the leaves are on a CUDA
    card, there is no ``uv_tap``, and autograd does not record the leaves
    P1 reads, the pose or a tensor intrinsic."""
    if params["pos"].device.type != "cuda" or uv_tap is not None:
        return False
    leaves = [params[k] for k in _GEOMETRY + (_COLOUR if colour else ())]
    return not _recorded(leaves + [c2w] + [
        x for x in intrinsics if isinstance(x, torch.Tensor)])


def _recorded(tensors) -> bool:
    """Whether autograd records an operation on ``tensors``."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


class _Args(ctypes.Structure):
    """``csrc/preprocess.cu``'s ``Args``, field for field."""

    _fields_ = [
        ("pos", ctypes.c_void_p), ("scale_raw", ctypes.c_void_p),
        ("q_raw", ctypes.c_void_p), ("opacity_raw", ctypes.c_void_p),
        ("f_dc", ctypes.c_void_p), ("f_rest", ctypes.c_void_p),
        ("alive", ctypes.c_void_p), ("c2w", ctypes.c_void_p),
        ("intr_ptr", ctypes.c_void_p * 4),
        ("uv", ctypes.c_void_p), ("depth", ctypes.c_void_p),
        ("conic", ctypes.c_void_p), ("opacity", ctypes.c_void_p),
        ("radius", ctypes.c_void_p), ("tile_min", ctypes.c_void_p),
        ("tile_max", ctypes.c_void_p), ("valid", ctypes.c_void_p),
        ("rgb", ctypes.c_void_p),
        ("intr", ctypes.c_float * 4),
        ("u_lo", ctypes.c_float), ("u_hi", ctypes.c_float),
        ("v_lo", ctypes.c_float), ("v_hi", ctypes.c_float),
        ("near_plane", ctypes.c_float), ("far_plane", ctypes.c_float),
        ("half_cutoff", ctypes.c_float), ("inv_cutoff", ctypes.c_float),
        ("chi2_clip", ctypes.c_float), ("min_conic", ctypes.c_float),
        ("aa_dilation", ctypes.c_float),
        ("n", ctypes.c_int), ("height", ctypes.c_int), ("width", ctypes.c_int),
        ("tile", ctypes.c_int), ("aa_mode", ctypes.c_int),
    ]


def pack_args(params: dict, c2w: torch.Tensor, intrinsics,
              cfg: RenderConfig, alive, outs: dict) -> _Args:
    """P1's argument pack: the tensors' addresses, and every field of
    :data:`PACKED_FIELDS` folded as the plain chain folds it. A number
    intrinsic goes by value, with the guard band's ``-pix_guard - cx`` and
    ``W + pix_guard - cx`` in Python's double; a tensor intrinsic by
    address, the kernel taking ``cx`` from ``-pix_guard`` and ``W +
    pix_guard`` in float, as PyTorch does. ``alpha_cutoff * 0.5`` in
    double; the division by ``alpha_cutoff`` as its float reciprocal (a
    tensor over a Python number on the card). Makes no launch."""
    if cfg.aa_mode not in AA_MODES:
        raise ValueError(f"unknown aa_mode {cfg.aa_mode!r}")
    colour = outs.get("rgb") is not None
    inputs = {k: params[k] for k in _GEOMETRY + (_COLOUR if colour else ())}
    a = _Args()
    for k, t in list(inputs.items()) + list(outs.items()):
        setattr(a, k, t.data_ptr() if t is not None else None)
    a.c2w = c2w.data_ptr()
    a.alive = alive.data_ptr() if alive is not None else None
    for j, x in enumerate(intrinsics):
        if _number(x):
            a.intr[j] = float(x)
        else:
            a.intr_ptr[j] = x.data_ptr()
    fx, fy, cx, cy = intrinsics
    H, W = cfg.height, cfg.width
    guard_v = cfg.pix_guard if cfg.pix_guard_v is None else cfg.pix_guard_v
    if _number(cx):
        a.u_lo, a.u_hi = -cfg.pix_guard - cx, W + cfg.pix_guard - cx
    else:
        a.u_lo, a.u_hi = -cfg.pix_guard, W + cfg.pix_guard
    if _number(cy):
        a.v_lo, a.v_hi = -guard_v - cy, H + guard_v - cy
    else:
        a.v_lo, a.v_hi = -guard_v, H + guard_v
    a.near_plane, a.far_plane = cfg.near, cfg.far
    a.half_cutoff = cfg.alpha_cutoff * 0.5
    a.inv_cutoff = float(np.float32(1.0) / np.float32(cfg.alpha_cutoff))
    a.chi2_clip, a.min_conic = cfg.chi2_clip, cfg.min_conic
    a.aa_dilation = cfg.aa_dilation
    a.aa_mode = AA_MODES[cfg.aa_mode]
    a.n = params["pos"].shape[0]
    a.height, a.width, a.tile = H, W, cfg.tile
    return a


def _check(t, name: str, dev, dtype, shape):
    if not (isinstance(t, torch.Tensor) and t.device == dev
            and t.dtype == dtype and t.is_contiguous()
            and tuple(t.shape) == tuple(shape)):
        got = (f"{tuple(t.shape)} {t.dtype} on {t.device}"
               if isinstance(t, torch.Tensor) else type(t).__name__)
        raise ValueError(f"{name} must be contiguous {list(shape)} {dtype} "
                         f"on {dev}, got {got}")


def preprocess_cuda(params: dict, c2w: torch.Tensor, fx, fy, cx, cy,
                    cfg: RenderConfig, alive=None, colour: bool = True):
    """P1 (``csrc/preprocess.cu``) over every slot: (ProjectedGaussians,
    colours [N, 3] or None), equal to :func:`preprocess_plain`'s bit for
    bit. Checks every input's device, dtype, shape and contiguity, and the
    16-byte alignment of the leaves it reads 16 bytes at a time, and
    raises before any launch; counted in ``preprocess_cuda.launches``."""
    pos = params["pos"]
    dev = pos.device
    n = pos.shape[0] if pos.dim() == 2 else -1
    for k in _GEOMETRY + (_COLOUR if colour else ()):
        w = params["f_rest"].shape[-1] if k == "f_rest" else _WIDTHS[k]
        _check(params.get(k), k, dev, torch.float32,
               (n,) if w is None else (n, w))
        if k in _WIDE and params[k].numel() and params[k].data_ptr() % 16:
            raise ValueError(f"{k} must start on a 16-byte boundary (a "
                             f"view at an offset does not; .clone() does)")
    sh_bases = 0
    if colour:
        width = params["f_rest"].shape[-1]
        if width not in REST_WIDTHS:
            raise ValueError(f"f_rest of width {width}: P1 takes "
                             f"{sorted(REST_WIDTHS)}")
        sh_bases = REST_WIDTHS[width]
    if alive is not None:
        _check(alive, "alive", dev, torch.bool, (n,))
    _check(c2w, "c2w", dev, torch.float32, (4, 4))
    for name, x in zip(("fx", "fy", "cx", "cy"), (fx, fy, cx, cy)):
        if not _number(x):
            _check(x, name, dev, torch.float32, ())
    if n >= 2**31:
        raise ValueError(f"{n} slots: P1 indexes with int32")
    if dev.type != "cuda":
        raise ValueError(f"P1 runs on a CUDA card, not {dev}")

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    outs = {"uv": empty(n, 2), "depth": empty(n), "conic": empty(n, 3),
            "opacity": empty(n), "radius": empty(n, dtype=torch.int32),
            "tile_min": empty(n, 2, dtype=torch.int32),
            "tile_max": empty(n, 2, dtype=torch.int32),
            "valid": empty(n, dtype=torch.bool),
            "rgb": empty(n, 3) if colour else None}
    args = pack_args(params, c2w, (fx, fy, cx, cy), cfg, alive, outs)
    if n > 0:
        lib = _library()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.preprocess(ctypes.byref(args), sh_bases, stream)
        if err != 0:
            raise RuntimeError(f"preprocess launch failed: CUDA error {err}")
        preprocess_cuda.launches += 1
    proj = ProjectedGaussians(
        uv=outs["uv"], depth=outs["depth"], conic=outs["conic"],
        opacity=outs["opacity"], radius=outs["radius"],
        tile_min=outs["tile_min"], tile_max=outs["tile_max"],
        valid=outs["valid"])
    return proj, outs["rgb"]


preprocess_cuda.launches = 0  # P1 launches


def _library():
    from ._build import load_library

    lib = load_library("preprocess")
    if lib.preprocess_args_bytes() != ctypes.sizeof(_Args):
        raise RuntimeError("csrc/preprocess.cu's Args does not match "
                           "ops/preprocess.py's _Args")
    return lib

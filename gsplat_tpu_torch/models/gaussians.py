"""Gaussian model state: a fixed-capacity parameter pool with an alive mask.

Counterpart of ``gsplat_tpu/models/gaussians.py``: every parameter has a
static ``capacity`` rows and ``alive`` marks the populated slots. Here
the pool is an ``nn.Module`` whose six parameters are ``nn.Parameter``s
(same names and layouts as the JAX pytree) and whose ``alive`` mask is a
buffer. The constructors from host arrays (``pool_from_numpy``,
``init_pool_from_points``, ``pool_from_dense``) take an explicit
``device``, ``"cuda"`` by default.

A pool may also carry per-gaussian features (Feature 3DGS): a seventh
parameter ``f_sem`` [capacity, C] (``config.FEATURE_KEY``), which
``params`` then lists last, so that everything that maps the pool's
leaves (the ADC's children, growth, compaction, checkpoints) carries it.
The JAX package has no such leaf.

A pool whose ``scale_raw`` leaf has two columns is a pool of surfels (2D
Gaussian Splatting, ``config.is_surfel_pool``); every function here
carries that leaf at its width (:func:`to_surfels` makes one).

A pool with an ``anchor_feat`` leaf is a pool of anchors (Scaffold-GS,
``config.is_anchor_pool``): its leaves are ``config.ANCHOR_KEYS``
(``pos`` [A, 3], ``offset`` [A, 3k], ``anchor_feat`` [A, F],
``scale_raw`` [A, 6]) and ``alive`` [A]; ``pos`` takes no gradient (the
authors' rate is 0). :func:`init_anchor_mlps` draws the three MLPs that
decode it.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..config import (ANCHOR_KEYS, ANCHOR_SCALES, FEATURE_KEY,
                      SCAFFOLD_WIDTHS, is_anchor_pool, mlp_shapes)
from ..device import resolve_device

PARAM_KEYS = ("pos", "opacity_raw", "f_dc", "f_rest", "scale_raw", "q_raw")
# Every leaf a pool may carry, in the order ``params`` lists them.
LEAF_KEYS = PARAM_KEYS + (FEATURE_KEY,) + tuple(
    k for k in ANCHOR_KEYS if k not in PARAM_KEYS)


def check_anchor_leaves(params: dict):
    """Raise ``ValueError`` unless ``params`` hold an anchor pool's leaves
    alone, at consistent widths: ``pos`` [A, 3], ``offset`` [A, 3k],
    ``anchor_feat`` [A, F] and ``scale_raw`` [A, 6]; no per-gaussian
    features and no other 3DGS leaf."""
    if FEATURE_KEY in params:
        raise ValueError("an anchor pool (anchor_feat) carries no "
                         "per-gaussian features (f_sem)")
    missing = [k for k in ANCHOR_KEYS if k not in params]
    if missing:
        raise ValueError(f"anchor pool leaves missing: {missing}")
    extra = [k for k in PARAM_KEYS if k in params and k not in ANCHOR_KEYS]
    if extra:
        raise ValueError(f"an anchor pool has no 3DGS leaves {extra}: its "
                         f"gaussians are decoded each view")
    pos, off, feat, sc = (params[k] for k in ANCHOR_KEYS)
    a = pos.shape[0]
    shapes_ok = (pos.dim() == 2 and pos.shape[1] == 3 and off.dim() == 2
                 and off.shape[1] % 3 == 0 and off.shape[1] > 0
                 and feat.dim() == 2 and sc.dim() == 2
                 and all(t.shape[0] == a for t in (off, feat, sc)))
    if not shapes_ok:
        raise ValueError(
            f"an anchor pool is pos [A, 3], offset [A, 3k], anchor_feat "
            f"[A, F] and scale_raw [A, {ANCHOR_SCALES}], got "
            f"{[tuple(params[k].shape) for k in ANCHOR_KEYS]}")
    if sc.shape[1] != ANCHOR_SCALES:
        raise ValueError(f"an anchor pool's scale_raw has {ANCHOR_SCALES} "
                         f"columns (a surfel's two, or 3DGS's three, do not "
                         f"go with anchors), got {sc.shape[1]}")


class GaussianPool(nn.Module):
    """Fixed-capacity Gaussian parameter pool."""

    def __init__(self, params: dict, alive: torch.Tensor):
        super().__init__()
        if is_anchor_pool(params):
            check_anchor_leaves(params)
            self.leaf_names = ANCHOR_KEYS
        else:
            missing = set(PARAM_KEYS) - set(params)
            if missing:
                raise ValueError(
                    f"pool parameters missing: {sorted(missing)}")
            self.leaf_names = PARAM_KEYS + (
                (FEATURE_KEY,) if FEATURE_KEY in params else ())
        anchors = is_anchor_pool(params)
        for k in self.leaf_names:
            self.register_parameter(k, nn.Parameter(
                params[k], requires_grad=not (anchors and k == "pos")))
        self.register_buffer("alive", alive)

    @property
    def params(self) -> dict:
        """The six parameters by name (and ``f_sem`` where the pool has
        features; an anchor pool's four leaves), as ``render_from_params``
        takes them."""
        return {k: getattr(self, k) for k in self.leaf_names}

    @property
    def capacity(self) -> int:
        return self.alive.shape[0]

    def num_alive(self) -> torch.Tensor:
        return torch.sum(self.alive.to(torch.int32))


def pool_from_numpy(params: dict, alive, device="cuda") -> GaussianPool:
    """Carry the JAX package's pool across: the same parameter names and
    layouts as numpy arrays, copied to f32 contiguous tensors on ``device``
    (never aliasing the caller's arrays: training updates them in place)."""
    dev = resolve_device(device)
    tensors = {
        k: torch.from_numpy(np.array(params[k], np.float32, order="C")).to(dev)
        for k in LEAF_KEYS
        if k in params
    }
    alive_t = torch.from_numpy(np.array(alive, bool, order="C")).to(dev)
    n = alive_t.shape[0]
    for k, v in tensors.items():
        if v.shape[0] != n:
            raise ValueError(f"{k} has {v.shape[0]} rows, alive has {n}")
    return GaussianPool(tensors, alive_t)


def _pad_rows(x: np.ndarray, capacity: int, fill=0.0) -> np.ndarray:
    out = np.full((capacity,) + x.shape[1:], fill, x.dtype)
    out[: x.shape[0]] = x
    return out


def init_pool_from_points(
    points: np.ndarray,
    capacity: int,
    num_sh_bands: int = 3,
    seed: int = 0,
    device="cuda",
) -> GaussianPool:
    """Initialize a pool from a point cloud (``gsplat_tpu/models/
    gaussians.py:37-89``, bit for bit: the same ``default_rng(seed)`` draws
    in the same order).

    scale_raw = randn * 0.1 - 2.0, identity quaternions (0, 0, 0, 1),
    opacity_raw = 0.1, f_dc = raw RGB (not inverse-sigmoided), f_rest =
    zeros. Colors are uniform random when the cloud has no RGB columns;
    [0, 255] colors are rescaled to [0, 1]. Dead slots get opacity_raw
    -10 and scale_raw -10 (culled even if a mask bug slipped through) and
    q_raw (0, 0, 0, 1).
    """
    points = np.asarray(points, dtype=np.float32)
    n = points.shape[0]
    if n > capacity:
        raise ValueError(f"point cloud ({n}) exceeds pool capacity ({capacity})")
    rng = np.random.default_rng(seed)

    pos = points[:, :3]
    if points.shape[1] >= 6:
        colors = points[:, 3:6]
        if colors.max() > 1.0:
            colors = colors / 255.0
    else:
        colors = rng.uniform(0, 1, (n, 3)).astype(np.float32)

    scale_raw = (rng.standard_normal((n, 3)) * 0.1 - 2.0).astype(np.float32)
    q_raw = np.zeros((n, 4), np.float32)
    q_raw[:, 3] = 1.0
    opacity_raw = np.full((n,), 0.1, np.float32)
    n_rest = {0: 0, 1: 9, 2: 9, 3: 45}[num_sh_bands]
    f_rest = np.zeros((n, n_rest), np.float32)

    params = {
        "pos": _pad_rows(pos, capacity),
        "opacity_raw": _pad_rows(opacity_raw, capacity, fill=-10.0),
        "f_dc": _pad_rows(colors.astype(np.float32), capacity),
        "f_rest": _pad_rows(f_rest, capacity),
        "scale_raw": _pad_rows(scale_raw, capacity, fill=-10.0),
        "q_raw": _pad_rows(q_raw, capacity),
    }
    params["q_raw"][n:, 3] = 1.0
    return pool_from_numpy(params, np.arange(capacity) < n, device)


def compact_pool(pool: GaussianPool) -> GaussianPool:
    """Repack alive slots to the front, on the pool's device (a new pool)."""
    alive = pool.alive
    order = torch.cat([torch.nonzero(alive).flatten(),
                       torch.nonzero(~alive).flatten()])
    n = int(torch.sum(alive))
    with torch.no_grad():
        params = {k: v[order] for k, v in pool.params.items()}
    new_alive = torch.arange(pool.capacity, device=alive.device) < n
    return GaussianPool(params, new_alive)


def export_params(pool: GaussianPool) -> dict:
    """Extract only the alive gaussians as dense numpy arrays (host side)."""
    alive = pool.alive.cpu().numpy()
    return {k: v.detach().cpu().numpy()[alive]
            for k, v in pool.params.items()}


def pool_from_dense(params: dict, capacity: int, device="cuda") -> GaussianPool:
    """Wrap dense [N, ...] parameter arrays into a capacity-C pool: zero
    rows after the N, with opacity_raw -10, scale_raw -10 and q_raw
    (0, 0, 0, 1) in the dead slots."""
    n = params["pos"].shape[0]
    if n > capacity:
        raise ValueError(f"{n} gaussians exceed capacity {capacity}")
    padded = {k: _pad_rows(np.asarray(params[k]), capacity)
              for k in LEAF_KEYS if k in params}
    padded["opacity_raw"][n:] = -10.0
    padded["scale_raw"][n:] = -10.0
    padded["q_raw"][n:, 3] = 1.0
    return pool_from_numpy(padded, np.arange(capacity) < n, device)


def with_features(pool: GaussianPool, features: torch.Tensor) -> GaussianPool:
    """A pool of ``pool``'s parameters (the same tensors) and ``alive``
    with per-gaussian features ``f_sem`` = ``features`` [capacity, C]."""
    if features.shape[0] != pool.capacity or features.dim() != 2:
        raise ValueError(f"features must be [{pool.capacity}, C], got "
                         f"{tuple(features.shape)}")
    params = {k: v.detach() for k, v in pool.params.items()}
    params[FEATURE_KEY] = features.to(pool.pos.device, torch.float32)
    return GaussianPool(params, pool.alive)


def to_surfels(pool: GaussianPool) -> GaussianPool:
    """A surfel pool of ``pool``'s parameters (the same tensors but
    ``scale_raw``, of which it keeps the first two columns) and
    ``alive``."""
    params = {k: v.detach() for k, v in pool.params.items()}
    params["scale_raw"] = params["scale_raw"][:, :2].contiguous()
    return GaussianPool(params, pool.alive)


def init_decoder(in_dim: int, out_dim: int, seed: int = 0,
                 device="cuda") -> dict:
    """The Feature 3DGS decoder, a 1x1 convolution with bias from ``in_dim``
    to ``out_dim`` channels, drawn as ``torch.nn.Conv2d`` draws its
    default: weight and bias uniform in +-1/sqrt(in_dim) (Kaiming-uniform
    with a = sqrt(5) gives that bound), from ``torch.Generator(seed)`` on
    ``device``. Returns {"dec_w": [out_dim, in_dim], "dec_b": [out_dim]}."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    bound = 1.0 / in_dim ** 0.5

    def draw(*shape):
        u = torch.rand(shape, generator=g, device=dev, dtype=torch.float32)
        return (2.0 * u - 1.0) * bound

    return {"dec_w": draw(out_dim, in_dim), "dec_b": draw(out_dim)}


def init_anchor_mlps(seed: int = 0, device="cuda") -> dict:
    """Scaffold-GS's three MLPs at the published widths
    (``config.SCAFFOLD_WIDTHS``, ``config.mlp_shapes``), each layer drawn
    as ``torch.nn.Linear`` draws its default (weight and bias uniform in
    +-1/sqrt(fan_in)), from ``torch.Generator(seed)`` on ``device``, in
    the order opacity, covariance, colour and within each ``W1``, ``b1``,
    ``W2``, ``b2``. Returns {``mlp_opacity``, ``mlp_cov``, ``mlp_color``:
    flat float32 tensors}, each ``W1`` [hidden, in], ``b1``, ``W2`` [out,
    hidden], ``b2`` laid end to end (``ops.scaffold.split_mlp``)."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    out = {}
    for k, (i, h, o) in mlp_shapes(*SCAFFOLD_WIDTHS).items():
        parts = []
        for fan_in, n in ((i, h * i), (i, h), (h, o * h), (h, o)):
            u = torch.rand(n, generator=g, device=dev, dtype=torch.float32)
            parts.append((2.0 * u - 1.0) / fan_in ** 0.5)
        out[k] = torch.cat(parts)
    return out

"""The benchmark's synthetic scene, for the measuring tools.

``make_scene`` is a numpy copy of ``bench.py:19-40``: a garden-like ground
disc with scattered clutter in front of a camera at the origin, drawn with
the same generator, the same draws in the same order, and the same float32
rounding, so a seed gives the JAX scene bit for bit. The tools default to
it where the JAX scripts import ``bench.make_scene``.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device


def make_scene(n: int, seed: int = 0, device="cuda") -> dict:
    """n random gaussians (SH degree 3) as float32 tensors on ``device``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    r = np.sqrt(rng.uniform(0.2, 1.0, n)) * 6.0
    th = rng.uniform(0, 2 * np.pi, n)
    pos = np.stack(
        [r * np.cos(th), rng.normal(0.0, 0.6, n), 4.0 + r * np.sin(th) * 0.5],
        axis=-1,
    )
    params = {
        "pos": pos,
        "scale_raw": rng.normal(0, 0.3, (n, 3)) - 3.2,
        "q_raw": rng.normal(0, 1, (n, 4)) + np.array([0, 0, 0, 2.0]),
        "opacity_raw": rng.normal(0.0, 1.0, n),
        "f_dc": rng.normal(0, 0.8, (n, 3)),
        "f_rest": rng.normal(0, 0.05, (n, 45)),
    }
    return {k: torch.from_numpy(np.asarray(v, np.float32)).to(dev)
            for k, v in params.items()}


def make_anchor_scene(n: int, seed: int = 0, device="cuda") -> dict:
    """n Scaffold-GS anchors on :func:`make_scene`'s layout: its positions,
    all six scale columns its first log-scale column (the authors start
    the six equal), and 10 offsets [n, 30] and a feature [n, 32] drawn
    N(0, 1) from ``seed`` (a trained scene's spread, where the authors
    start both at zero). An anchor pool's leaves as float32 tensors on
    ``device``; ``models.gaussians.init_anchor_mlps`` draws its MLPs."""
    base = make_scene(n, seed, device)
    dev = base["pos"].device
    rng = np.random.default_rng(seed + 1)
    draws = {"offset": rng.standard_normal((n, 30)),
             "anchor_feat": rng.standard_normal((n, 32))}
    out = {k: torch.from_numpy(np.asarray(v, np.float32)).to(dev)
           for k, v in draws.items()}
    return {"pos": base["pos"], "offset": out["offset"],
            "anchor_feat": out["anchor_feat"],
            "scale_raw": base["scale_raw"][:, :1].repeat(1, 6).contiguous()}

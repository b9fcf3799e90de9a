"""A configuration's scene as the benchmark's inputs: the parameters and
the alive mask, made from the configuration's file and the seed.

* ``"checkpoint"``: a trained pool in the JAX package's ``.npz`` layout
  (``param_<name>`` arrays and ``__alive__``), read with numpy.
* ``"garden"``: the root ``bench.py``'s ``make_scene`` recipe (a ground
  disc of radius 6 with scattered clutter in front of a camera at the
  origin; SH degree 3), its distributions unchanged, drawn on the device
  with a ``torch.Generator`` in two calls.

The perturbation that training starts from (``perturb``: normal noise
added to some leaves) is drawn on the device from the seed as well.
"""

from __future__ import annotations

import hashlib
from pathlib import Path

import numpy as np
import torch

PARAM_KEYS = ("pos", "opacity_raw", "f_dc", "f_rest", "scale_raw", "q_raw")


def generator(seed: int, stream: str, device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` for one use of the seed."""
    h = hashlib.sha256(f"{int(seed)}/{stream}".encode()).digest()
    g = torch.Generator(device=device)
    g.manual_seed(int.from_bytes(h[:8], "little") % 2**63)
    return g


def garden(n: int, seed: int, device) -> dict:
    """n gaussians of ``make_scene``'s recipe (root ``bench.py:19-40``)."""
    g = generator(seed, "scene", device)
    u = torch.rand(n, 2, generator=g, device=device)
    z = torch.randn(n, 57, generator=g, device=device)
    r = torch.sqrt(0.2 + 0.8 * u[:, 0]) * 6.0
    th = 2 * np.pi * u[:, 1]
    pos = torch.stack([r * torch.cos(th), 0.6 * z[:, 0],
                       4.0 + r * torch.sin(th) * 0.5], dim=-1)
    q_off = torch.tensor([0.0, 0.0, 0.0, 2.0], device=device)
    return {
        "pos": pos.contiguous(),
        "scale_raw": (0.3 * z[:, 1:4] - 3.2).contiguous(),
        "q_raw": (z[:, 4:8] + q_off).contiguous(),
        "opacity_raw": z[:, 8].contiguous(),
        "f_dc": (0.8 * z[:, 9:12]).contiguous(),
        "f_rest": (0.05 * z[:, 12:57]).contiguous(),
    }


def checkpoint_arrays(path: Path):
    """(params as float32 numpy arrays, alive bool array) of an .npz."""
    with np.load(path) as d:
        params = {k: np.asarray(d[f"param_{k}"], np.float32)
                  for k in PARAM_KEYS}
        alive = np.asarray(d["__alive__"], bool)
    return params, alive


def scene(config: dict, seed: int, device, root: Path):
    """(params {name: float32 tensor}, alive bool tensor) on ``device``."""
    sc = config["scene"]
    if sc["kind"] == "checkpoint":
        params, alive = checkpoint_arrays(root / sc["file"])
        return ({k: torch.from_numpy(v).to(device) for k, v in
                 params.items()}, torch.from_numpy(alive).to(device))
    if sc["kind"] == "garden":
        n = int(config["gaussians"])
        return garden(n, seed, device), torch.ones(n, dtype=torch.bool,
                                                   device=device)
    raise ValueError(f"unknown scene kind {sc['kind']!r}")


def noise(params: dict, spec: dict, seed: int) -> dict:
    """The starting perturbation: {leaf: N(0, sigma)} for spec's leaves."""
    out = {}
    for k in spec["leaves"]:
        p = params[k]
        g = generator(seed, f"perturb/{k}", p.device)
        out[k] = spec["sigma"] * torch.randn(p.shape, generator=g,
                                             device=p.device)
    return out


def perturbed(params: dict, spec: dict, seed: int) -> dict:
    n = noise(params, spec, seed)
    return {k: (v + n[k] if k in n else v) for k, v in params.items()}

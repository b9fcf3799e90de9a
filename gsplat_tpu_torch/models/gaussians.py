"""Gaussian model state: a fixed-capacity parameter pool with an alive mask.

Counterpart of ``gsplat_tpu/models/gaussians.py:20-35``: every parameter
has a static ``capacity`` rows and ``alive`` marks the populated slots.
Here the pool is an ``nn.Module`` whose six parameters are
``nn.Parameter``s (same names and layouts as the JAX pytree) and whose
``alive`` mask is a buffer.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..device import resolve_device

PARAM_KEYS = ("pos", "opacity_raw", "f_dc", "f_rest", "scale_raw", "q_raw")


class GaussianPool(nn.Module):
    """Fixed-capacity Gaussian parameter pool."""

    def __init__(self, params: dict, alive: torch.Tensor):
        super().__init__()
        missing = set(PARAM_KEYS) - set(params)
        if missing:
            raise ValueError(f"pool parameters missing: {sorted(missing)}")
        for k in PARAM_KEYS:
            self.register_parameter(k, nn.Parameter(params[k]))
        self.register_buffer("alive", alive)

    @property
    def params(self) -> dict:
        """The six parameters by name, as ``render_from_params`` takes them."""
        return {k: getattr(self, k) for k in PARAM_KEYS}

    @property
    def capacity(self) -> int:
        return self.alive.shape[0]

    def num_alive(self) -> torch.Tensor:
        return torch.sum(self.alive.to(torch.int32))


def pool_from_numpy(params: dict, alive, device="cuda") -> GaussianPool:
    """Carry the JAX package's pool across: the same parameter names and
    layouts as numpy arrays, stored f32 and contiguous on ``device``."""
    dev = resolve_device(device)
    tensors = {
        k: torch.from_numpy(np.ascontiguousarray(params[k], np.float32)).to(dev)
        for k in PARAM_KEYS
        if k in params
    }
    alive_t = torch.from_numpy(np.ascontiguousarray(alive, bool)).to(dev)
    n = alive_t.shape[0]
    for k, v in tensors.items():
        if v.shape[0] != n:
            raise ValueError(f"{k} has {v.shape[0]} rows, alive has {n}")
    return GaussianPool(tensors, alive_t)

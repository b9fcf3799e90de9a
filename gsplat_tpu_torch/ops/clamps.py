"""Clamps whose gradient at a tie follows the JAX package.

``jnp.clip``, ``jnp.maximum`` and ``jnp.minimum`` give each operand half
of the gradient where the two are equal: ``grad(clip)(0.0)`` on ``[0, 1]``
is 0.5. ``torch.clamp`` passes all of it (1.0), while ``torch.maximum`` and
``torch.minimum`` split it as JAX does, so these helpers use them, with the
bound filled on the input's device (no host-to-device copy), whenever
autograd records the call. Otherwise (serving under ``torch.no_grad()``)
they are ``torch.clamp``, one launch: the values are the same.

Used wherever the JAX package clamps on a gradient path: the image clamp
(``gsplat_tpu/ops/rasterize.py:531``), ``exp_scale``'s floor
(``gsplat_tpu/ops/gaussian.py:51``), the projection's opacity clip, depth
floor, eigenvalue clamp and conic floors (``gsplat_tpu/ops/projection.py:
113,157,66-67,261-262``), the determinant floor of ``inv2x2_packed``
(``gsplat_tpu/ops/camera.py:108``) and the SH norm guard
(``gsplat_tpu/ops/sh.py:143``).
"""

from __future__ import annotations

import torch


def _recorded(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def maximum(x: torch.Tensor, lo: float) -> torch.Tensor:
    """``jnp.maximum(x, lo)``: max with a constant, tie gradient 0.5."""
    if not _recorded(x):
        return torch.clamp(x, min=lo)
    return torch.maximum(x, torch.full_like(x, lo))


def minimum(x: torch.Tensor, hi: float) -> torch.Tensor:
    """``jnp.minimum(x, hi)``: min with a constant, tie gradient 0.5."""
    if not _recorded(x):
        return torch.clamp(x, max=hi)
    return torch.minimum(x, torch.full_like(x, hi))


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip(x, lo, hi)`` (= ``minimum(maximum(x, lo), hi)``)."""
    if not _recorded(x):
        return torch.clamp(x, lo, hi)
    return minimum(maximum(x, lo), hi)

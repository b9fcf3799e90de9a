"""Checkpoint loading for the port.

Counterpart of ``gsplat_tpu/train/trainer.py:508-516`` (``restore_pool``).
Reads the single-file ``.npz`` the JAX trainer writes
(``save_checkpoint``, ``:489-505``): ``param_<name>`` arrays and the
``__alive__`` mask. The training step comes with the training slice.
"""

from __future__ import annotations

import numpy as np

from ..models.gaussians import GaussianPool, pool_from_numpy


def restore_pool(path, device="cuda") -> GaussianPool:
    """Load only the Gaussian pool (params + alive) from a checkpoint."""
    with np.load(path) as data:
        params = {
            k[len("param_"):]: data[k]
            for k in data.files
            if k.startswith("param_")
        }
        alive = data["__alive__"]
    return pool_from_numpy(params, alive, device)

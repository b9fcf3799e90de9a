"""gsplat_tpu_torch — the PyTorch/CUDA port of gsplat_tpu.

The JAX package ``gsplat_tpu`` is the reference; this package keeps its
module names. It imports torch and numpy only (never jax, never
gsplat_tpu). Plain tensor code is PyTorch; every TPU kernel on the ported
path is a kernel written by hand for Hopper (``ops/csrc``), built with
nvcc at first use. Importing the package needs neither CUDA nor nvcc.
"""

from .config import (FeatureConfig, RenderConfig, TrainConfig, cdiv,
                     parse_background)
from .device import resolve_device
from .models.gaussians import (GaussianPool, init_pool_from_points,
                               pool_from_numpy)
from .ops.binning import TileBinning, bin_gaussians
from .ops.camera import inv2x2, project_points, scale_intrinsics
from .ops.gaussian import build_sigma_from_params, quat_to_rotmat
from .ops.losses import compute_loss, l1_loss, ssim_loss
from .ops.projection import ProjectedGaussians, project_gaussians
from .ops.rasterize import RenderAux, rasterize
from .ops.sh import HARMONICS, evaluate_sh
from .render import (pair_demand, render, render_batch_from_params,
                     render_from_params)
from .train.fit import FitReport, fit
from .train.trainer import (TrainState, init_train_state, load_checkpoint,
                            make_train_step, position_lr, restore_pool,
                            save_checkpoint)

__all__ = [
    "FeatureConfig",
    "RenderConfig",
    "TrainConfig",
    "cdiv",
    "parse_background",
    "resolve_device",
    "GaussianPool",
    "init_pool_from_points",
    "pool_from_numpy",
    "TileBinning",
    "bin_gaussians",
    "build_sigma_from_params",
    "quat_to_rotmat",
    "inv2x2",
    "project_points",
    "scale_intrinsics",
    "compute_loss",
    "l1_loss",
    "ssim_loss",
    "HARMONICS",
    "evaluate_sh",
    "ProjectedGaussians",
    "project_gaussians",
    "RenderAux",
    "rasterize",
    "pair_demand",
    "render",
    "render_from_params",
    "render_batch_from_params",
    "restore_pool",
    "save_checkpoint",
    "load_checkpoint",
    "FitReport",
    "fit",
    "TrainState",
    "init_train_state",
    "make_train_step",
    "position_lr",
]

__version__ = "0.1.0"

# The submodules the JAX package's ``__getattr__`` gives lazily.
_SUBMODULES = ("data", "viewer", "models", "train", "parallel", "ops")


def __getattr__(name):
    # Lazy submodule access, as ``gsplat_tpu/__init__.py:50-57``: data and
    # viewer pull PIL and other host-side dependencies only when used.
    if name in _SUBMODULES:
        import importlib

        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

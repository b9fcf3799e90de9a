"""gsplat_tpu_torch — the PyTorch/CUDA port of gsplat_tpu.

The JAX package ``gsplat_tpu`` is the reference; this package keeps its
module names. It imports torch and numpy only (never jax, never
gsplat_tpu). Plain tensor code is PyTorch; every TPU kernel on the ported
path is a kernel written by hand for Hopper (``ops/csrc``), built with
nvcc at first use. Importing the package needs neither CUDA nor nvcc.
"""

from .config import RenderConfig, cdiv, parse_background
from .device import resolve_device
from .models.gaussians import GaussianPool, pool_from_numpy
from .ops.binning import TileBinning, bin_gaussians
from .ops.projection import ProjectedGaussians, project_gaussians
from .ops.rasterize import RenderAux, rasterize
from .render import pair_demand, render, render_from_params
from .train.trainer import restore_pool

__all__ = [
    "RenderConfig",
    "cdiv",
    "parse_background",
    "resolve_device",
    "GaussianPool",
    "pool_from_numpy",
    "TileBinning",
    "bin_gaussians",
    "ProjectedGaussians",
    "project_gaussians",
    "RenderAux",
    "rasterize",
    "pair_demand",
    "render",
    "render_from_params",
    "restore_pool",
]

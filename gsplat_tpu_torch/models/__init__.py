from .adc import (AdcResult, densify_and_prune, densify_and_prune_paper,
                  raise_low_opacity)
from .gaussians import (PARAM_KEYS, GaussianPool, compact_pool, export_params,
                        init_pool_from_points, pool_from_dense,
                        pool_from_numpy)

__all__ = [
    "AdcResult",
    "PARAM_KEYS",
    "GaussianPool",
    "compact_pool",
    "densify_and_prune",
    "densify_and_prune_paper",
    "export_params",
    "init_pool_from_points",
    "pool_from_dense",
    "pool_from_numpy",
    "raise_low_opacity",
]

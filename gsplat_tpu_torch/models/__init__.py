from .gaussians import PARAM_KEYS, GaussianPool, pool_from_numpy

__all__ = ["PARAM_KEYS", "GaussianPool", "pool_from_numpy"]

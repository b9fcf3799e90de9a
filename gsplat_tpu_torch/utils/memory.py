"""Device-memory footprint estimates for the static-capacity render and
train steps.

The port's copy of ``gsplat_tpu/utils/memory.py``, without its
batched-render terms (the port renders one view at a time). Every capacity
is static, so the footprint of the dominant pairs-sized and pool-sized
arrays is predictable before a step runs; ``fit()`` logs the estimate when
it grows ``max_pairs``. These count those arrays only, not allocator slack
or temporaries, so they sit well below a step's measured peak.
"""

from __future__ import annotations

from ..config import RenderConfig, TrainConfig

_F32 = 4
_PARAM_FLOATS = 3 + 3 + 4 + 1 + 3 + 45  # pos/scale/quat/opacity/f_dc/f_rest


def estimate_render_memory(cfg: RenderConfig, n_gaussians: int) -> dict:
    """Approximate peak device bytes of one forward render."""
    cap = cfg.padded_pairs
    p = cfg.tile * cfg.tile
    pair_features = 16 * cap * _F32           # feature-major [16, padded]
    sort_arrays = 4 * cap * _F32              # keys + payload + sorted pair
    tile_planes = cfg.num_tiles * 8 * p * _F32
    per_gaussian = (_PARAM_FLOATS + 16) * n_gaussians * _F32  # params + proj
    total = pair_features + sort_arrays + tile_planes + per_gaussian
    return {
        "pair_features_mb": pair_features / 1e6,
        "sort_mb": sort_arrays / 1e6,
        "tile_planes_mb": tile_planes / 1e6,
        "per_gaussian_mb": per_gaussian / 1e6,
        "total_mb": total / 1e6,
    }


def estimate_train_memory(
    cfg: RenderConfig, train_cfg: TrainConfig, n_gaussians: int | None = None
) -> dict:
    """Approximate peak device bytes of one training step (fwd + bwd +
    Adam): the forward's arrays, a pairs-sized gradient array (dfeat),
    Adam's two moments of every parameter, and the ground-truth and
    rendered images of a batch."""
    n = n_gaussians if n_gaussians is not None else train_cfg.capacity
    fwd = estimate_render_memory(cfg, n)
    dfeat = 16 * cfg.padded_pairs * _F32
    opt_state = 2 * _PARAM_FLOATS * train_cfg.capacity * _F32
    images = (
        3 * cfg.height * cfg.width * _F32 * train_cfg.batch_size * 2
    )  # GT + rendered
    total = fwd["total_mb"] * 1e6 + dfeat + opt_state + images
    return {
        **{k: v for k, v in fwd.items() if k != "total_mb"},
        "backward_dfeat_mb": dfeat / 1e6,
        "optimizer_mb": opt_state / 1e6,
        "images_mb": images / 1e6,
        "total_mb": total / 1e6,
    }

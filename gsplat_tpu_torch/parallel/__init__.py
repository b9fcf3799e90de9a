"""Process grids and the steps and renders that run over them
(counterpart of ``gsplat_tpu/parallel``)."""

from .mesh import (DATA_AXIS, TILE_AXIS, Mesh, initialize_multihost,
                   launch, make_mesh)
from .sharding import (band_config, gather_bands, local_batch,
                       make_sharded_batch_render, make_sharded_render,
                       make_sharded_train_step, render_band)

__all__ = [
    "DATA_AXIS",
    "TILE_AXIS",
    "Mesh",
    "initialize_multihost",
    "launch",
    "make_mesh",
    "band_config",
    "gather_bands",
    "local_batch",
    "make_sharded_batch_render",
    "make_sharded_render",
    "make_sharded_train_step",
    "render_band",
]

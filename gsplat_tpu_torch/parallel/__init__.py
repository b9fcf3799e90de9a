"""Process grids and the steps and renders that run over them
(counterpart of ``gsplat_tpu/parallel``)."""

from .mesh import (DATA_AXIS, TILE_AXIS, Mesh, initialize_multihost,
                   launch, make_mesh)
from .sharding import (adc_on_shards, band_config, band_localize,
                       gather_bands, gather_train_state, local_batch,
                       make_gauss_sharded_render,
                       make_gauss_sharded_train_step,
                       make_sharded_batch_render, make_sharded_render,
                       make_sharded_train_step, num_alive, render_band,
                       shard_rows, shard_train_state)

__all__ = [
    "DATA_AXIS",
    "TILE_AXIS",
    "Mesh",
    "initialize_multihost",
    "launch",
    "make_mesh",
    "adc_on_shards",
    "band_config",
    "band_localize",
    "gather_bands",
    "gather_train_state",
    "local_batch",
    "make_gauss_sharded_render",
    "make_gauss_sharded_train_step",
    "make_sharded_batch_render",
    "make_sharded_render",
    "make_sharded_train_step",
    "num_alive",
    "render_band",
    "shard_rows",
    "shard_train_state",
]

"""Sharded steps over a single-process device mesh (counterpart of
``esp32_fluid_simulation_tpu/parallel``): the mesh, the halo exchange, the
2D sharded step (K11, the block mode of K1, K2 and K4) and the sharded
tiled supergrid.  The 3D sharded steps and the multi-process leg
(``sharded3d.py``, ``sharded_smoke.py``, ``dcn.py``) are not ported yet."""

from .topology import make_mesh, grid_axes, Mesh
from .halo import exchange_halo
from .sharded import (make_sharded_step, make_sharded_step_with_metrics,
                      make_sharded_render, sharded_state_sharding,
                      shard_state, unshard_state, gather)
from .sharded_tiled import make_sharded_tiled_step, make_sharded_ensemble_step

__all__ = [
    "make_mesh",
    "grid_axes",
    "Mesh",
    "exchange_halo",
    "make_sharded_step",
    "make_sharded_step_with_metrics",
    "make_sharded_render",
    "make_sharded_tiled_step",
    "make_sharded_ensemble_step",
    "sharded_state_sharding",
    "shard_state",
    "unshard_state",
    "gather",
]

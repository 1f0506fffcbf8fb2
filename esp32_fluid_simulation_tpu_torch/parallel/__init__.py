"""Sharded steps over a device mesh (counterpart of
``esp32_fluid_simulation_tpu/parallel``): the mesh, the halo exchange, the
2D and 3D sharded dye-bed steps, the sharded 3D smoke step (K11, the block
mode of K1, K2, K4, K7 and K9), the sharded tiled supergrid, and the
multi-process leg (``dcn.py``: a mesh that spans the processes of a
``torch.distributed`` group)."""

from .topology import make_mesh, make_process_mesh, grid_axes, Mesh
from .halo import exchange_halo
from .sharded import (make_sharded_step, make_sharded_step_with_metrics,
                      make_sharded_render, sharded_state_sharding,
                      shard_state, unshard_state, gather)
from .sharded3d import make_sharded_step_3d
from .sharded_smoke import (make_sharded_smoke_step, sharded_smoke_sharding,
                            shard_smoke_state, unshard_smoke_state)
from .sharded_tiled import make_sharded_tiled_step, make_sharded_ensemble_step

__all__ = [
    "make_mesh",
    "make_process_mesh",
    "grid_axes",
    "Mesh",
    "exchange_halo",
    "make_sharded_step",
    "make_sharded_step_3d",
    "make_sharded_step_with_metrics",
    "make_sharded_render",
    "make_sharded_smoke_step",
    "make_sharded_tiled_step",
    "make_sharded_ensemble_step",
    "sharded_smoke_sharding",
    "sharded_state_sharding",
    "shard_smoke_state",
    "shard_state",
    "unshard_smoke_state",
    "unshard_state",
    "gather",
]

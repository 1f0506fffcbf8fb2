"""The port's halo exchange (``parallel/halo.py``) against the JAX
package's, which runs under ``shard_map`` on the 8-device CPU mesh of
``tests/conftest.py``.

Inputs come from a numpy seed; every block is extended by the same ghosts,
so the concatenation of the extended blocks must be equal, exactly, to what
JAX's ``shard_map`` assembles: each boundary condition, widths 1 and 3,
along each mesh axis on its array axis, on a 2x4 mesh and on a mesh whose
x axis has 1 shard (pure boundary fill).  The port's mesh is 8 (or 4) CPU
devices.
"""

import numpy as np
import jax
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from esp32_fluid_simulation_tpu.parallel import make_mesh as jmake_mesh
from esp32_fluid_simulation_tpu.parallel.halo import (
    exchange_halo as jexchange_halo)
from esp32_fluid_simulation_tpu_torch.parallel import (exchange_halo,
                                                       gather, make_mesh)
from esp32_fluid_simulation_tpu_torch.parallel.sharded import Shards

F = np.float32
SHAPE = (2, 16, 24)


def _jax_exchange(x, width, dim, axis, bc, grid_shape):
    mesh = jmake_mesh(jax.devices()[:grid_shape[0] * grid_shape[1]],
                      grid_shape=grid_shape)
    n = mesh.shape[axis]
    fn = shard_map(lambda b: jexchange_halo(b, width, dim, axis, n, bc),
                   mesh=mesh, in_specs=P(None, "x", "y"),
                   out_specs=P(None, "x", "y"), check_vma=False)
    return np.asarray(fn(x))


def _port_exchange(x, width, dim, axis, bc, grid_shape):
    mesh = make_mesh(["cpu"] * (grid_shape[0] * grid_shape[1]),
                     grid_shape=grid_shape)
    blocks = Shards(mesh, x.shape[-2:]).split(torch.from_numpy(x))
    return gather(exchange_halo(blocks, width, dim, axis, bc), "cpu").numpy()


@pytest.mark.parametrize("bc", ["zero", "edge", "reflect_neg"])
@pytest.mark.parametrize("width", [1, 3])
@pytest.mark.parametrize("dim,axis", [(-2, "x"), (-1, "y")])
def test_exchange_halo_matches_jax(rng, bc, width, dim, axis):
    x = rng.standard_normal(SHAPE).astype(F)
    want = _jax_exchange(x, width, dim, axis, bc, (2, 4))
    got = _port_exchange(x, width, dim, axis, bc, (2, 4))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bc", ["zero", "edge", "reflect_neg"])
def test_exchange_halo_one_shard_axis_is_the_bc_fill(rng, bc):
    """A 1-shard axis: both ghosts are the global edges' fill."""
    x = rng.standard_normal(SHAPE).astype(F)
    want = _jax_exchange(x, 2, -2, "x", bc, (1, 4))
    got = _port_exchange(x, 2, -2, "x", bc, (1, 4))
    np.testing.assert_array_equal(got, want)
    if bc == "zero":
        assert not got[:, :2].any() and not got[:, -2:].any()


def test_exchange_halo_refuses_width_beyond_the_shard(rng):
    mesh = make_mesh(["cpu"] * 8, grid_shape=(2, 4))
    blocks = Shards(mesh, SHAPE[1:]).split(
        torch.from_numpy(rng.standard_normal(SHAPE).astype(F)))
    with pytest.raises(ValueError, match="exceeds the shard extent"):
        exchange_halo(blocks, 7, -1, "y")          # blocks are 8 x 6
    with pytest.raises(ValueError, match="unknown bc"):
        exchange_halo(blocks, 1, -1, "y", "wrap")
    assert exchange_halo(blocks, 0, -1, "y") is blocks

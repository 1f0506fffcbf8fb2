"""The 3D smoke kernels' plain PyTorch versions (K7-K10) against the JAX
package's Pallas kernels, on the same numpy-seeded inputs (CPU).

The Pallas kernels run in interpret mode through a local fixture, as
tests/test_pallas.py runs them; the wrappers are called with CPU tensors,
so they run their plain versions.  Tolerances:

* K7 advect3d (test_pallas.py:279-301): float32 rtol 1e-4 / atol 5e-5 —
  interpret mode contracts the Pallas backtrace ``x - v*dt`` into an FMA,
  a one-ulp coordinate shift the field's neighbour differences amplify;
  bfloat16 to one bf16 ulp (rtol 2^-7), as K2's dye;
* K8 fd3d (test_pallas.py:417-436): divergence bit-equal, gradient
  rtol 1e-6 / atol 1e-6;
* K9 sor3d (test_pallas.py:391-404): rtol 5e-5 / atol 5e-6 (the packed
  kernel reassociates nothing, but XLA may contract its updates);
* K10 MIP render (test_pallas.py render test, test_render.py:123-150) and
  the port's ``render_smoke`` (test_render.py:101-121): bit-equal.
* ``multigrid_solve`` against the JAX op (test_multigrid.py): rtol 1e-5 /
  atol 1e-6.
"""

import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from jax.experimental import pallas as pl

from esp32_fluid_simulation_tpu.ops.multigrid import (
    multigrid_solve as j_multigrid_solve)
from esp32_fluid_simulation_tpu.ops.pallas.advect3d import advect3d_pallas
from esp32_fluid_simulation_tpu.ops.pallas.fd3d import (
    divergence3d_pallas, subtract_gradient3d_pallas)
from esp32_fluid_simulation_tpu.ops.pallas.sor3d import sor3d_packed_pallas
from esp32_fluid_simulation_tpu.render import smoke as j_smoke
from esp32_fluid_simulation_tpu.render.pallas_smoke import (
    render_smoke_mip_pallas)
from esp32_fluid_simulation_tpu_torch.interop import (tensor_from_numpy,
                                                      tensor_to_numpy)
from esp32_fluid_simulation_tpu_torch.ops.cuda.advect3d import (
    advect3d_kernel)
from esp32_fluid_simulation_tpu_torch.ops.cuda.fd3d import (
    divergence3d, subtract_gradient3d)
from esp32_fluid_simulation_tpu_torch.ops.cuda.sor3d import sor3d_solve
from esp32_fluid_simulation_tpu_torch.ops.multigrid import multigrid_solve
from esp32_fluid_simulation_tpu_torch.render import render_smoke
from esp32_fluid_simulation_tpu_torch.render.cuda_smoke import (
    render_smoke_mip_kernel)

torch.set_num_threads(1)

F = np.float32
DT = 1 / 30.
# K7: interpret mode costs seconds per (z, row) shift slot, and there are
# (2 max_disp + 2)^2 of them, so the cases run at max_disp=1
ADV = (4, 12, 130)
ODD = (9, 33, 130)      # K8, K9: non-tile-multiple in every axis
TILES = dict(tile_d=4, tile_h=16, tile_w=128)


@pytest.fixture(autouse=True)
def interpret_pallas(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    yield


def _t(x):
    return tensor_from_numpy(np.asarray(x), device="cpu")


def _smooth_vel(rng, shape, scale):
    """A smooth velocity field of amplitude ``scale`` cells/s."""
    z, i, j = np.meshgrid(*(np.arange(n, dtype=F) for n in shape),
                          indexing="ij")
    ph = rng.random(3) * 2 * np.pi
    return np.stack([
        scale * np.sin(2 * np.pi * i / 11 + ph[0]) * np.cos(j / 9.0),
        scale * np.cos(2 * np.pi * z / 5 + ph[1]) * np.sin(j / 13.0),
        scale * np.sin(2 * np.pi * i / 7 + ph[2]) * np.cos(z / 3.0),
    ]).astype(F)


def test_advect3d_plain_f32_noslip_matches_pallas(rng):
    """Velocity-like 3-channel f32 field, no-slip, inside the clamp."""
    f = (3 * rng.standard_normal((3,) + ADV)).astype(F)
    v = _smooth_vel(rng, ADV, 28.0)             # < 1 cell per step
    assert np.abs(v).max() * DT < 1
    want = advect3d_pallas(jnp.asarray(f), jnp.asarray(v), DT, True,
                           max_disp=1, tile_d=2, tile_h=8)
    got = advect3d_kernel(_t(f), _t(v), DT, True, max_disp=1)
    assert got.dtype == torch.float32 and got.shape == f.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=5e-5)


def test_advect3d_plain_bf16_pair_matches_pallas(rng):
    """The smoke's density + temperature pair: bf16, one 2-channel call."""
    f = jnp.asarray(rng.random((2,) + ADV, dtype=F)).astype(jnp.bfloat16)
    v = _smooth_vel(rng, ADV, 25.0)
    assert np.abs(v).max() * DT < 1
    want = advect3d_pallas(f, jnp.asarray(v), DT, False, max_disp=1,
                           tile_d=2, tile_h=8)
    got = advect3d_kernel(_t(f), _t(v), DT, False, max_disp=1)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=2 ** -7, atol=1e-6)


def test_advect3d_plain_cfl_clamp_matches_pallas(rng):
    """|v|*dt > max_disp on most cells: both versions clamp per axis."""
    f = rng.random(ADV, dtype=F)
    v = (60 * rng.standard_normal((3,) + ADV)).astype(F)
    assert (np.abs(v) * DT > 1).mean() > 0.5
    want = advect3d_pallas(jnp.asarray(f), jnp.asarray(v), DT, False,
                           max_disp=1, tile_d=2, tile_h=8)
    got = advect3d_kernel(_t(f), _t(v), DT, False, max_disp=1)
    assert got.shape == ADV
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=5e-5)


def test_advect3d_kernel_rejects_block_mode(rng):
    """Block mode (K11), which this test once checked was refused, runs: a
    haloed block of a 2-channel field, with the
    origin as a 2-element integer tensor, equals the crop of the whole
    grid's result to the bit.  An argument the TPU kernel does not take
    is still rejected."""
    f = rng.random((2,) + ADV, dtype=F)
    v = _smooth_vel(rng, ADV, 40.0)
    g, off, blk = 2, (4, 2), (6, 100)
    fpad = np.pad(f, ((0, 0), (0, 0), (g, g), (g, g)))[
        :, :, off[0]:off[0] + blk[0] + 2 * g, off[1]:off[1] + blk[1] + 2 * g]
    vown = v[:, :, off[0]:off[0] + blk[0], off[1]:off[1] + blk[1]]
    got = advect3d_kernel(_t(fpad), _t(vown), DT, False, max_disp=1,
                          global_offset=torch.tensor(off), global_shape=ADV,
                          halo=g)
    whole = advect3d_kernel(_t(f), _t(v), DT, False, max_disp=1)
    assert torch.equal(got, whole[:, :, off[0]:off[0] + blk[0],
                                  off[1]:off[1] + blk[1]])
    with pytest.raises(TypeError):
        advect3d_kernel(_t(f), _t(v), DT, False, tile_q=2)


def test_fd3d_plain_matches_pallas(rng):
    v = rng.standard_normal((3,) + ODD).astype(F)
    p = rng.standard_normal(ODD).astype(F)
    np.testing.assert_array_equal(
        divergence3d(_t(v), 0.7).numpy(),
        np.asarray(divergence3d_pallas(jnp.asarray(v), 0.7, **TILES)))
    np.testing.assert_allclose(
        subtract_gradient3d(_t(v), _t(p), 0.7).numpy(),
        np.asarray(subtract_gradient3d_pallas(jnp.asarray(v), jnp.asarray(p),
                                              0.7, **TILES)),
        rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("iters,chunk", [(1, 2), (1, 3), (5, 2), (5, 3)])
def test_sor3d_plain_matches_pallas(rng, iters, chunk):
    d = rng.standard_normal(ODD).astype(F)
    want = sor3d_packed_pallas(jnp.asarray(d), 1.0, iters, 1.5, chunk=chunk,
                               **TILES)
    got = sor3d_solve(_t(d), 1.0, iters, 1.5, chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-5,
                               atol=5e-6)


def test_sor3d_chunk_exceeding_lane_halo_rejected(rng):
    """The JAX contract's chunk validation is kept (sor3d.py:187-194)."""
    d = _t(rng.standard_normal((8, 16, 128)).astype(F))
    with pytest.raises(ValueError, match="column halo"):
        sor3d_solve(d, 1.0, 130, 1.5, chunk=65)
    with pytest.raises(ValueError, match="column halo"):
        sor3d_packed_pallas(jnp.asarray(d.numpy()), 1.0, 130, 1.5, chunk=65)
    assert sor3d_solve(d, 1.0, 2, 1.5, chunk=65).shape == (8, 16, 128)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mip_plain_bit_equal_to_pallas(rng, dtype):
    rho = jnp.asarray(1.2 * rng.random((5, 20, 130)).astype(F)).astype(
        jnp.dtype(dtype))
    for bswap in (True, False):
        want = render_smoke_mip_pallas(rho, bswap=bswap, tile_h=16,
                                       tile_w=128)
        got = render_smoke_mip_kernel(_t(rho), bswap=bswap)
        assert got.dtype == torch.uint16 and got.shape == (20, 130)
        np.testing.assert_array_equal(tensor_to_numpy(got), np.asarray(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_render_smoke_bit_equal_to_jax(rng, dtype):
    """mip and slice views, both formats, the default midplane, vmax."""
    rho = jnp.asarray(rng.random((8, 16, 32), dtype=F)).astype(
        jnp.dtype(dtype))
    tr = _t(rho)
    cases = [dict(mode="mip"), dict(mode="mip", axis=1, fmt="rgb8"),
             dict(mode="mip", bswap=False, vmax=0.7),
             dict(mode="slice", axis=2, index=5, fmt="rgb8"),
             dict(mode="slice", axis=0), dict(mode="slice", axis=1,
                                              index=-2)]
    for kw in cases:
        want = np.asarray(j_smoke.render_smoke(rho, **kw))
        got = tensor_to_numpy(render_smoke(tr, **kw))
        assert got.dtype == want.dtype and got.shape == want.shape, kw
        np.testing.assert_array_equal(got, want, err_msg=str(kw))
    with pytest.raises(ValueError, match="mode"):
        render_smoke(tr, mode="sum")
    with pytest.raises(ValueError, match="fmt"):
        render_smoke(tr, fmt="jpeg")


def test_render_smoke_nan_rule_matches_jax(rng):
    """A NaN voxel makes its column's MIP NaN, which packs to 0, in the
    JAX package, the port's plain version and (on the card) the kernel."""
    rho = rng.random((6, 16, 24), dtype=F)
    rho[3, 5, 7] = np.nan
    want = np.asarray(j_smoke.render_smoke(jnp.asarray(rho)))
    got = tensor_to_numpy(render_smoke_mip_kernel(_t(rho)))
    assert want[5, 7] == 0
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape,kw", [
    ((17, 21), dict()),
    ((12, 10, 9), dict(cycles=1, dx=0.5)),
])
def test_multigrid_matches_jax(rng, shape, kw):
    d = rng.standard_normal(shape).astype(F)
    np.testing.assert_allclose(
        multigrid_solve(_t(d), **kw).numpy(),
        np.asarray(j_multigrid_solve(jnp.asarray(d), **kw)),
        rtol=1e-5, atol=1e-6)

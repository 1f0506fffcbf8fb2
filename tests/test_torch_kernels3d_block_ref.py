"""Block mode (K11) of the 3D kernels K7 and K9: the plain PyTorch versions
against the JAX package's Pallas kernels in block mode, on the same
numpy-seeded inputs (CPU).

The Pallas kernels run in interpret mode through a local fixture, as
tests/test_pallas.py runs them; the wrappers are called with CPU tensors,
so they run their plain versions.  A block is cut from the zero-padded
field, as the halo exchange builds it at the domain's edge.  Tolerances:

* K7 ``advect3d_kernel`` in block mode against ``advect3d_pallas(
  global_offset=...)``: those of test_torch_kernels3d_ref.py, float32 rtol
  1e-4 / atol 5e-5 (interpret mode contracts the backtrace into an FMA),
  bfloat16 one bf16 ulp (rtol 2^-7); and every block equals the crop of
  the port's whole-grid plain version to the bit.
* K9 ``sor3d_chunk`` against ``_sor3d_chunk``: on the owned cells only,
  rtol 1e-4 / atol 1e-5 (3e-7 seen: the interpret path reassociates).  The
  outer ``2*sweeps`` rings are not the whole grid's in either version, and
  in the TPU kernel they also depend on its padding.  A chain of chunks
  with one ``2*chunk``-wide exchange each equals the whole-grid plain
  solve on the owned cells to the bit.

Interpret-mode ``advect3d_pallas`` traces once per set of static
arguments (a few seconds at ``tile_d=1``); the offsets are traced values,
so the cases of one dtype share a trace.
"""

import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from jax.experimental import pallas as pl

from esp32_fluid_simulation_tpu.ops.pallas.advect3d import advect3d_pallas
from esp32_fluid_simulation_tpu.ops.pallas.sor3d import _sor3d_chunk
from esp32_fluid_simulation_tpu_torch.interop import tensor_from_numpy
from esp32_fluid_simulation_tpu_torch.ops.cuda.advect3d import (
    advect3d_kernel)
from esp32_fluid_simulation_tpu_torch.ops.cuda.sor3d import (
    sor3d_chunk, sor3d_reference)

torch.set_num_threads(1)

F = np.float32
DT = 1 / 30.
GLOBAL = (12, 32, 48)
BLOCK = (16, 24)
MD = 1                       # K7's CFL clamp; the halo is MD + 1
# the corner block, an interior block and the far corner block
OFFSETS = {"corner": (0, 0), "interior": (8, 12), "far": (16, 24)}


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


def _haloed(x, off, g, block=BLOCK):
    """The ``block`` at ``off`` of the trailing two axes with ``g`` cells
    of zero-padded halo."""
    pad = [(0, 0)] * (x.ndim - 2) + [(g, g), (g, g)]
    xp = np.pad(x, pad)
    return np.ascontiguousarray(
        xp[..., off[0]:off[0] + block[0] + 2 * g,
           off[1]:off[1] + block[1] + 2 * g])


def _owned(x, off, block=BLOCK):
    return x[..., off[0]:off[0] + block[0], off[1]:off[1] + block[1]]


def _advect_both(field, vel, no_slip, off):
    """(port plain block result, JAX interpret block result) at ``off``."""
    g = MD + 1
    fpad = _haloed(field, off, g)
    v = np.ascontiguousarray(_owned(vel, off))
    want = advect3d_pallas(jnp.asarray(fpad), jnp.asarray(v), DT, no_slip,
                           max_disp=MD, tile_d=1, tile_h=8,
                           global_offset=jnp.asarray(off, jnp.int32),
                           global_shape=GLOBAL, halo=g)
    got = advect3d_kernel(_t(fpad), _t(v), DT, no_slip, max_disp=MD,
                          global_offset=off, global_shape=GLOBAL, halo=g)
    return got, want


@pytest.mark.parametrize("where", list(OFFSETS))
def test_advect3d_block_velocity_noslip_matches_pallas(rng, where):
    """The f32 velocity self-advect with no-slip: each block against the
    TPU kernel's block mode and the crop of the whole grid."""
    off = OFFSETS[where]
    vel = _smooth_vel(rng, GLOBAL, 28.0)            # < 1 cell per step
    assert np.abs(vel).max() * DT < 1
    got, want = _advect_both(vel, vel, True, off)
    assert got.dtype == torch.float32 and got.shape == (3, 12) + BLOCK
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=5e-5)
    whole = advect3d_kernel(_t(vel), _t(vel), DT, True, max_disp=MD)
    assert torch.equal(got, _owned(whole, off))


@pytest.mark.parametrize("where", list(OFFSETS))
def test_advect3d_block_bf16_pair_matches_pallas(rng, where):
    """The smoke's density + temperature pair in bf16, no no-slip, with
    |v|*dt beyond the clamp on some cells."""
    off = OFFSETS[where]
    pair = jnp.asarray(rng.random((2,) + GLOBAL, dtype=F)).astype(
        jnp.bfloat16)
    vel = _smooth_vel(rng, GLOBAL, 45.0)
    assert np.abs(vel).max() * DT > MD
    got, want = _advect_both(np.asarray(pair), vel, False, off)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=2 ** -7, atol=1e-6)
    whole = advect3d_kernel(_t(pair), _t(vel), DT, False, max_disp=MD)
    assert torch.equal(got, _owned(whole, off))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("where", list(OFFSETS))
def test_advect3d_block_self_advect_matches_pallas(rng, where, dtype):
    """The self-advect (``vel=None``: the velocity read from the haloed
    field's owned cells) equals the call with the owned velocity to the
    bit, and follows the TPU kernel's block mode on the owned cells."""
    off = OFFSETS[where]
    vel = jnp.asarray(_smooth_vel(rng, GLOBAL, 45.0)).astype(dtype)
    vel = np.asarray(vel)
    g = MD + 1
    vpad = _haloed(vel, off, g)
    kw = dict(max_disp=MD, global_offset=off, global_shape=GLOBAL, halo=g)
    got = advect3d_kernel(_t(vpad), None, DT, True, **kw)
    own = advect3d_kernel(_t(vpad), _t(np.ascontiguousarray(
        _owned(vel, off))), DT, True, **kw)
    assert got.dtype == own.dtype and got.shape == (3, 12) + BLOCK
    assert torch.equal(got, own)
    _, want = _advect_both(vel, vel, True, off)
    tol = (dict(rtol=1e-4, atol=5e-5) if dtype == "float32" else
           dict(rtol=2 ** -7, atol=1e-6))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)), **tol)


@pytest.mark.parametrize("where,p0", [("corner", "zero"), ("far", "zero"),
                                      ("corner", "given"),
                                      ("interior", "given")])
def test_sor3d_chunk_matches_pallas(rng, where, p0):
    """One chunk of 2 sweeps on a haloed block (halo 4), from zero and from
    a given pressure, on the owned cells."""
    off, sweeps = OFFSETS[where], 2
    g = 2 * sweeps
    d = _haloed(rng.standard_normal(GLOBAL).astype(F), off, g)
    p = (np.zeros_like(d) if p0 == "zero"
         else rng.standard_normal(d.shape).astype(F))
    origin = (0, off[0] - g, off[1] - g)
    want = _sor3d_chunk(jnp.asarray(d), jnp.asarray(p), 1.0, sweeps, 1.5,
                        16, 16, 256, global_offset=jnp.asarray(origin),
                        global_shape=GLOBAL)
    got = sor3d_chunk(_t(d), _t(p), 1.0, sweeps, 1.5, global_offset=origin,
                      global_shape=GLOBAL)
    assert got.shape == d.shape and got.dtype == torch.float32
    own = (slice(None), slice(g, g + BLOCK[0]), slice(g, g + BLOCK[1]))
    np.testing.assert_allclose(got.numpy()[own], np.asarray(want)[own],
                               rtol=1e-4, atol=1e-5)
    # the cells outside the domain hold 0
    gi = np.arange(d.shape[1])[:, None] + origin[1]
    gj = np.arange(d.shape[2])[None, :] + origin[2]
    outside = (gi < 0) | (gi >= GLOBAL[1]) | (gj < 0) | (gj >= GLOBAL[2])
    assert not got.numpy()[:, outside].any()


@pytest.mark.parametrize("iters,chunk", [(5, 2), (4, 3), (3, 3)])
def test_sor3d_chunk_chain_equals_whole_grid(rng, iters, chunk):
    """The sharded steps' chain on the 2x2 blocks of the grid: one
    ``2*chunk``-wide exchange per chunk (zero-padded at the domain's edge),
    then ``sor3d_chunk`` from the pressure carried over; the owned cells
    equal the whole-grid solve's to the bit."""
    d = rng.standard_normal(GLOBAL).astype(F)
    want = sor3d_reference(_t(d), 1.0, iters, 1.7)
    ck = min(chunk, iters)
    g = 2 * ck
    offs = [(a * BLOCK[0], b * BLOCK[1]) for a in range(2) for b in range(2)]
    p = np.zeros(GLOBAL, F)
    done = 0
    while done < iters:
        kk = min(ck, iters - done)
        new = np.empty_like(p)
        for off in offs:
            full = sor3d_chunk(_t(_haloed(d, off, g)), _t(_haloed(p, off, g)),
                               1.0, kk, 1.7,
                               global_offset=(0, off[0] - g, off[1] - g),
                               global_shape=GLOBAL)
            new[:, off[0]:off[0] + BLOCK[0], off[1]:off[1] + BLOCK[1]] = (
                full.numpy()[:, g:g + BLOCK[0], g:g + BLOCK[1]])
        p = new
        done += kk
    np.testing.assert_array_equal(p, want.numpy())


def test_block_mode_argument_checks():
    """K7: a halo below max_disp+1 (the JAX kernel's ValueError), a domain
    whose D is not the field's (the vertical axis is shard-local), an
    offset of the wrong length, a velocity that is not the owned block.
    K9: an origin of the wrong length, a domain that is not 3D, d and p of
    different shapes."""
    f = torch.zeros((2, 4, 20, 28))
    v = torch.zeros((3, 4, 16, 24))
    kw = dict(global_offset=(0, 0), global_shape=(4, 32, 48))
    with pytest.raises(ValueError, match=r"halo >= max_disp\+1"):
        advect3d_kernel(f, v, DT, False, max_disp=2, halo=2, **kw)
    with pytest.raises(ValueError, match="shard-local"):
        advect3d_kernel(f, v, DT, False, max_disp=1, halo=2,
                        global_offset=(0, 0), global_shape=(6, 32, 48))
    with pytest.raises(ValueError, match="2 integers"):
        advect3d_kernel(f, v, DT, False, max_disp=1, halo=2,
                        global_offset=(0, 0, 0), global_shape=(4, 32, 48))
    with pytest.raises(ValueError, match="owned block"):
        advect3d_kernel(f, torch.zeros((3, 4, 20, 28)), DT, False,
                        max_disp=1, halo=2, **kw)
    with pytest.raises(ValueError, match="need global_offset"):
        advect3d_kernel(f, v, DT, False, max_disp=1, halo=2)
    d = torch.zeros((4, 20, 28))
    with pytest.raises(ValueError, match="3 integers"):
        sor3d_chunk(d, d, 1.0, 2, 1.5, global_offset=(-4, -4),
                    global_shape=(4, 32, 48))
    with pytest.raises(ValueError, match=r"\(D, H, W\)"):
        sor3d_chunk(d, d, 1.0, 2, 1.5, global_offset=(0, -4, -4),
                    global_shape=(32, 48))
    with pytest.raises(ValueError, match="one shape"):
        sor3d_chunk(d, d[:, 1:], 1.0, 2, 1.5)
    # without global_offset the array is the domain: the whole-grid solve
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (4, 20, 28)).astype(F))
    assert torch.equal(sor3d_chunk(x, torch.zeros_like(x), 1.0, 3, 1.5),
                       sor3d_reference(x, 1.0, 3, 1.5))

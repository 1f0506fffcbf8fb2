"""Block mode (K11) of K1, K2 and K4 — one shard's haloed block, its owned
block's global origin and the domain — through the plain PyTorch versions
(CPU tensors), against the JAX package's Pallas kernels called directly in
block mode, in interpret mode.

The global grid is 64x96; the 32x24 owned blocks sit at a corner (0, 0),
on an edge (32, 24) and inside (16, 36).  Each haloed block is cut from the
zero-padded grid, as the halo exchange builds it.  Tolerances are those of
test_torch_tiled_kernels_ref.py: K2 rtol 1e-5 / atol 2e-5 (a velocity
field compared in units of its scale 60: XLA contracts the interpret-mode
kernel's backtrace into an FMA), the bf16 dye to one bf16 ulp (rtol
2^-7); K1 and K4 rtol 1e-4 / atol 2e-5.  Each block result must also equal
the crop of the whole-grid plain version on the same cells, bit for bit.
"""

import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from jax.experimental import pallas as pl

from esp32_fluid_simulation_tpu import SimConfig as JConfig, Impulses as JImp
from esp32_fluid_simulation_tpu.ops.pallas.advect import advect_pallas
from esp32_fluid_simulation_tpu.ops.pallas.project import project_fused_pallas
from esp32_fluid_simulation_tpu.ops.pallas.sor import sor_solve_pallas
from esp32_fluid_simulation_tpu_torch import SimConfig, Impulses
from esp32_fluid_simulation_tpu_torch.interop import tensor_from_numpy
from esp32_fluid_simulation_tpu_torch.ops.cuda.advect import advect_kernel
from esp32_fluid_simulation_tpu_torch.ops.cuda.project import project_fused
from esp32_fluid_simulation_tpu_torch.ops.cuda.sor import sor_solve_kernel

torch.set_num_threads(1)

F = np.float32
GLOBAL = (64, 96)
BLOCK = (32, 24)
OFFSETS = {"corner": (0, 0), "edge": (32, 24), "interior": (16, 36)}


@pytest.fixture(autouse=True)
def interpret_pallas(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    yield


def _t(x):
    return tensor_from_numpy(np.asarray(x), device="cpu")


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32))


def _haloed(x, off, g):
    """The owned block at ``off`` with ``g`` ghosts per side, cut from the
    zero-padded grid (trailing two axes)."""
    pad = [(0, 0)] * (x.ndim - 2) + [(g, g), (g, g)]
    xp = np.pad(x, pad)
    return np.ascontiguousarray(xp[..., off[0]:off[0] + BLOCK[0] + 2 * g,
                                   off[1]:off[1] + BLOCK[1] + 2 * g])


def _owned(x, off):
    return x[..., off[0]:off[0] + BLOCK[0], off[1]:off[1] + BLOCK[1]]


def _smooth_vel(rng, scale=60.0):
    ii, jj = np.meshgrid(*(np.arange(n, dtype=F) for n in GLOBAL),
                         indexing="ij")
    ph = rng.random(4) * 2 * np.pi
    return np.stack([scale * np.sin(2 * np.pi * ii / 23 + ph[0])
                     * np.cos(2 * np.pi * jj / 31 + ph[1]),
                     scale * np.cos(2 * np.pi * ii / 19 + ph[2])
                     * np.sin(2 * np.pi * jj / 29 + ph[3])]).astype(F)


def _block_kw(off, g):
    return dict(global_offset=off, global_shape=GLOBAL, halo=g)


def _jblock_kw(off, g):
    return dict(global_offset=jnp.asarray(off, jnp.int32),
                global_shape=GLOBAL, halo=g)


@pytest.mark.parametrize("where", list(OFFSETS))
def test_advect_block_velocity_minmax_matches_pallas(rng, where):
    """The f32 velocity advected by itself (no-slip, at a global wall on
    the corner and edge blocks) with ``return_minmax``."""
    off, md = OFFSETS[where], 8
    vel = _smooth_vel(rng)
    fpad, vown = _haloed(vel, off, md + 1), _owned(vel, off)
    want = advect_pallas(jnp.asarray(fpad), jnp.asarray(vown), 1 / 30, True,
                         max_disp=md, return_minmax=True,
                         **_jblock_kw(off, md + 1))
    got = advect_kernel(_t(fpad), _t(vown), 1 / 30, True, max_disp=md,
                        return_minmax=True, **_block_kw(off, md + 1))
    whole = advect_kernel(_t(vel), _t(vel), 1 / 30, True, max_disp=md,
                          return_minmax=True)
    for g, w, full in zip(got, want, whole):
        assert tuple(g.shape) == (2,) + BLOCK
        np.testing.assert_allclose(_np(g) / 60, _np(w) / 60, rtol=1e-5,
                                   atol=2e-5)
        assert torch.equal(g, _owned(full, off))


@pytest.mark.parametrize("where", list(OFFSETS))
def test_advect_block_bf16_dye_matches_pallas(rng, where):
    """A 3-channel bf16 dye with the dye clip, through an f32 velocity of
    scale 60 (beyond the CFL clamp on some cells)."""
    off, md = OFFSETS[where], 12
    vel = (60 * rng.standard_normal((2,) + GLOBAL)).astype(F)
    dye = (1.4 * rng.random((3,) + GLOBAL, dtype=F) - 0.2).astype(
        jnp.bfloat16)
    fpad, vown = _haloed(dye, off, md + 1), _owned(vel, off)
    want = advect_pallas(jnp.asarray(fpad), jnp.asarray(vown), 1 / 30, False,
                         max_disp=md, clip01=True, **_jblock_kw(off, md + 1))
    got = advect_kernel(_t(fpad), _t(vown), 1 / 30, False, max_disp=md,
                        clip01=True, **_block_kw(off, md + 1))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (3,) + BLOCK
    np.testing.assert_allclose(_np(got), _np(want), rtol=2 ** -7, atol=2e-5)
    whole = advect_kernel(_t(dye), _t(vel), 1 / 30, False, max_disp=md,
                          clip01=True)
    assert torch.equal(got, _owned(whole, off))


@pytest.mark.parametrize("where", list(OFFSETS))
@pytest.mark.parametrize("with_impulses", [True, False])
def test_project_block_matches_pallas(rng, where, with_impulses):
    """K1 block mode: the drain at global positions (a duplicate cell, one
    outside this block, one out of range), the global walls and parity."""
    off, iters = OFFSETS[where], 3
    g = 2 * iters + 2
    vel = rng.normal(0, 40, (2,) + GLOBAL).astype(F)
    pos = [(20, 30), (20, 30), (40, 50), (99, -3), (1, 40)]
    val = [(90.0, -45.0), (33.0, 44.0), (-60.0, 120.0), (7.0, 8.0),
           (5.0, -5.0)]
    jimp = timp = None
    if with_impulses:
        jimp = JImp.from_lists(JConfig(shape=GLOBAL), pos, val)
        timp = Impulses.from_lists(SimConfig(shape=GLOBAL), pos, val,
                                   device="cpu")
    vpad = _haloed(vel, off, g)
    want_v, want_p = project_fused_pallas(jnp.asarray(vpad), 1.0, iters,
                                          1.96, impulses=jimp,
                                          **_jblock_kw(off, g))
    got_v, got_p = project_fused(_t(vpad), 1.0, iters, 1.96, impulses=timp,
                                 **_block_kw(off, g))
    assert tuple(got_v.shape) == (2,) + BLOCK
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), rtol=1e-4,
                               atol=2e-5)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), rtol=1e-4,
                               atol=2e-5)
    whole_v, whole_p = project_fused(_t(vel), 1.0, iters, 1.96,
                                     impulses=timp)
    assert torch.equal(got_v, _owned(whole_v, off))
    assert torch.equal(got_p, _owned(whole_p, off))


@pytest.mark.parametrize("where", list(OFFSETS))
def test_sor_block_matches_pallas(rng, where):
    off, iters = OFFSETS[where], 3
    d = rng.standard_normal(GLOBAL).astype(F)
    dpad = _haloed(d, off, 2 * iters)
    for dx in (1.0, 0.5):
        want = sor_solve_pallas(jnp.asarray(dpad), dx, iters, 1.96,
                                **_jblock_kw(off, 2 * iters))
        got = sor_solve_kernel(_t(dpad), dx, iters, 1.96,
                               **_block_kw(off, 2 * iters))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=2e-5)
        assert torch.equal(got, _owned(sor_solve_kernel(_t(d), dx, iters,
                                                        1.96), off))


def test_block_mode_with_members_and_wider_halos_equals_the_crop(rng):
    """K1 and K4 take ``member=`` in block mode (member tiles of the
    domain), and a halo wider than needed changes nothing; the offset may
    be a 2-element integer tensor."""
    off = (16, 48)
    vel = _t(rng.normal(0, 40, (2,) + GLOBAL).astype(F))
    d = _t(rng.standard_normal(GLOBAL).astype(F))
    member = (16, 24)
    wv, wp = project_fused(vel, 1.0, 2, 1.96, member=member)
    for g in (6, 9):
        bv, bp = project_fused(_t(_haloed(vel.numpy(), off, g)), 1.0, 2,
                               1.96, member=member,
                               global_offset=torch.tensor(off),
                               global_shape=GLOBAL, halo=g)
        assert torch.equal(bv, _owned(wv, off))
        assert torch.equal(bp, _owned(wp, off))
        got = sor_solve_kernel(_t(_haloed(d.numpy(), off, g)), 0.7, 2, 1.5,
                               member=member, **_block_kw(off, g))
        assert torch.equal(got, _owned(sor_solve_kernel(
            d, 0.7, 2, 1.5, member=member), off))


def test_block_mode_argument_checks():
    """The JAX kernels' ValueErrors (a halo below what the solve or the
    backtrace needs, self-advect and the overlay in block mode), and the
    port's own: a block outside the domain, a velocity of the wrong shape,
    block-mode arguments without ``global_offset``; member= and rgb565=
    with K2 block mode are not ported."""
    f = torch.zeros((2, 40, 30))
    v = torch.zeros((2, 20, 10))
    kw = dict(global_offset=(0, 0), global_shape=GLOBAL)
    with pytest.raises(ValueError, match=r"halo >= 2\*iters\+2"):
        project_fused(f, 1.0, 3, 1.96, halo=7, **kw)
    with pytest.raises(ValueError, match=r"halo >= 2\*iters"):
        sor_solve_kernel(f[0], 1.0, 3, 1.96, halo=5, **kw)
    with pytest.raises(ValueError, match=r"halo >= max_disp\+1"):
        advect_kernel(f, v, 0.1, False, max_disp=12, halo=10, **kw)
    with pytest.raises(ValueError, match="self_advect"):
        advect_kernel(f, None, 0.1, True, max_disp=8, self_advect=True,
                      halo=10, **kw)
    with pytest.raises(ValueError, match="overlay"):
        advect_kernel(f, v, 0.1, True, max_disp=8, halo=10,
                      overlay=torch.zeros((3, 40, 30)), **kw)
    with pytest.raises(ValueError, match="does not lie in"):
        sor_solve_kernel(f[0], 1.0, 3, 1.96, halo=6,
                         global_offset=(60, 0), global_shape=GLOBAL)
    with pytest.raises(ValueError, match="owned velocity"):
        advect_kernel(f, f, 0.1, False, max_disp=8, halo=10, **kw)
    with pytest.raises(ValueError, match="need global_offset"):
        sor_solve_kernel(f[0], halo=6)
    with pytest.raises(ValueError, match="global_shape"):
        sor_solve_kernel(f[0], 1.0, 3, 1.96, halo=6, global_offset=(0, 0))
    dye = torch.zeros((3, 40, 30))
    with pytest.raises(NotImplementedError, match="member"):
        advect_kernel(dye, v, 0.1, False, max_disp=8, halo=10,
                      member=(4, 4), **kw)
    with pytest.raises(NotImplementedError, match="rgb565"):
        advect_kernel(dye, v, 0.1, False, max_disp=8, halo=10, clip01=True,
                      rgb565=True, **kw)

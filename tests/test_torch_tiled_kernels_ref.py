"""The tiled-domain modes (K6) of the port's kernels — ``member=`` of K1, K2,
K4 and K5 and K2's ``overlay=`` — through their plain PyTorch versions,
against the JAX package's Pallas kernels in interpret mode (CPU).

Inputs come from a numpy seed; each member grid is cut into odd (17x21)
and even (32x64 or 20x64) member tiles.  Tolerances are those of the
matching non-member tests (test_torch_kernels_ref.py,
test_torch_advectors.py, test_torch_solvers.py): K2 rtol 1e-5 / atol 2e-5,
a self-advected velocity compared in units of its scale (XLA contracts the
interpret-mode kernel's backtrace into an FMA), bf16 dye to one bf16 ulp
(rtol 2^-7); K1 and K4 rtol 1e-4 / atol 2e-5.  The overlay drain must also
equal the scatter after the advect bit for bit, as test_pallas.py:576-611
holds the JAX kernel to it.  The wrappers are called with CPU tensors, so
they run the plain versions.
"""

import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from jax.experimental import pallas as pl

from esp32_fluid_simulation_tpu import SimConfig as JConfig, Impulses as JImp
from esp32_fluid_simulation_tpu.models import stable_fluids as jsf
from esp32_fluid_simulation_tpu.ops.pallas.advect import (
    advect_maccormack_pallas, advect_pallas)
from esp32_fluid_simulation_tpu.ops.pallas.project import project_fused_pallas
from esp32_fluid_simulation_tpu.ops.pallas.sor import sor_solve_pallas
from esp32_fluid_simulation_tpu_torch import SimConfig, Impulses, render_rgb565
from esp32_fluid_simulation_tpu_torch.interop import (tensor_from_numpy,
                                                      tensor_to_numpy)
from esp32_fluid_simulation_tpu_torch.models import stable_fluids as tsf
from esp32_fluid_simulation_tpu_torch.ops.cuda.advect import (
    advect_kernel, advect_maccormack_kernel, advect_maccormack_reference,
    advect_reference)
from esp32_fluid_simulation_tpu_torch.ops.cuda.project import (
    project_fused, project_fused_reference)
from esp32_fluid_simulation_tpu_torch.ops.cuda.sor import (
    sor_solve_kernel, sor_solve_reference)

torch.set_num_threads(1)

F = np.float32
# (grid, member): a 2x3 grid of odd members and a 2x2 grid of even ones
TILINGS = {"odd": ((34, 63), (17, 21)), "even": ((64, 128), (32, 64))}


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


def _bits(t):
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def _smooth_vel(shape, scale, rng):
    """A smooth velocity field, as a fluid's is: the self-advect amplifies
    the one-ulp FMA coordinate shift of the interpret-mode kernel by the
    field's neighbour differences."""
    ii, jj = np.meshgrid(*(np.arange(n, dtype=F) for n in shape),
                         indexing="ij")
    ph = rng.random(4) * 2 * np.pi
    return np.stack([scale * np.sin(2 * np.pi * ii / 23 + ph[0])
                     * np.cos(2 * np.pi * jj / 31 + ph[1]),
                     scale * np.cos(2 * np.pi * ii / 19 + ph[2])
                     * np.sin(2 * np.pi * jj / 29 + ph[3])]).astype(F)


@pytest.mark.parametrize("tiling", ["odd", "even"])
@pytest.mark.parametrize("max_disp", [12, 1])
def test_advect_member_self_advect_matches_pallas(rng, tiling, max_disp):
    """The member clamps and the member-relative no-slip factor; at
    ``max_disp=1`` the CFL clamp binds on most cells first."""
    shape, member = TILINGS[tiling]
    vs = _smooth_vel(shape, 60.0, rng)
    want = advect_pallas(jnp.asarray(vs), jnp.asarray(vs), 1 / 30., True,
                         max_disp=max_disp, variant="sloop",
                         self_advect=True, member=member)
    got = advect_kernel(_t(vs), None, 1 / 30., True, max_disp=max_disp,
                        self_advect=True, member=member)
    np.testing.assert_allclose(got.numpy() / 60, np.asarray(want) / 60,
                               rtol=1e-5, atol=2e-5)
    # the member walls act: the unmembered advect gives another field
    whole = advect_kernel(_t(vs), None, 1 / 30., True, max_disp=max_disp,
                          self_advect=True)
    assert float((got - whole).abs().max()) > 1.0


@pytest.mark.parametrize("tiling", ["odd", "even"])
def test_advect_member_dye_matches_pallas(rng, tiling):
    """Two-input dye advects: a 2-channel f32 field with no-slip, and the
    bf16 RGB dye with clip01 and the RGB565 frame of the whole supergrid
    riding the member-mode store (``advect.py:957-960``)."""
    shape, member = TILINGS[tiling]
    vel = (60 * rng.standard_normal((2,) + shape)).astype(F)
    f = rng.random((2,) + shape, dtype=F)
    want = advect_pallas(jnp.asarray(f), jnp.asarray(vel), 1 / 30., True,
                         max_disp=12, member=member)
    got = advect_kernel(_t(f), _t(vel), 1 / 30., True, max_disp=12,
                        member=member)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=2e-5)

    dye = (3.0 * rng.random((3,) + shape, dtype=F) - 1.0).astype(
        jnp.bfloat16)
    kw = dict(max_disp=8, clip01=True, rgb565=True, bswap=True,
              member=member)
    want_c, want_f = advect_pallas(jnp.asarray(dye), jnp.asarray(vel), 1 / 30,
                                   False, variant="sloop", **kw)
    got_c, got_f = advect_kernel(_t(dye), _t(vel), 1 / 30, False, **kw)
    assert got_f.dtype == torch.uint16
    assert tuple(got_f.shape) == (shape[0] - 1, shape[1] - 1)
    want_c, got_c = _np(want_c), _np(got_c)
    np.testing.assert_allclose(got_c, want_c, rtol=2 ** -7, atol=2e-5)
    same = (got_c == want_c).all(axis=0)[:-1, :-1]
    np.testing.assert_array_equal(got_f.numpy()[same],
                                  np.asarray(want_f)[same])
    # the frame packs the stored dye, as render_rgb565(color, s=1) does
    stored = torch.from_numpy(got_c).to(torch.bfloat16)
    assert torch.equal(got_f, render_rgb565(stored, s=1, unit_range=True))


@pytest.mark.parametrize("member", [None, (32, 64)])
def test_advect_overlay_matches_pallas(rng, member):
    """``overlay=`` (test_pallas.py:576-611 on the port): the drain riding
    the store equals ``apply_impulses`` after the advect bit for bit, with a
    duplicate slot (the last active wins) and a zero-velocity write (the
    flag, not the value, gates it), in f32 and bf16 and for a two-input
    field; against the JAX kernel at the K2 tolerances."""
    shape = (64, 128)
    pos = [(5, 7), (20, 40), (5, 7), (30, 100)]
    val = [(30.0, -12.0), (-8.0, 25.0), (99.0, 1.0), (0.0, 0.0)]
    jimp = JImp.from_lists(JConfig(shape=shape, max_impulses=8), pos, val)
    timp = Impulses.from_lists(SimConfig(shape=shape, max_impulses=8), pos,
                               val, device="cpu")
    jov = jsf.impulse_overlay(jimp, shape)
    tov = tsf.impulse_overlay(timp, shape)
    np.testing.assert_array_equal(tov.numpy(), np.asarray(jov))
    vs = _smooth_vel(shape, 60.0, rng)
    kw = dict(max_disp=8, member=member)
    for dtype in (torch.float32, torch.bfloat16):
        v = _t(vs).to(dtype)
        got = advect_kernel(v, None, 1 / 30, True, self_advect=True,
                            overlay=tov, **kw)
        ref = tsf.apply_impulses(
            advect_kernel(v, None, 1 / 30, True, self_advect=True, **kw),
            timp)
        assert got.dtype == dtype
        assert torch.equal(_bits(got), _bits(ref))
        jv = jnp.asarray(vs).astype(jnp.bfloat16 if dtype == torch.bfloat16
                                    else jnp.float32)
        want = advect_pallas(jv, jv, 1 / 30, True, self_advect=True,
                             overlay=jov, variant="sloop", **kw)
        tol = (dict(rtol=2 ** -7, atol=2e-5) if dtype == torch.bfloat16
               else dict(rtol=1e-5, atol=2e-5))
        np.testing.assert_allclose(_np(got) / 60, _np(want) / 60, **tol)
    dye = rng.random((2,) + shape, dtype=F)
    vel = (60 * rng.standard_normal((2,) + shape)).astype(F)
    got = advect_kernel(_t(dye), _t(vel), 1 / 30, False, overlay=tov, **kw)
    ref = tsf.apply_impulses(advect_kernel(_t(dye), _t(vel), 1 / 30, False,
                                           **kw), timp)
    assert torch.equal(_bits(got), _bits(ref))
    want = advect_pallas(jnp.asarray(dye), jnp.asarray(vel), 1 / 30, False,
                         overlay=jov, variant="sloop", **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=2e-5)


@pytest.mark.parametrize("tiling", ["odd", "even"])
@pytest.mark.parametrize("with_impulses", [True, False])
def test_project_member_plain_matches_pallas(rng, tiling, with_impulses):
    """Member walls in the divergence, the SOR and the gradient, with the
    supergrid's red-black parity; impulses drain first (one on a member
    wall, a duplicate cell, an out-of-range position)."""
    shape, member = TILINGS[tiling]
    vel = rng.normal(0, 40, (2,) + shape).astype(F)
    pos = [(member[0], 5), (20, 30), (20, 30), (99, -3)]
    val = [(90.0, -45.0), (33.0, 44.0), (-60.0, 120.0), (7.0, 8.0)]
    jimp = timp = None
    if with_impulses:
        jimp = JImp.from_lists(JConfig(shape=shape), pos, val)
        timp = Impulses.from_lists(SimConfig(shape=shape), pos, val,
                                   device="cpu")
    want_v, want_p = project_fused_pallas(jnp.asarray(vel), 1.0, 3, 1.96,
                                          impulses=jimp, member=member)
    got_v, got_p = project_fused(_t(vel), 1.0, 3, 1.96, impulses=timp,
                                 member=member)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), rtol=1e-4,
                               atol=2e-5)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), rtol=1e-4,
                               atol=2e-5)


@pytest.mark.parametrize("tiling", ["odd", "even"])
def test_sor_member_plain_matches_pallas(rng, tiling):
    shape, member = TILINGS[tiling]
    d = rng.standard_normal(shape).astype(F)
    for dx in (1.0, 0.5):
        got = sor_solve_kernel(_t(d), dx, 3, 1.96, member=member).numpy()
        want = np.asarray(sor_solve_pallas(jnp.asarray(d), dx, 3, 1.96,
                                           member=member))
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-5)


@pytest.mark.parametrize("case", ["velocity_f32_noslip", "dye_bf16"])
def test_maccormack_member_plain_matches_pallas(rng, case):
    """K5 with ``member=`` in both passes (``advect.py:977-981``): the
    velocity in units of its scale 60, the bf16 dye to one bf16 ulp."""
    shape, member = (40, 128), (20, 64)
    v = _smooth_vel(shape, 60.0, rng)
    if case == "velocity_f32_noslip":
        field, no_slip, scale = v, True, 60.0
        tol = dict(rtol=1e-5, atol=2e-5)
    else:
        field = rng.random((3,) + shape, dtype=F).astype(jnp.bfloat16)
        no_slip, scale = False, 1.0
        tol = dict(rtol=2 ** -7, atol=2e-5)
    want = advect_maccormack_pallas(jnp.asarray(field), jnp.asarray(v),
                                    1 / 30, no_slip, max_disp=8,
                                    member=member)
    got = advect_maccormack_kernel(_t(field), _t(v), 1 / 30, no_slip,
                                   max_disp=8, member=member)
    assert got.dtype == _t(field).dtype and tuple(got.shape) == field.shape
    np.testing.assert_allclose(_np(got) / scale, _np(want) / scale, **tol)
    ref = advect_maccormack_reference(_t(field), _t(v), 1 / 30, no_slip,
                                      max_disp=8, member=member)
    np.testing.assert_array_equal(tensor_to_numpy(got), tensor_to_numpy(ref))


def test_one_member_is_the_whole_grid(rng):
    """A single member tile covering the grid gives the unmembered plain
    versions bit for bit (the member forms share their arithmetic)."""
    shape = (34, 63)
    vel = _t(rng.normal(0, 60, (2,) + shape).astype(F))
    dye = _t(rng.random((3,) + shape, dtype=F))
    d = _t(rng.standard_normal(shape).astype(F))
    for no_slip in (True, False):
        assert torch.equal(
            advect_reference(vel, vel, 1 / 30, no_slip, member=shape),
            advect_reference(vel, vel, 1 / 30, no_slip))
        assert torch.equal(
            advect_maccormack_reference(dye, vel, 1 / 30, no_slip,
                                        member=shape),
            advect_maccormack_reference(dye, vel, 1 / 30, no_slip))
    for a, b in zip(project_fused_reference(vel, 0.7, 4, 1.96, member=shape),
                    project_fused_reference(vel, 0.7, 4, 1.96)):
        assert torch.equal(a, b)
    assert torch.equal(sor_solve_reference(d, 0.7, 4, 1.5, member=shape),
                       sor_solve_reference(d, 0.7, 4, 1.5))


def test_tiled_modes_refusals(rng):
    """Block mode (K11) runs: a haloed block of the grid gives the crop of
    the whole-grid result, with and without member tiles (K1, K4), while K5
    refuses it with ValueError as the JAX kernel does; the overlay is
    refused with the frame or the extrema (so by K5) and at a wrong shape,
    as in the JAX kernel; a member must tile the grid."""
    f = torch.zeros((2, 8, 8))
    d = torch.zeros((8, 8))
    grid = _t(rng.normal(0, 30, (2, 16, 24)).astype(F))
    dd = grid[0].contiguous()
    off, g = (8, 12), 6

    def block(x):
        pad = torch.nn.functional.pad(x, (g, g, g, g))
        return pad[..., off[0]:off[0] + 8 + 2 * g,
                   off[1]:off[1] + 12 + 2 * g].contiguous()

    def crop(x):
        return x[..., off[0]:off[0] + 8, off[1]:off[1] + 12]

    kw = dict(global_offset=off, global_shape=(16, 24), halo=g)
    for member in (None, (8, 12)):
        assert torch.equal(sor_solve_kernel(block(dd), 1.0, 3, 1.96,
                                            member=member, **kw),
                           crop(sor_solve_kernel(dd, 1.0, 3, 1.96,
                                                 member=member)))
        for got, want in zip(project_fused(block(grid), 1.0, 2, 1.96,
                                           member=member, **kw),
                             project_fused(grid, 1.0, 2, 1.96,
                                           member=member)):
            assert torch.equal(got, crop(want))
    assert torch.equal(
        advect_kernel(block(grid), crop(grid).contiguous(), 0.1, True,
                      max_disp=5, **kw),
        crop(advect_kernel(grid, grid, 0.1, True, max_disp=5)))
    for bkw in (dict(global_offset=torch.zeros(2)), dict(halo=20)):
        with pytest.raises(ValueError, match="single-device only"):
            advect_maccormack_kernel(f, f, 0.1, False, **bkw)
    with pytest.raises(TypeError):
        project_fused(f, tile_h=8)
    dye = torch.zeros((3, 8, 8))
    with pytest.raises(ValueError, match="overlay"):
        advect_kernel(dye, f, 0.1, False, clip01=True, rgb565=True,
                      overlay=torch.zeros((4, 8, 8)))
    with pytest.raises(ValueError, match="overlay"):
        advect_kernel(f, f, 0.1, False, return_minmax=True,
                      overlay=torch.zeros((3, 8, 8)))
    with pytest.raises(TypeError, match="overlay"):
        advect_maccormack_kernel(f, f, 0.1, False,
                                 overlay=torch.zeros((3, 8, 8)))
    with pytest.raises(ValueError, match=r"overlay must be \[3, H, W\]"):
        advect_kernel(f, f, 0.1, False, overlay=torch.zeros((2, 8, 8)))
    for member in ((3, 4), (8, 1)):
        with pytest.raises(ValueError, match="member"):
            advect_kernel(f, f, 0.1, False, member=member)
        with pytest.raises(ValueError, match="member"):
            project_fused(f, member=member)
        with pytest.raises(ValueError, match="member"):
            sor_solve_kernel(d, member=member)
    # the JAX defaults mean "not asked for"
    assert torch.equal(advect_kernel(f, f, 0.1, False, halo=0, member=None,
                                     overlay=None), f)
    assert torch.equal(project_fused(f, halo=0, global_offset=None)[0], f)

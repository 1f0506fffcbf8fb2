"""Each CUDA kernel's plain PyTorch version against the JAX package's Pallas
kernel, on the same numpy-seeded inputs (CPU).

The Pallas kernels run in interpret mode through a local fixture, as
tests/test_pallas.py runs them.  Inputs and tolerances follow
test_pallas.py: K2 rtol 1e-5 / atol 2e-5 (:31-38), its RGB565 case
(:516-547) and a CFL-clamp case (:68-80); K1 with impulses (:439-459) at
rtol 1e-4 / atol 2e-5 (:122); K3 bit-equal (:141-183).  The wrappers are
called with CPU tensors, so they run the plain versions.
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
from esp32_fluid_simulation_tpu.render.pallas_upscale import (
    render_rgb565_pallas)
from esp32_fluid_simulation_tpu_torch import SimConfig, Impulses
from esp32_fluid_simulation_tpu_torch.interop import (tensor_from_numpy,
                                                      tensor_to_numpy)
from esp32_fluid_simulation_tpu_torch.ops.cuda.advect import advect_kernel
from esp32_fluid_simulation_tpu_torch.ops.cuda.project import project_fused
from esp32_fluid_simulation_tpu_torch.render.cuda_upscale import (
    render_rgb565_kernel)

torch.set_num_threads(1)

F = np.float32


@pytest.fixture(autouse=True)
def interpret_pallas(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    yield


def _t(x):
    return tensor_from_numpy(np.asarray(x), device="cpu")


@pytest.mark.parametrize("shape,no_slip", [((61, 81), False),
                                           ((96, 200), True)])
def test_advect_plain_matches_pallas(rng, shape, no_slip):
    f = rng.random((2,) + shape, dtype=F)
    v = (60 * rng.standard_normal((2,) + shape)).astype(F)
    want = advect_pallas(jnp.asarray(f), jnp.asarray(v), 1 / 30., no_slip,
                         max_disp=12)
    got = advect_kernel(_t(f), _t(v), 1 / 30., no_slip, max_disp=12)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=2e-5)
    # self-advect: the field is the velocity, smooth as a fluid's is, and
    # compared in units of its scale (60).  XLA contracts the Pallas
    # kernel's backtrace x - v*dt into one FMA; the one-ulp coordinate shift
    # is amplified by the field's neighbour differences (white noise of
    # scale 60 would make them ~1e3x larger than the unit dye's above).
    ii, jj = np.meshgrid(*(np.arange(n, dtype=F) for n in shape),
                         indexing="ij")
    ph = rng.random(4) * 2 * np.pi
    vs = np.stack([60 * np.sin(2 * np.pi * ii / 40 + ph[0])
                   * np.cos(2 * np.pi * jj / 50 + ph[1]),
                   60 * np.cos(2 * np.pi * ii / 30 + ph[2])
                   * np.sin(2 * np.pi * jj / 45 + ph[3])]).astype(F)
    want = advect_pallas(jnp.asarray(vs), jnp.asarray(vs), 1 / 30., no_slip,
                         max_disp=12, variant="sloop", self_advect=True)
    got = advect_kernel(_t(vs), None, 1 / 30., no_slip, max_disp=12,
                        self_advect=True)
    np.testing.assert_allclose(got.numpy() / 60, np.asarray(want) / 60,
                               rtol=1e-5, atol=2e-5)


def test_advect_plain_cfl_clamp_matches_pallas(rng):
    """Displacements beyond max_disp are clamped in both versions."""
    shape = (48, 96)
    f = rng.random(shape, dtype=F)
    v = (400 * rng.standard_normal((2,) + shape)).astype(F)
    want = advect_pallas(jnp.asarray(f), jnp.asarray(v), 1 / 30., False,
                         max_disp=4)
    got = advect_kernel(_t(f), _t(v), 1 / 30., False, max_disp=4)
    assert got.shape == shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=2e-5)


@pytest.mark.parametrize("dtype,bswap", [("bfloat16", True),
                                         ("float32", False)])
def test_advect_plain_rgb565_matches_pallas(rng, dtype, bswap):
    """clip01 + the RGB565 frame riding the dye store (test_pallas.py
    :516-547): the stored dye agrees to the tolerance, bf16 to one ulp
    (rtol 2^-7: the interpret-mode kernel's fused backtrace can move a
    value across a rounding boundary); the frame packs the stored values,
    so it agrees wherever they do."""
    vel = (rng.normal(0, 80, (2, 96, 256))).astype(F)
    dye = (3.0 * rng.random((3, 96, 256), dtype=F) - 1.0).astype(
        jnp.dtype(dtype))
    kw = dict(max_disp=8, clip01=True, rgb565=True, bswap=bswap)
    want_c, want_f = advect_pallas(jnp.asarray(dye), jnp.asarray(vel),
                                   1 / 30, False, tile_h=32, tile_w=128,
                                   variant="sloop", **kw)
    got_c, got_f = advect_kernel(_t(dye), _t(vel), 1 / 30, False, **kw)
    assert got_f.dtype == torch.uint16 and got_f.shape == (95, 255)
    want_c = np.asarray(want_c.astype(jnp.float32))
    got_c = got_c.float().numpy()
    np.testing.assert_allclose(got_c, want_c, rtol=2 ** -7, atol=2e-5)
    same = (got_c == want_c).all(axis=0)[:-1, :-1]
    np.testing.assert_array_equal(got_f.numpy()[same],
                                  np.asarray(want_f)[same])
    with pytest.raises(ValueError, match="rgb565"):
        advect_kernel(_t(dye), _t(vel), 1 / 30, False, rgb565=True)


def test_advect_kernel_rejects_unported_flags(rng):
    """Block mode (K11) runs and gives the crop of the whole-grid advect
    (test_torch_block_kernels_ref.py holds it to JAX); ``overlay=`` and
    ``member=`` (K6) are taken (test_torch_tiled_kernels_ref.py holds them
    to JAX); an unknown flag raises."""
    f = torch.from_numpy(rng.random((2, 8, 8), dtype=F))
    v = torch.from_numpy((40 * rng.standard_normal((2, 8, 8))).astype(F))
    got = advect_kernel(torch.nn.functional.pad(f, (3, 3, 3, 3))[:, 4:, 3:13],
                        v[:, 4:, 3:7].contiguous(), 0.1, False, max_disp=2,
                        global_offset=torch.tensor([4, 3]),
                        global_shape=(8, 8), halo=3)
    assert torch.equal(got, advect_kernel(f, v, 0.1, False,
                                          max_disp=2)[:, 4:, 3:7])
    with pytest.raises(TypeError):
        advect_kernel(f, f, 0.1, False, no_such_flag=True)
    flag = torch.zeros((1, 8, 8))
    flag[0, 3, 4] = 1.0
    ov = torch.cat([torch.full((2, 8, 8), 7.0), flag])
    got = advect_kernel(f, f, 0.1, False, overlay=ov, member=(4, 4))
    want = advect_kernel(f, f, 0.1, False, member=(4, 4))
    want[:, 3, 4] = 7.0
    assert torch.equal(got, want)


@pytest.mark.parametrize("with_impulses", [True, False])
def test_project_plain_matches_pallas(rng, with_impulses):
    """Drain (duplicate cell: the last active slot wins; out-of-range
    position: clamped) -> divergence -> SOR -> gradient subtract."""
    shape = (64, 96)
    vel = rng.normal(0, 40, (2,) + shape).astype(F)
    pos = [(20, 30), (20, 30), (40, 50), (99, -3)]
    val = [(90.0, -45.0), (33.0, 44.0), (-60.0, 120.0), (7.0, 8.0)]
    jimp = timp = None
    if with_impulses:
        jimp = JImp.from_lists(JConfig(shape=shape), pos, val)
        timp = Impulses.from_lists(SimConfig(shape=shape), pos, val,
                                    device="cpu")
    want_v, want_p = project_fused_pallas(jnp.asarray(vel), 1.0, 3, 1.96,
                                          impulses=jimp)
    got_v, got_p = project_fused(_t(vel), 1.0, 3, 1.96, impulses=timp)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), rtol=1e-4,
                               atol=2e-5)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), rtol=1e-4,
                               atol=2e-5)


@pytest.mark.parametrize("shape,s", [((61, 81), 4), ((33, 130), 4),
                                     ((17, 129), 2)])
def test_render_plain_bit_equal_to_pallas(rng, shape, s):
    c = rng.random((3,) + shape, dtype=F)
    for dtype in (jnp.float32, jnp.bfloat16):
        cj = jnp.asarray(c).astype(dtype)
        want = render_rgb565_pallas(cj, s=s, tile_h=16, tile_w=128)
        got = render_rgb565_kernel(_t(cj), s)
        assert got.dtype == torch.uint16
        np.testing.assert_array_equal(tensor_to_numpy(got), np.asarray(want))


def test_render_plain_unit_range_bit_equal_to_pallas(rng):
    """unit_range=True is bit-exact for [0, 1] inputs incl. the exact 0.0
    and 1.0 endpoints, in both bswap orders."""
    c = rng.random((3, 61, 81), dtype=F)
    c[:, ::7, ::5] = 1.0
    c[:, 1::9, ::3] = 0.0
    for bswap in (True, False):
        want = render_rgb565_pallas(jnp.asarray(c), s=4, tile_h=16,
                                    tile_w=128, bswap=bswap, unit_range=True)
        got = render_rgb565_kernel(_t(c), 4, bswap=bswap, unit_range=True)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

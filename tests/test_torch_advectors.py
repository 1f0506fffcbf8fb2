"""The port's higher-order advectors against the JAX package (CPU).

* ``sample_linear(return_minmax=True)``, ``advect_rk2`` and
  ``advect_maccormack`` against the JAX ops on the same numpy-seeded
  inputs, in 2D and 3D, at test_torch_ops.py's advect tolerance (rtol 2e-6
  / atol 2e-6); the corner extrema are exact, so they must be equal.
* K2's ``return_minmax`` and K5's plain versions against the JAX Pallas
  kernels (``advect_pallas(return_minmax=True)``,
  ``advect_maccormack_pallas``) in interpret mode, as
  test_torch_kernels_ref.py runs them.  XLA contracts the interpret-mode
  kernel's backtrace ``x - v*dt`` into one FMA (ROADMAP queue 3), so the
  velocity is compared in units of its scale (rtol 1e-5 / atol 2e-5, as
  test_pallas.py:332-346 holds the kernel to the eager op), and the bf16
  dye to one bf16 ulp (rtol 2^-7).
"""

import functools
import importlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from jax.experimental import pallas as pl

from esp32_fluid_simulation_tpu.ops.pallas.advect import (
    advect_maccormack_pallas, advect_pallas)
from esp32_fluid_simulation_tpu_torch.interop import (tensor_from_numpy,
                                                      tensor_to_numpy)
from esp32_fluid_simulation_tpu_torch.ops.cuda.advect import (
    advect_kernel, advect_maccormack_kernel, advect_maccormack_reference)

# the packages' __init__ re-export the function ``advect`` under the module
# name, so fetch the modules themselves
j_advect = importlib.import_module("esp32_fluid_simulation_tpu.ops.advect")
t_advect = importlib.import_module(
    "esp32_fluid_simulation_tpu_torch.ops.advect")

torch.set_num_threads(1)

F = np.float32
SHAPES = {"2d": (13, 17), "3d": (6, 9, 11)}


@pytest.fixture
def interpret_pallas(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def _t(x):
    return tensor_from_numpy(np.asarray(x), device="cpu")


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32))


def _vel(rng, shape, scale):
    return (scale * rng.standard_normal((len(shape),) + shape)).astype(F)


@pytest.mark.parametrize("no_slip", [False, True])
@pytest.mark.parametrize("dim", ["2d", "3d"])
def test_sample_linear_minmax_matches_jax(rng, dim, no_slip):
    """Value and the undiscounted corner extrema, incl. coordinates far
    outside the domain."""
    shape = SHAPES[dim]
    f = rng.random((2,) + shape, dtype=F)
    coords = [(rng.random(shape) * (n + 6) - 3).astype(F) for n in shape]
    got = t_advect.sample_linear(_t(f), [_t(c) for c in coords],
                                 no_slip=no_slip, return_minmax=True)
    want = j_advect.sample_linear(jnp.asarray(f),
                                  [jnp.asarray(c) for c in coords],
                                  no_slip=no_slip, return_minmax=True)
    np.testing.assert_allclose(_np(got[0]), _np(want[0]), rtol=2e-6,
                               atol=2e-6)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(_np(g), _np(w))
    assert (_np(got[1]) <= _np(got[2])).all()


@pytest.mark.parametrize("no_slip", [False, True])
@pytest.mark.parametrize("dim", ["2d", "3d"])
def test_advect_rk2_matches_jax(rng, dim, no_slip):
    shape = SHAPES[dim]
    v = _vel(rng, shape, 20.0)
    f = rng.random((3,) + shape, dtype=F)
    for field in (v, f):
        got = t_advect.advect_rk2(_t(field), _t(v), 1 / 30, no_slip)
        want = j_advect.advect_rk2(jnp.asarray(field), jnp.asarray(v),
                                   1 / 30, no_slip)
        np.testing.assert_allclose(_np(got), _np(want), rtol=2e-6,
                                   atol=2e-6)


@pytest.mark.parametrize("no_slip", [False, True])
@pytest.mark.parametrize("dim", ["2d", "3d"])
def test_advect_maccormack_matches_jax(rng, dim, no_slip):
    """float32 velocity self-advect and dye; the limiter keeps the dye
    inside the range of its input."""
    shape = SHAPES[dim]
    v = _vel(rng, shape, 20.0)
    f = rng.random((3,) + shape, dtype=F)
    for field in (v, f):
        got = t_advect.advect_maccormack(_t(field), _t(v), 1 / 30, no_slip)
        want = j_advect.advect_maccormack(jnp.asarray(field),
                                          jnp.asarray(v), 1 / 30, no_slip)
        np.testing.assert_allclose(_np(got), _np(want), rtol=2e-6,
                                   atol=2e-6)
    got = _np(t_advect.advect_maccormack(_t(f), _t(v), 1 / 30, no_slip))
    assert got.min() >= 0.0 and got.max() <= f.max()


def test_advect_maccormack_bf16_matches_jax(rng):
    """A bf16 dye: both packages lerp and limit in bf16, op by op; they
    agree to one bf16 ulp (rtol 2^-7), since XLA may keep a fused chain of
    bf16 ops in float32 where PyTorch rounds after each."""
    shape = SHAPES["2d"]
    v = _vel(rng, shape, 20.0)
    f = rng.random((3,) + shape, dtype=F)
    got = t_advect.advect_maccormack(_t(f).to(torch.bfloat16), _t(v),
                                     1 / 30, False)
    want = j_advect.advect_maccormack(jnp.asarray(f, jnp.bfloat16),
                                      jnp.asarray(v), 1 / 30, False)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), rtol=2 ** -7, atol=1e-6)


def _smooth_vel(shape, scale, rng):
    """A smooth velocity field, as a fluid's is."""
    ii, jj = np.meshgrid(*(np.arange(n, dtype=F) for n in shape),
                         indexing="ij")
    ph = rng.random(4) * 2 * np.pi
    return np.stack([scale * np.sin(2 * np.pi * ii / 40 + ph[0])
                     * np.cos(2 * np.pi * jj / 50 + ph[1]),
                     scale * np.cos(2 * np.pi * ii / 30 + ph[2])
                     * np.sin(2 * np.pi * jj / 45 + ph[3])]).astype(F)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_advect_minmax_plain_matches_pallas(rng, interpret_pallas, dtype):
    """K2's ``return_minmax`` (the sloop kernel's corner extrema) against
    the Pallas kernel; a 2D field is returned 2D."""
    shape = (40, 128)
    v = (40 * rng.standard_normal((2,) + shape)).astype(F)
    f = rng.random(shape, dtype=F).astype(jnp.dtype(dtype))
    want = advect_pallas(jnp.asarray(f), jnp.asarray(v), 1 / 30, False,
                         max_disp=8, return_minmax=True)
    got = advect_kernel(_t(f), _t(v), 1 / 30, False, max_disp=8,
                        return_minmax=True)
    assert [tuple(g.shape) for g in got] == [shape] * 3
    assert all(g.dtype == got[0].dtype for g in got)
    tol = dict(rtol=2 ** -7, atol=2e-5) if dtype == "bfloat16" else dict(
        rtol=1e-5, atol=2e-5)
    np.testing.assert_allclose(_np(got[0]), _np(want[0]), **tol)
    # the extrema are taps of the field, so they agree wherever the
    # backtrace picked the same base cell (all but a cell or two)
    for g, w in zip(got[1:], want[1:]):
        assert (_np(g) == _np(w)).mean() > 0.999


@pytest.mark.parametrize("case", ["velocity_f32_noslip", "dye_bf16"])
def test_maccormack_plain_matches_pallas(rng, interpret_pallas, case):
    """The plain K5 against ``advect_maccormack_pallas`` in interpret
    mode: the velocity (``field = vel``, no-slip) in units of its scale 60,
    the bf16 dye (no-slip off) to one bf16 ulp."""
    shape = (40, 128)
    v = _smooth_vel(shape, 60.0, rng)
    if case == "velocity_f32_noslip":
        field, no_slip, scale = v, True, 60.0
        tol = dict(rtol=1e-5, atol=2e-5)
    else:
        field = rng.random((3,) + shape, dtype=F).astype(jnp.bfloat16)
        no_slip, scale = False, 1.0
        tol = dict(rtol=2 ** -7, atol=2e-5)
    want = advect_maccormack_pallas(jnp.asarray(field), jnp.asarray(v),
                                    1 / 30, no_slip, max_disp=8)
    got = advect_maccormack_kernel(_t(field), _t(v), 1 / 30, no_slip,
                                   max_disp=8)
    assert got.dtype == _t(field).dtype and tuple(got.shape) == field.shape
    np.testing.assert_allclose(_np(got) / scale, _np(want) / scale, **tol)
    # the wrapper runs exactly its plain version on CPU tensors
    ref = advect_maccormack_reference(_t(field), _t(v), 1 / 30, no_slip,
                                      max_disp=8)
    np.testing.assert_array_equal(tensor_to_numpy(got), tensor_to_numpy(ref))


def test_maccormack_kernel_clamps_like_k2(rng):
    """Beyond ``max_disp`` the plain K5 backtraces through the CFL clamp
    (K2's semantics) and stays inside the stencil bounds of its input."""
    shape = (24, 40)
    v = (400 * rng.standard_normal((2,) + shape)).astype(F)
    f = rng.random((3,) + shape, dtype=F)
    got = advect_maccormack_kernel(_t(f), _t(v), 1 / 30, False, max_disp=4)
    assert torch.isfinite(got).all()
    assert float(got.min()) >= float(f.min())
    assert float(got.max()) <= float(f.max())
    # member= (K6) runs its plain version; block mode raises ValueError as
    # in JAX (advect.py:971-976): the sharded MacCormack composes K2
    got = advect_maccormack_kernel(_t(f), _t(v), 1 / 30, False, max_disp=4,
                                   member=(12, 20))
    assert torch.equal(got, advect_maccormack_reference(
        _t(f), _t(v), 1 / 30, False, max_disp=4, member=(12, 20)))
    with pytest.raises(ValueError, match="single-device only"):
        advect_maccormack_kernel(_t(f), _t(v), 1 / 30, False, halo=13)

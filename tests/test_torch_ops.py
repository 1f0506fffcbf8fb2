"""The port's eager ops against the JAX package's ops on the same
numpy-seeded inputs (CPU, small grids).

Tolerances are those of the matching JAX tests: advect 2e-6
(test_ops_advect.py), finite differences 1e-6 (test_ops_fd.py), the SOR
solve rtol 2e-4 / atol 2e-5 (test_ops_poisson.py); the render ops must be
bit-equal.  XLA on the CPU flushes subnormal floats to zero where PyTorch
keeps them, which the absolute tolerances absorb.
"""

import importlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch


def _mods(pkg):
    # the packages' __init__ re-export functions under the module names
    # (ops.advect is also a function), so fetch the modules themselves
    return [importlib.import_module(f"{pkg}.{m}") for m in (
        "ops.advect", "ops.blur", "ops.fd", "ops.poisson", "render.upscale")]


j_advect, j_blur, j_fd, j_poisson, j_upscale = _mods(
    "esp32_fluid_simulation_tpu")
t_advect, t_blur, t_fd, t_poisson, t_upscale = _mods(
    "esp32_fluid_simulation_tpu_torch")

torch.set_num_threads(1)

F = np.float32
SHAPE = (13, 17)


def _t(x):
    return torch.from_numpy(np.array(x))


def _j(x):
    return np.asarray(x)


@pytest.mark.parametrize("axis", [1, 2])
def test_blur_matches_jax(rng, axis):
    c = rng.random((3,) + SHAPE, dtype=F)
    got = t_blur.triangular_blur_inplace(_t(c), axis).numpy()
    want = _j(j_blur.triangular_blur_inplace(jnp.asarray(c), axis))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("no_slip", [False, True])
@pytest.mark.parametrize("scale", [1.0, 8.0, 40.0])
def test_advect_matches_jax(rng, no_slip, scale):
    """Random fields and velocities incl. far-out-of-bounds backtraces."""
    f = rng.random(SHAPE, dtype=F)
    v = (scale * rng.standard_normal((2,) + SHAPE)).astype(F)
    got = t_advect.advect(_t(f), _t(v), 1 / 30, no_slip).numpy()
    want = _j(j_advect.advect(jnp.asarray(f), jnp.asarray(v), 1 / 30,
                              no_slip))
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-6)


def test_sample_linear_3d_and_channels_match_jax(rng):
    """Rank-polymorphic gather: 3D grid, leading channel axis, no-slip."""
    shape = (6, 7, 8)
    f = rng.random((2,) + shape, dtype=F)
    coords = [(rng.random(shape) * (n + 4) - 2).astype(F) for n in shape]
    got = t_advect.sample_linear(_t(f), [_t(c) for c in coords],
                                 no_slip=True).numpy()
    want = _j(j_advect.sample_linear(jnp.asarray(f),
                                     [jnp.asarray(c) for c in coords],
                                     no_slip=True))
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-6)


def test_noslip_axis_factor_matches_jax():
    raw = np.linspace(-1.5, 14.5, 97).astype(F)
    got = t_advect.noslip_axis_factor(_t(raw), 13).numpy()
    want = _j(j_advect.noslip_axis_factor(jnp.asarray(raw), 13))
    np.testing.assert_array_equal(got, want)


def test_divergence_matches_jax(rng):
    v = (3 * rng.standard_normal((2,) + SHAPE)).astype(F)
    for dx in (1.0, 0.7):
        got = t_fd.divergence(_t(v), dx).numpy()
        want = _j(j_fd.divergence(jnp.asarray(v), dx))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_subtract_gradient_matches_jax(rng):
    v = (3 * rng.standard_normal((2,) + SHAPE)).astype(F)
    p = rng.standard_normal(SHAPE).astype(F)
    got = t_fd.subtract_gradient(_t(v), _t(p), 1.0).numpy()
    want = _j(j_fd.subtract_gradient(jnp.asarray(v), jnp.asarray(p), 1.0))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


SHAPE3 = (6, 9, 11)


@pytest.mark.parametrize("no_slip", [False, True])
def test_advect_3d_matches_jax(rng, no_slip):
    """The composed 3D path of the smoke plume: velocity self-advect and a
    bf16 scalar (lerped in bf16 by both packages)."""
    v = (20 * rng.standard_normal((3,) + SHAPE3)).astype(F)
    got = t_advect.advect(_t(v), _t(v), 1 / 30, no_slip).numpy()
    want = _j(j_advect.advect(jnp.asarray(v), jnp.asarray(v), 1 / 30,
                              no_slip))
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-6)
    rho = rng.random(SHAPE3, dtype=F)
    got = t_advect.advect(_t(rho).to(torch.bfloat16), _t(v), 1 / 30,
                          no_slip).float().numpy()
    want = _j(j_advect.advect(jnp.asarray(rho, jnp.bfloat16), jnp.asarray(v),
                              1 / 30, no_slip).astype(jnp.float32))
    np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=1e-6)


def test_divergence_and_gradient_3d_match_jax(rng):
    v = (3 * rng.standard_normal((3,) + SHAPE3)).astype(F)
    p = rng.standard_normal(SHAPE3).astype(F)
    for dx in (1.0, 0.7):
        np.testing.assert_allclose(
            t_fd.divergence(_t(v), dx).numpy(),
            _j(j_fd.divergence(jnp.asarray(v), dx)), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(
            t_fd.subtract_gradient(_t(v), _t(p), dx).numpy(),
            _j(j_fd.subtract_gradient(jnp.asarray(v), jnp.asarray(p), dx)),
            rtol=1e-6, atol=1e-6)


def test_sor_solve_3d_matches_jax(rng):
    d = rng.standard_normal(SHAPE3).astype(F)
    got = t_poisson.sor_solve(_t(d), 1.0, iters=10, omega=1.5).numpy()
    want = _j(j_poisson.sor_solve(jnp.asarray(d), 1.0, iters=10, omega=1.5))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("shape", [(9, 12), (4, 5, 6)])
def test_neighbor_count_and_diag_match_jax(shape):
    np.testing.assert_array_equal(
        t_poisson.neighbor_count(shape, torch.int32, device="cpu").numpy(),
        _j(j_poisson.neighbor_count(shape, jnp.int32)))
    np.testing.assert_array_equal(
        t_poisson._neg_inv_diag(shape, device="cpu").numpy(),
        _j(j_poisson._neg_inv_diag(shape)))


def test_sor_sweep_and_solve_match_jax(rng):
    d = rng.standard_normal((9, 12)).astype(F)
    p0 = rng.standard_normal((9, 12)).astype(F)
    np.testing.assert_allclose(
        t_poisson.sor_sweep(_t(p0), _t(d), 1.96).numpy(),
        _j(j_poisson.sor_sweep(jnp.asarray(p0), jnp.asarray(d), 1.96)),
        rtol=2e-5, atol=2e-6)
    got = t_poisson.sor_solve(_t(d), 1.0, iters=10, omega=1.96).numpy()
    want = _j(j_poisson.sor_solve(jnp.asarray(d), 1.0, iters=10, omega=1.96))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(
        t_poisson.poisson_residual(_t(want), _t(d)).numpy(),
        _j(j_poisson.poisson_residual(jnp.asarray(want), jnp.asarray(d))),
        rtol=2e-4, atol=2e-5)


def test_poisson_solve_unported_solver_raises():
    """Every solver name of the config is ported and the K4 kernel's tiled
    ``member=`` and block modes run (block mode needs ``global_offset=``),
    and a name outside the config's list is refused as JAX refuses it."""
    from esp32_fluid_simulation_tpu_torch.ops.cuda.sor import (
        sor_solve_kernel)
    d = torch.zeros((9, 12))
    assert torch.equal(sor_solve_kernel(d, member=(3, 4)), d)
    dm = torch.arange(108, dtype=torch.float32).reshape(9, 12) / 50
    assert torch.equal(
        sor_solve_kernel(torch.nn.functional.pad(dm, (2, 2, 2, 2)), iters=1,
                         global_offset=(0, 0), global_shape=(9, 12), halo=2),
        sor_solve_kernel(dm, iters=1))
    with pytest.raises(ValueError, match="need global_offset"):
        sor_solve_kernel(d, global_shape=(9, 12))

    class Cfg:
        solver, dx, sor_iters, omega = "fused_pallas", 1.0, 10, 1.96

    with pytest.raises(ValueError, match="unknown solver"):
        t_poisson.poisson_solve(d, Cfg())
    with pytest.raises(ValueError, match="unknown solver"):
        j_poisson.poisson_solve(jnp.asarray(d.numpy()), Cfg())


@pytest.mark.parametrize("shape,s", [((61, 81), 4), ((17, 129), 2),
                                     ((9, 14), 3), ((9, 14), 1)])
def test_upscale_and_pack_bit_equal_to_jax(rng, shape, s):
    c = rng.random((3,) + shape, dtype=F)
    c[:, ::7, ::5] = 1.0
    c[:, 1::4, ::3] = 0.0
    up_t = t_upscale.upscale_bilinear(_t(c), s)
    up_j = j_upscale.upscale_bilinear(jnp.asarray(c), s)
    np.testing.assert_array_equal(up_t.numpy(), _j(up_j))
    for bswap in (True, False):
        np.testing.assert_array_equal(
            t_upscale.pack_rgb565(up_t, bswap=bswap).numpy(),
            _j(j_upscale.pack_rgb565(up_j, bswap=bswap)))
    np.testing.assert_array_equal(t_upscale.render_rgb8(_t(c), s).numpy(),
                                  _j(j_upscale.render_rgb8(jnp.asarray(c), s)))


def test_pack_rgb565_out_of_range_bit_equal_to_jax(rng):
    """Negative and >1 values clip the same way in both packages."""
    c = (3.0 * rng.random((3, 9, 14), dtype=F) - 1.0)
    np.testing.assert_array_equal(
        t_upscale.pack_rgb565(_t(c)).numpy(),
        _j(j_upscale.pack_rgb565(jnp.asarray(c))))

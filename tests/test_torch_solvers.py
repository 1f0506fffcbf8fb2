"""The port's Poisson solvers against the JAX package (CPU).

* ``jacobi_solve``, ``sor_solve_adaptive`` (the returned triple, the early
  exit, the ``max_iters`` cap and the ``check_every < 1`` clamp) and every
  branch of ``poisson_solve`` against the JAX functions on the same
  numpy-seeded inputs, at test_ops_poisson.py's SOR tolerance (rtol 2e-4
  / atol 2e-5);
* the plain K4 (``sor_solve_kernel`` on CPU tensors) against the JAX
  ``sor_solve`` at test_pallas.py:83-90's tolerance (rtol 1e-4 / atol
  2e-5), and against ``sor_solve_pallas`` in interpret mode at one small
  shape;
* the K4 wrapper's modes (block mode, K11, gives the crop; ``member=``,
  K6, runs).
"""

import functools
import importlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from jax.experimental import pallas as pl

import esp32_fluid_simulation_tpu as J
import esp32_fluid_simulation_tpu_torch as T
from esp32_fluid_simulation_tpu.ops.pallas.sor import sor_solve_pallas
from esp32_fluid_simulation_tpu_torch.ops.cuda.sor import (
    sor_solve_kernel, sor_solve_reference)

j_poisson = importlib.import_module("esp32_fluid_simulation_tpu.ops.poisson")
t_poisson = importlib.import_module(
    "esp32_fluid_simulation_tpu_torch.ops.poisson")

torch.set_num_threads(1)

F = np.float32
TOL = dict(rtol=2e-4, atol=2e-5)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("shape", [(9, 12), (4, 5, 6)])
@pytest.mark.parametrize("omega", [1.0, 0.8])
def test_jacobi_solve_matches_jax(rng, shape, omega):
    d = rng.standard_normal(shape).astype(F)
    for dx in (1.0, 0.7):
        got = t_poisson.jacobi_solve(_t(d), dx, 20, omega).numpy()
        want = np.asarray(j_poisson.jacobi_solve(jnp.asarray(d), dx, 20,
                                                 omega))
        np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("kw", [dict(max_iters=400, omega=1.7, tol=1e-3,
                                     check_every=3),
                                dict(max_iters=10, omega=1.96, tol=0.0,
                                     check_every=4),
                                dict(max_iters=7, omega=1.5, tol=1e-3,
                                     check_every=0)],
                         ids=["early_exit", "cap", "check_every_clamp"])
def test_sor_solve_adaptive_matches_jax(rng, kw):
    """The triple ``(p, iters_done, residual_l2)``: the same sweep count
    (a chunk may overshoot the tolerance, never ``max_iters``), and
    ``check_every=0`` runs as 1, as the JAX solve clamps it."""
    d = rng.standard_normal((24, 31)).astype(F)
    d -= d.mean()
    p, it, res = t_poisson.sor_solve_adaptive(_t(d), **kw)
    jp, jit, jres = j_poisson.sor_solve_adaptive(jnp.asarray(d), **kw)
    assert isinstance(it, int) and it == int(jit)
    assert it <= kw["max_iters"]
    assert res.dim() == 0 and res.dtype == torch.float32
    np.testing.assert_allclose(p.numpy(), np.asarray(jp), **TOL)
    np.testing.assert_allclose(float(res), float(jres), rtol=1e-3)
    if kw["tol"] > 0:
        assert float(res) <= kw["tol"] or it == kw["max_iters"]


def test_sor_solve_adaptive_quiet_fluid_runs_no_sweep():
    d = torch.zeros((9, 12))
    p, it, res = t_poisson.sor_solve_adaptive(d, max_iters=50)
    assert it == 0 and float(res) == 0.0 and not p.any()


@pytest.mark.parametrize("solver", ["sor", "sor_adaptive", "jacobi",
                                    "sor_pallas", "multigrid"])
def test_poisson_solve_dispatch_matches_jax(rng, solver, monkeypatch):
    """Every 2D solver through ``poisson_solve`` (``sor_pallas``: the
    plain K4 here; its JAX side is the interpret-mode kernel)."""
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    shape = (24, 40)
    kw = dict(shape=shape, solver=solver, sor_iters=6, omega=1.7,
              sor_tol=1e-2, mg_cycles=2)
    d = rng.standard_normal(shape).astype(F)
    got = t_poisson.poisson_solve(_t(d), T.SimConfig(**kw)).numpy()
    want = np.asarray(j_poisson.poisson_solve(jnp.asarray(d),
                                              J.SimConfig(**kw)))
    np.testing.assert_allclose(got, want, **TOL)


def test_poisson_solve_multigrid_levels_match_jax(rng):
    """The 2D multigrid dispatch passes ``mg_levels``; a capped hierarchy
    gives another answer than the full one."""
    shape = (33, 47)
    d = rng.standard_normal(shape).astype(F)
    outs = []
    for levels in (0, 2):
        kw = dict(shape=shape, solver="multigrid", omega=1.3, mg_cycles=1,
                  mg_levels=levels)
        got = t_poisson.poisson_solve(_t(d), T.SimConfig(**kw)).numpy()
        want = np.asarray(j_poisson.poisson_solve(jnp.asarray(d),
                                                  J.SimConfig(**kw)))
        np.testing.assert_allclose(got, want, **TOL)
        outs.append(got)
    assert np.abs(outs[0] - outs[1]).max() > 1e-3


@pytest.mark.parametrize("shape", [(61, 81), (130, 200)])
def test_sor_kernel_plain_matches_jax_sor_solve(rng, shape):
    d = rng.standard_normal(shape).astype(F)
    got = sor_solve_kernel(_t(d), 1.0, 10, 1.96).numpy()
    want = np.asarray(j_poisson.sor_solve(jnp.asarray(d), 1.0, 10, 1.96))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-5)


def test_sor_kernel_plain_matches_pallas(rng, monkeypatch):
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    d = rng.standard_normal((24, 40)).astype(F)
    for dx in (1.0, 0.5):
        got = sor_solve_kernel(_t(d), dx, 3, 1.96).numpy()
        want = np.asarray(sor_solve_pallas(jnp.asarray(d), dx, 3, 1.96))
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-5)


def test_sor_kernel_refuses_unported_modes(rng):
    """Block mode (K11) runs and gives the crop of the whole-grid solve
    (test_torch_block_kernels_ref.py holds it to JAX), and refuses a halo
    below 2*iters as JAX does; ``member=`` (K6) runs the member-masked
    plain solve (test_torch_tiled_kernels_ref.py holds it to JAX)."""
    d = torch.zeros((8, 8))
    dm = torch.from_numpy(rng.standard_normal((8, 12)).astype(F))
    got = sor_solve_kernel(dm, 1.0, 3, 1.96, member=(4, 6))
    assert torch.equal(got, sor_solve_reference(dm, 1.0, 3, 1.96,
                                                member=(4, 6)))
    assert not torch.equal(got, sor_solve_kernel(dm, 1.0, 3, 1.96))
    block = torch.nn.functional.pad(dm, (6, 6, 6, 6))[:, 6:]   # cols 6..11
    got = sor_solve_kernel(block.contiguous(), 1.0, 3, 1.96,
                           global_offset=(0, 6), global_shape=(8, 12),
                           halo=6)
    assert torch.equal(got, sor_solve_kernel(dm, 1.0, 3, 1.96)[:, 6:])
    with pytest.raises(ValueError, match=r"halo >= 2\*iters"):
        sor_solve_kernel(block.contiguous(), 1.0, 4, 1.96,
                         global_offset=(0, 6), global_shape=(8, 12), halo=6)
    with pytest.raises(TypeError):
        sor_solve_kernel(d, tile_h=8)
    # the JAX defaults mean "not asked for"
    assert torch.equal(sor_solve_kernel(d, halo=0, member=None), d)


def test_sor_pallas_step_follows_jax(rng, monkeypatch):
    """``solver="sor_pallas"`` through the model step (the plain K4 on the
    CPU, the interpret-mode kernel in JAX) for 2 steps."""
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    kw = dict(shape=(24, 40), solver="sor_pallas", sor_iters=4)
    jcfg, tcfg = J.SimConfig(**kw), T.SimConfig(**kw)
    jst, tst = J.init_state(jcfg), T.init_state(tcfg, device="cpu")
    jstep = J.make_step(jcfg, donate=False)
    for t in range(2):
        pos, val = [(5 + t, 7), (12, 30)], [(90.0, -40.0), (-30.0, 70.0)]
        jst = jstep(jst, J.Impulses.from_lists(jcfg, pos, val))
        tst = T.step(tst, T.Impulses.from_lists(tcfg, pos, val,
                                                device="cpu"), tcfg)
    np.testing.assert_allclose(tst.velocity.numpy(), np.asarray(jst.velocity),
                               rtol=1e-4, atol=2e-4)
    np.testing.assert_allclose(tst.color.numpy(), np.asarray(jst.color),
                               rtol=1e-4, atol=2e-4)

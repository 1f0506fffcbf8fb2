"""The port's sharded 3D smoke step (``parallel/sharded_smoke.py``) on a 2x4
mesh of CPU devices: against the port's single-device smoke step at the
shapes and tolerances of tests/test_sharded_smoke.py, and against the JAX
package's ``make_sharded_smoke_step`` under ``shard_map`` on the
8-device CPU mesh (a few seconds, so it stays in the fast lane).

Tolerances, each with its reason (test_sharded_smoke.py):

* float32 scalars: velocity rtol 1e-4 / atol 1e-4, density rtol 1e-4 /
  atol 1e-5 (:40-45): the eager advection rebases its coordinates into the
  shard window (``si - ox + k``), which may round;
* the bf16 default: velocity rtol 1e-3 / atol 2e-3, density rtol 0.02 /
  atol 4e-3 (:124-129), the bf16 rounding of the scalars that drive the
  buoyancy;
* the kernel routes (K7 block, the K9 block chain, through their plain
  versions here): bit-equal to the port's single-device kernel step, and
  within the float32 tolerances of the eager single-device step.
"""

import dataclasses
import functools

import numpy as np
import jax
import pytest
import torch
from jax.experimental import pallas as pl

from esp32_fluid_simulation_tpu.models.smoke3d import (
    SmokeConfig as JSmokeConfig)
from esp32_fluid_simulation_tpu.ops.pallas import advect3d as jadvect3d
from esp32_fluid_simulation_tpu.parallel import make_mesh as jmake_mesh
from esp32_fluid_simulation_tpu.parallel.sharded_smoke import (
    make_sharded_smoke_step as jmake_sharded_smoke_step,
    sharded_smoke_sharding as jsharding)
from esp32_fluid_simulation_tpu.models.smoke3d import (
    SmokeState as JSmokeState)
from esp32_fluid_simulation_tpu_torch import (SmokeConfig, init_smoke,
                                              make_smoke_step)
from esp32_fluid_simulation_tpu_torch.interop import (smoke_state_from_numpy,
                                                      smoke_state_to_numpy)
from esp32_fluid_simulation_tpu_torch.ops.cuda.advect3d import (
    advect3d_kernel)
from esp32_fluid_simulation_tpu_torch.ops.cuda.sor3d import sor3d_chunk
from esp32_fluid_simulation_tpu_torch.parallel import (
    make_mesh, make_sharded_smoke_step, shard_smoke_state,
    unshard_smoke_state)

torch.set_num_threads(1)

F32 = dict(scalar_dtype="float32")
SOR16 = dict(shape=(16, 16, 32), solver="sor", omega=1.5)
F32_TOL = dict(velocity=dict(rtol=1e-4, atol=1e-4),
               density=dict(rtol=1e-4, atol=1e-5))
BF16_TOL = dict(velocity=dict(rtol=1e-3, atol=2e-3),
                density=dict(rtol=0.02, atol=4e-3))


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(["cpu"] * 8, grid_shape=(2, 4))


def _single(cfg, steps):
    fn = make_smoke_step(cfg)
    st = init_smoke(cfg, device="cpu")
    for _ in range(steps):
        st = fn(st)
    return st


def _sharded(cfg, mesh, steps, **kw):
    fn = make_sharded_smoke_step(cfg, mesh, **kw)
    st = shard_smoke_state(init_smoke(cfg, device="cpu"), cfg, mesh)
    for _ in range(steps):
        st = fn(st)
    return unshard_smoke_state(st, "cpu")


def _close(got, want, tol):
    for name, t in tol.items():
        np.testing.assert_allclose(getattr(got, name).float().numpy(),
                                   getattr(want, name).float().numpy(), **t)


def test_sharded_smoke_kernel_route_follows_jax_sharded_step(mesh,
                                                            monkeypatch):
    """The kernel advection route (the port's K7 block: the velocity
    self-advect and the stacked density + temperature, two launches per
    shard; JAX's three, its Pallas kernel in interpret mode) through both
    packages' sharded steps, 3 steps of float32 scalars at ``max_disp=4``,
    at the float32 tolerances (interpret mode contracts the backtrace into
    an FMA, test_torch_kernels3d_block_ref.py)."""
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    # small tiles keep the interpret-mode trace short (a few seconds)
    monkeypatch.setattr(jadvect3d, "advect3d_pallas", functools.partial(
        jadvect3d.advect3d_pallas, tile_d=1, tile_h=8))
    kw = dict(SOR16, sor_iters=6, advect_impl="pallas", advect_max_disp=4,
              **F32)
    cfg, jcfg = SmokeConfig(**kw), JSmokeConfig(**kw)
    st = _single(dataclasses.replace(cfg, advect_impl="jnp"), 4)
    jmesh = jmake_mesh(jax.devices()[:8], grid_shape=(2, 4))
    jst = jax.device_put(JSmokeState(*smoke_state_to_numpy(st)),
                         jsharding(jcfg, jmesh))
    jfn = jmake_sharded_smoke_step(jcfg, jmesh, max_disp=4, donate=False)
    fn = make_sharded_smoke_step(cfg, mesh)
    sh = shard_smoke_state(st, cfg, mesh)
    for _ in range(3):
        jst, sh = jfn(jst), fn(sh)
    want = smoke_state_from_numpy(*(np.asarray(x) for x in jst),
                                  device="cpu")
    _close(unshard_smoke_state(sh, "cpu"), want, F32_TOL)


@pytest.mark.parametrize("kw,steps,tol", [
    (dict(SOR16, sor_iters=6, **F32), 8, F32_TOL),
    (dict(SOR16, sor_iters=6), 8, BF16_TOL),
    (dict(SOR16, sor_iters=4, vorticity_eps=4.0, **F32), 6, F32_TOL),
    (dict(shape=(32, 32, 64), solver="multigrid", mg_cycles=2, **F32), 5,
     F32_TOL),
], ids=["f32", "bf16_default", "vorticity", "multigrid"])
def test_sharded_smoke_matches_single_device(mesh, kw, steps, tol):
    """The eager routes (``max_disp=4``, as JAX's tests) against the
    single-device step; the plume exists."""
    cfg = SmokeConfig(**kw)
    want = _single(cfg, steps)
    got = _sharded(cfg, mesh, steps, max_disp=4)
    _close(got, want, tol)
    assert got.step == want.step == steps
    assert float(got.density.float().max()) > 0.01


@pytest.mark.parametrize("scalar_dtype", ["float32", "bfloat16"])
def test_sharded_smoke_kernel_routes_match_single_device(
        mesh, monkeypatch, scalar_dtype):
    """``advect_impl="pallas"`` (K7 block, two launches per shard per
    step: the velocity self-advect and the stacked density + temperature)
    and ``sor_impl="pallas"`` with ``sor_chunk=2`` (the K9 block
    chain, ceil(5/2) chunks per shard per step): bit-equal to the
    single-device kernel step; with float32 scalars within the float32
    tolerances of the eager single-device step."""
    calls = {"advect": 0, "chunk": 0}

    def counted(name, fn):
        def wrapper(*a, **kw):
            calls[name] += kw.get("global_offset") is not None
            return fn(*a, **kw)
        return wrapper
    monkeypatch.setattr("esp32_fluid_simulation_tpu_torch.parallel.sharded3d."
                        "advect3d_kernel", counted("advect", advect3d_kernel))
    monkeypatch.setattr("esp32_fluid_simulation_tpu_torch.parallel.sharded3d."
                        "sor3d_chunk", counted("chunk", sor3d_chunk))
    kw = dict(SOR16, sor_iters=5, advect_max_disp=4,
              scalar_dtype=scalar_dtype)
    kcfg = SmokeConfig(advect_impl="pallas", sor_impl="pallas", sor_chunk=2,
                       **kw)
    got = _sharded(kcfg, mesh, 4)
    assert calls == {"advect": 2 * 8 * 4, "chunk": 8 * 3 * 4}
    want = _single(kcfg, 4)
    for name in ("velocity", "density", "temperature"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    if scalar_dtype == "float32":
        _close(got, _single(SmokeConfig(advect_impl="jnp", **kw), 4),
               F32_TOL)


def test_sharded_smoke_max_disp_and_solver_checks(mesh):
    """``max_disp=None`` is ``cfg.advect_max_disp``; kernel advection
    refuses another clamp; an unknown solver raises."""
    cfg = SmokeConfig(**dict(SOR16, sor_iters=3, advect_max_disp=3, **F32))
    got = _sharded(cfg, mesh, 2)
    want = _sharded(cfg, mesh, 2, max_disp=3)
    assert torch.equal(got.velocity, want.velocity)
    with pytest.raises(ValueError, match="advect_max_disp"):
        make_sharded_smoke_step(dataclasses.replace(cfg, advect_impl="pallas"),
                                mesh, max_disp=4)
    with pytest.raises(ValueError, match="solver"):
        make_sharded_smoke_step(dataclasses.replace(cfg, solver="jacobi"),
                                mesh)


def test_sharded_smoke_follows_jax_sharded_step(mesh):
    """The same kicked state through JAX's ``make_sharded_smoke_step``
    under ``shard_map`` and the port's, 3 steps of the float32 eager
    route at ``max_disp=4``, at the float32 tolerances."""
    kw = dict(SOR16, sor_iters=6, **F32)
    cfg, jcfg = SmokeConfig(**kw), JSmokeConfig(**kw)
    st = _single(cfg, 4)
    jmesh = jmake_mesh(jax.devices()[:8], grid_shape=(2, 4))
    jst = jax.device_put(JSmokeState(*smoke_state_to_numpy(st)),
                         jsharding(jcfg, jmesh))
    jfn = jmake_sharded_smoke_step(jcfg, jmesh, max_disp=4, donate=False)
    fn = make_sharded_smoke_step(cfg, mesh, max_disp=4)
    sh = shard_smoke_state(st, cfg, mesh)
    for _ in range(3):
        jst, sh = jfn(jst), fn(sh)
    want = smoke_state_from_numpy(*(np.asarray(x) for x in jst),
                                  device="cpu")
    _close(unshard_smoke_state(sh, "cpu"), want, F32_TOL)

"""The port's sharded 3D dye-bed step (``parallel/sharded3d.py``, reached
through ``make_sharded_step`` for a 3D ``SimConfig``) on a 2x4 mesh of CPU
devices: against the port's single-device 3D step over the route matrix of
tests/test_sharded3d.py, and against the JAX package's sharded 3D step
under ``shard_map`` on the 8-device CPU mesh.

Shapes and tolerances are test_sharded3d.py's: ``(12, 32, 48)`` (multigrid
``(16, 32, 64)``), ``max_disp=6`` (a halo of 7 <= the 12-column blocks);
rtol 1e-4 / atol 1e-4 (:44-61: the eager advection rebases its
coordinates into the shard window, which may round and move a stencil by
a node), RK2 rtol 1e-3 / atol 5e-4 (:88-91), wider SOR halos against the
per-half-sweep exchange rtol 2e-6 / atol 2e-6 (:83-85), the metrics rtol
1e-4 / atol 1e-5 (:128-129), the kernel route (K7 block, the K9 block
chain; plain versions here) against the sharded eager route rtol 1e-4 /
atol 1e-4 (:154-159), and JAX's sharded step rtol 1e-4 / atol 1e-4.
"""

import dataclasses

import numpy as np
import jax
import pytest
import torch

import esp32_fluid_simulation_tpu as J
from esp32_fluid_simulation_tpu.parallel import (
    make_mesh as jmake_mesh, make_sharded_step as jmake_sharded_step,
    sharded_state_sharding as jsharding)
from esp32_fluid_simulation_tpu_torch import (SimConfig, Impulses,
                                              init_state, make_step,
                                              make_step_with_metrics)
from esp32_fluid_simulation_tpu_torch.parallel import (
    make_mesh, make_sharded_step, make_sharded_step_with_metrics,
    shard_state, unshard_state)

torch.set_num_threads(1)

MD = 6
POS = [(6, 16, 24), (3, 8, 40)]
VAL = [(40.0, 90.0, -45.0), (-30.0, -60.0, 120.0)]


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(["cpu"] * 8, grid_shape=(2, 4))


def _cfg(**kw):
    kw.setdefault("shape", (12, 32, 48))
    kw.setdefault("sor_iters", 4)
    kw.setdefault("omega", 1.7)
    return SimConfig(**kw)


def _imps(cfg, steps):
    return ([Impulses.from_lists(cfg, POS, VAL, device="cpu")]
            + [Impulses.none(cfg, device="cpu")] * (steps - 1))


def _run(fn, st, imps):
    for imp in imps:
        st = fn(st, imp)
    return st


def _sharded(cfg, mesh, imps, st=None, **kw):
    st = init_state(cfg, device="cpu") if st is None else st
    return unshard_state(_run(make_sharded_step(cfg, mesh, **kw),
                              shard_state(st, cfg, mesh), imps), "cpu")


def _close(got, want, **tol):
    for name in ("velocity", "color"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   getattr(want, name).numpy(), **tol)


@pytest.mark.parametrize("kw,tol", [
    (dict(), dict(rtol=1e-4, atol=1e-4)),
    (dict(advector="rk2"), dict(rtol=1e-3, atol=5e-4)),
    (dict(advector="maccormack"), dict(rtol=1e-4, atol=1e-4)),
    (dict(solver="jacobi", sor_iters=12, omega=0.9),
     dict(rtol=1e-4, atol=1e-4)),
    (dict(shape=(16, 32, 64), solver="multigrid", mg_cycles=2),
     dict(rtol=1e-4, atol=1e-4)),
    (dict(vorticity_eps=2.0), dict(rtol=1e-4, atol=1e-4)),
], ids=["semilag", "rk2", "maccormack", "jacobi", "multigrid", "vorticity"])
def test_sharded3d_matches_single_device(mesh, kw, tol):
    cfg = _cfg(**kw)
    imps = _imps(cfg, 3)
    want = _run(make_step(cfg), init_state(cfg, device="cpu"), imps)
    got = _sharded(cfg, mesh, imps, max_disp=MD)
    _close(got, want, **tol)
    assert got.step == want.step == 3


@pytest.mark.parametrize("sor_halo", [2, 5])
def test_sharded3d_sor_halo_depths_exact(mesh, sor_halo):
    """Trapezoidal SOR halos (one exchange per ``sor_halo`` half-sweeps)
    against the per-half-sweep exchange."""
    cfg = _cfg()
    st = _run(make_step(cfg), init_state(cfg, device="cpu"), _imps(cfg, 2))
    imp = _imps(cfg, 1)
    base = _sharded(cfg, mesh, imp, st, max_disp=MD, sor_halo=1)
    wide = _sharded(cfg, mesh, imp, st, max_disp=MD, sor_halo=sor_halo)
    np.testing.assert_allclose(wide.velocity.numpy(), base.velocity.numpy(),
                               rtol=2e-6, atol=2e-6)


def test_sharded3d_metrics_match_single_device(mesh):
    cfg = _cfg()
    imp = _imps(cfg, 1)[0]
    st = init_state(cfg, device="cpu")
    _, want = make_step_with_metrics(cfg)(st, imp)
    out, got = make_sharded_step_with_metrics(cfg, mesh, max_disp=MD)(
        shard_state(st, cfg, mesh), imp)
    assert bool(got["finite"]) and bool(want["finite"])
    assert set(got) == set(want)
    for key in ("div_pre_max", "div_post_max", "poisson_residual_l2",
                "max_speed"):
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   rtol=1e-4, atol=1e-5)
    # the metrics step's state is the plain sharded step's
    plain = _sharded(cfg, mesh, [imp], st, max_disp=MD)
    out = unshard_state(out, "cpu")
    assert torch.equal(out.velocity, plain.velocity)
    assert torch.equal(out.color, plain.color)


def test_sharded3d_kernel_route_matches_eager(mesh):
    """``advect_impl="pallas"`` (K7 block on the velocity and the dye) and
    ``solver="sor_pallas"`` (the K9 block chain, chunks of 3 sweeps) against
    the sharded eager SOR route, 2 steps (test_sharded3d.py:132-159); the
    3D ``sor_pallas`` has no single-device counterpart."""
    ref = _cfg(advect_impl="jnp", solver="sor", sor_iters=3)
    kcfg = _cfg(advect_impl="pallas", solver="sor_pallas", sor_iters=3,
                advect_max_disp=MD)
    imps = _imps(ref, 2)
    want = _sharded(ref, mesh, imps, max_disp=MD)
    got = _sharded(kcfg, mesh, imps)
    _close(got, want, rtol=1e-4, atol=1e-4)
    assert float(got.velocity.abs().max()) > 1.0


def test_sharded3d_refusals(mesh):
    """As in JAX: the 3D ``fused_pallas`` (no 3D fused projection kernel)
    and kernel advection with another advector than semilag; the port's
    own: a kernel clamp other than ``cfg.advect_max_disp``."""
    with pytest.raises(NotImplementedError, match="fused"):
        make_sharded_step(_cfg(solver="fused_pallas"), mesh)
    with pytest.raises(NotImplementedError, match="semilag"):
        make_sharded_step(_cfg(advect_impl="pallas", advector="rk2"), mesh)
    with pytest.raises(ValueError, match="advect_max_disp"):
        make_sharded_step(_cfg(advect_impl="pallas"), mesh, max_disp=MD)


def test_sharded3d_follows_jax_sharded_step(mesh):
    """The same kicked state and impulses through JAX's sharded 3D step
    (``shard_map`` on 2x4 CPU devices, the eager SOR route) and the
    port's."""
    cfg = _cfg()
    jcfg = J.SimConfig(**dataclasses.asdict(cfg))
    st = _run(make_step(cfg), init_state(cfg, device="cpu"), _imps(cfg, 2))
    jmesh = jmake_mesh(jax.devices()[:8], grid_shape=(2, 4))
    jst = jax.device_put(J.SimState(
        velocity=np.asarray(st.velocity.numpy()),
        color=np.asarray(st.color.numpy()), step=np.int32(st.step)),
        jsharding(jcfg, jmesh))
    jout = jmake_sharded_step(jcfg, jmesh, max_disp=MD, donate=False)(
        jst, J.Impulses.from_lists(jcfg, POS, VAL))
    got = _sharded(cfg, mesh, _imps(cfg, 1), st, max_disp=MD)
    np.testing.assert_allclose(got.velocity.numpy(),
                               np.asarray(jout.velocity), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(got.color.numpy(), np.asarray(jout.color),
                               rtol=1e-4, atol=1e-4)
    assert got.step == int(jout.step)

"""The port's sharded tiled-domain supergrid (``parallel/sharded_tiled.py``)
on a 2x4 mesh of CPU devices: the counterparts of tests/test_sharded_tiled.py
:38-118, against the port's single-device tiled step and against the JAX
package's sharded tiled step on the 8-device CPU mesh.

Each shard owns whole member tiles, so no halo is exchanged.  Tolerances:
the eager route rtol 1e-5 / atol 1e-5 against both (the port's is equal to
its single-device step bit for bit); the kernel route (K1 and K2 member
modes, their plain versions here; the JAX kernels in interpret mode) rtol
1e-3 / atol 1e-3, as test_sharded_tiled.py:70-71 holds JAX's: a shard
backtraces from shard-local coordinates, so ``i - v*dt`` rounds at another
magnitude than on the whole supergrid.  The ensemble: rtol 1e-5 / atol 1e-5
against both, as test_sharded_tiled.py:92-97.
"""

import functools

import numpy as np
import jax
import pytest
import torch
from jax.experimental import pallas as pl

import esp32_fluid_simulation_tpu as J
from esp32_fluid_simulation_tpu.io_host.touch import (
    scripted_swirl as jscripted_swirl)
from esp32_fluid_simulation_tpu.models import ensemble as jens
from esp32_fluid_simulation_tpu.parallel import (
    make_mesh as jmake_mesh, make_sharded_ensemble_step as jmake_ens,
    make_sharded_tiled_step as jmake_tiled,
    sharded_state_sharding as jsharding)
from esp32_fluid_simulation_tpu_torch import (SimConfig, Impulses,
                                              init_ensemble, init_state,
                                              make_ensemble_step,
                                              stack_impulses)
from esp32_fluid_simulation_tpu_torch.interop import tensor_to_numpy
from esp32_fluid_simulation_tpu_torch.io_host.touch import scripted_swirl
from esp32_fluid_simulation_tpu_torch.models.stable_fluids import step
from esp32_fluid_simulation_tpu_torch.parallel import (
    make_mesh, make_sharded_ensemble_step, make_sharded_tiled_step,
    shard_state, unshard_state)

torch.set_num_threads(1)

POS = [(5, 5), (5, 5), (40, 70), (100, 200), (33, 64)]
VAL = [(50.0, 80.0), (-90.0, 30.0), (60.0, -60.0), (10.0, 120.0),
       (75.0, 75.0)]


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(["cpu"] * 8, grid_shape=(2, 4))


def _jmesh():
    return jmake_mesh(jax.devices()[:8], grid_shape=(2, 4))


@pytest.mark.parametrize("solver", ["sor", "fused_pallas"])
def test_sharded_tiled_matches_single_device_and_jax(monkeypatch, mesh,
                                                     solver):
    """(2, 4) mesh -> shard blocks (64, 64) = 2x2 member tiles of (32, 32);
    impulses in several member tiles, a duplicate position (last wins) and
    one on a shard boundary column."""
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    kw = dict(shape=(128, 256), domain_tile=(32, 32), solver=solver,
              sor_iters=3,
              advect_impl="pallas" if solver == "fused_pallas" else "auto",
              advect_max_disp=8)
    cfg, jcfg = SimConfig(**kw), J.SimConfig(**kw)
    imp = Impulses.from_lists(cfg, POS, VAL, device="cpu")
    st = init_state(cfg, device="cpu")
    single = st
    for _ in range(2):
        single = step(single, imp, cfg)
    fn = make_sharded_tiled_step(cfg, mesh)
    out = shard_state(st, cfg, mesh)
    for _ in range(2):
        out = fn(out, imp)
    out = unshard_state(out, "cpu")
    assert out.step == single.step == 2

    jfn = jmake_tiled(jcfg, _jmesh(), donate=False)
    jout = jax.device_put(J.init_state(jcfg), jsharding(jcfg, _jmesh()))
    jimp = J.Impulses.from_lists(jcfg, POS, VAL)
    for _ in range(2):
        jout = jfn(jout, jimp)

    tol = (dict(rtol=1e-5, atol=1e-5) if solver == "sor"
           else dict(rtol=1e-3, atol=1e-3))
    if solver == "sor":
        assert torch.equal(out.velocity, single.velocity)
        assert torch.equal(out.color, single.color)
    for got, want in ((out.velocity, single.velocity),
                      (out.color, single.color),
                      (out.velocity, np.asarray(jout.velocity)),
                      (out.color, np.asarray(jout.color))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


def test_sharded_ensemble_matches_single_device_and_jax(mesh):
    n = 32   # 4x8 member grid: x-factor 2 divides 4, y-factor 4 divides 8
    member = SimConfig(shape=(32, 32), sor_iters=3)
    jmember = J.SimConfig(shape=(32, 32), sor_iters=3)
    state = init_ensemble(member, n, device="cpu")
    imps = stack_impulses([scripted_swirl(member, 7 * m, device="cpu")
                           for m in range(n)])
    single = make_ensemble_step(member, mode="tiled")(state, imps)
    fn, cfg_super = make_sharded_ensemble_step(member, mesh, n)
    assert cfg_super.shape == (128, 256) and cfg_super.domain_tile == (32, 32)
    out = fn(state, imps)
    assert tuple(out.velocity.shape) == (n, 2, 32, 32) and out.step == 1

    jfn, _ = jmake_ens(jmember, _jmesh(), n, donate=False)
    jout = jfn(jens.init_ensemble(jmember, n), jens.stack_impulses(
        [jscripted_swirl(jmember, 7 * m) for m in range(n)]))
    for got, want in ((out.velocity, single.velocity),
                      (out.color, single.color)):
        assert torch.equal(got, want)
    for got, want in ((out.velocity, jout.velocity),
                      (out.color, jout.color)):
        np.testing.assert_allclose(tensor_to_numpy(got), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


def test_sharded_tiled_rejects_misaligned_mesh(mesh):
    # 3x3 member grid of 32^2 tiles: the (2, 4) mesh can't own whole tiles
    cfg = SimConfig(shape=(96, 96), domain_tile=(32, 32))
    with pytest.raises(ValueError, match="whole member tiles"):
        make_sharded_tiled_step(cfg, mesh)
    with pytest.raises(ValueError, match="domain_tile"):
        make_sharded_tiled_step(SimConfig(shape=(64, 96)), mesh)
    with pytest.raises(ValueError, match="not divisible"):
        make_sharded_tiled_step(SimConfig(shape=(96, 102),
                                          domain_tile=(32, 34)), mesh)


def test_sharded_tiled_member_impulses_land_in_their_shards(mesh):
    """Member-local impulses of members on different shards: each shard
    writes only its own members' cells, as the single-device scatter."""
    member = SimConfig(shape=(32, 32), sor_iters=2)
    n = 32
    state = init_ensemble(member, n, device="cpu")
    none = Impulses.none(member, device="cpu")
    hits = {0: [(3, 4)], 7: [(31, 0)], 24: [(0, 31)], 31: [(16, 16)]}
    imps = stack_impulses([
        Impulses.from_lists(member, hits[m], [(40.0, -30.0)], device="cpu")
        if m in hits else none for m in range(n)])
    fn, _ = make_sharded_ensemble_step(member, mesh, n)
    out = fn(state, imps)
    single = make_ensemble_step(member, mode="tiled")(state, imps)
    assert torch.equal(out.velocity, single.velocity)
    moved = out.velocity.abs().amax(dim=(1, 2, 3)) > 0
    assert moved[list(hits)].all() and not moved[1]

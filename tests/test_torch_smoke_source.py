"""The plume's source and buoyancy as the epilogue of K7's scalar launch
(``advect3d_source_kernel``) on the CPU, where the wrapper runs its plain
version, ``advect3d_source_reference``.

* the plain version equals the advection of the stacked pair followed by
  ``inject_and_buoy``, bit for bit, on the velocity (written in place) and
  both scalars: at odd extents with a sphere off the grid's centre, with
  an arbitrary mask over the whole grid, and with densities above 1 before
  the clamp, NaN, +-inf and -0 in either scalar;
* a call the wrapper refuses (a shape that does not fit, a device it has
  no route for) raises and leaves ``source_launches`` where it was;
* ``smoke_step`` on K7's route (``advect_impl="pallas"``), stirred through
  the drag queue, equals the same route with the source applied by the
  eager ops after the launch, bit for bit, with the default mask and with
  one that is not zero outside the sphere;
* ``advect3d_kernel.source_launches`` reads 1 a step on that route, with
  confinement too, and 0 on the eager route, with float32 scalars, with a
  float32 mask and on the sharded step.
"""

import dataclasses

import pytest
import torch

import esp32_fluid_simulation_tpu_torch as T
from esp32_fluid_simulation_tpu_torch.models import smoke3d as ts
from esp32_fluid_simulation_tpu_torch.ops.cuda.advect3d import (
    advect3d_kernel, advect3d_reference, advect3d_source_kernel)
from esp32_fluid_simulation_tpu_torch.parallel import (
    make_mesh, make_sharded_smoke_step, shard_smoke_state)

torch.set_num_threads(1)

DT = 1 / 30
SHAPE = (9, 13, 22)
# a sphere off the grid's centre, cut by the grid's faces
SPHERE = dict(shape=SHAPE, source_center=(0.5, 0.4, 0.25),
              source_radius=0.45)
KERNELS = dict(shape=(12, 14, 10), advect_impl="pallas", sor_impl="pallas")
POS = [(6, 5, 7), (6, 8, 3), (3, 2, 2)]
VEL = [(0.0, 20.0, -15.0), (0.0, -10.0, 25.0), (5.0, 5.0, 5.0)]


def _bits(t):
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def _case(name):
    """(cfg, density, temperature, velocity, mask) of one case."""
    g = torch.Generator().manual_seed(17)
    cfg = T.SmokeConfig(**SPHERE)
    vel = 60 * torch.randn((3,) + SHAPE, generator=g)
    rho = 1.3 * torch.rand(SHAPE, generator=g)
    temp = 2 * torch.randn(SHAPE, generator=g)
    mask = ts.source_tensor(cfg, "cpu")
    if name == "mask":
        mask = (3 * torch.rand(SHAPE, generator=g) - 1).to(torch.bfloat16)
    if name == "specials":
        cfg = dataclasses.replace(cfg, source_density=9.0,
                                  source_temperature=-4.0)
        # -0 where whole samples read it, inside and outside the sphere
        rho[:, 6:, :] = -0.0
        temp[:, :5, 12:] = -0.0
        rho[2, 3, 4] = temp[5, 9, 9] = float("nan")
        rho[4, 1, 15] = temp[1, 10, 3] = float("inf")
        rho[7, 11, 8] = temp[3, 2, 20] = float("-inf")
    return cfg, rho.to(torch.bfloat16), temp.to(torch.bfloat16), vel, mask


@pytest.mark.parametrize("name", ["sphere", "mask", "specials"])
def test_reference_with_source_is_advection_then_inject_and_buoy(name):
    cfg, rho, temp, vel, mask = _case(name)
    got_vel = vel.clone()
    n = advect3d_kernel.source_launches
    got = advect3d_source_kernel(rho, temp, got_vel, DT, False,
                                 ts.plume_source(cfg, mask), max_disp=2)
    assert advect3d_kernel.source_launches == n + 1
    want_vel = vel.clone()
    scal = advect3d_reference(torch.stack([rho, temp]), want_vel, DT, False,
                              2)
    want_vel, want_rho, want_temp = ts.inject_and_buoy(
        want_vel, scal[0], scal[1], mask, cfg)
    assert got.shape == (2,) + SHAPE and got.dtype == torch.bfloat16
    assert torch.equal(_bits(got_vel), _bits(want_vel))
    assert torch.equal(_bits(got[0]), _bits(want_rho))
    assert torch.equal(_bits(got[1]), _bits(want_temp))
    if name == "specials":
        # the clamp bound, NaN passed it, -0 + 0 stored +0
        assert (want_rho == 1).any() and want_rho.isnan().any()
        assert (_bits(scal[0]) == _bits(torch.tensor(-0.0).bfloat16())).any()
        assert not (_bits(want_rho) == _bits(
            torch.tensor(-0.0).bfloat16())).any()


@pytest.mark.parametrize("bad", ["mask", "temperature", "velocity",
                                 "device"])
def test_refused_call_leaves_source_launches(bad):
    cfg, rho, temp, vel, mask = _case("sphere")
    if bad == "mask":
        mask = mask[:, :, 1:]
    elif bad == "temperature":
        temp = temp[1:]
    elif bad == "velocity":
        vel = vel[:2]
    else:
        rho, temp, vel, mask = (torch.empty(t.shape, dtype=t.dtype,
                                            device="meta")
                                for t in (rho, temp, vel, mask))
    n, k = advect3d_kernel.source_launches, advect3d_kernel.launches
    with pytest.raises(ValueError, match="advect3d_source_kernel"):
        advect3d_source_kernel(rho, temp, vel, DT, False,
                               ts.plume_source(cfg, mask), max_disp=2)
    assert (advect3d_kernel.source_launches, advect3d_kernel.launches) == (
        n, k)


def _stirred(cfg, steps=3, src=None):
    st = T.init_smoke(cfg, device="cpu")
    g = torch.Generator().manual_seed(9)
    st = st._replace(velocity=10 * torch.randn(st.velocity.shape,
                                               generator=g))
    for _ in range(steps):
        st = ts.smoke_step(st, cfg, src,
                           T.Impulses.from_lists(cfg, POS, VEL, device="cpu"))
    return st


@pytest.mark.parametrize("kw,mask", [
    (KERNELS, None),
    (dict(KERNELS, shape=(9, 13, 22), source_radius=0.3), None),
    (KERNELS, "anywhere"),
], ids=["kernels", "odd", "mask_anywhere"])
def test_kernel_route_equals_the_eager_source(monkeypatch, kw, mask):
    cfg = T.SmokeConfig(**kw)
    src = None
    if mask == "anywhere":
        # a source over the whole grid, not only inside the sphere
        g = torch.Generator().manual_seed(5)
        src = torch.rand(cfg.shape, generator=g).to(torch.bfloat16)
    n = advect3d_kernel.source_launches
    got = _stirred(cfg, src=src)
    assert advect3d_kernel.source_launches == n + 3
    monkeypatch.setattr(ts, "_source_in_k7", lambda *a: False)
    want = _stirred(cfg, src=src)
    assert advect3d_kernel.source_launches == n + 3
    for name in ("velocity", "density", "temperature"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert float(got.density.float().max()) > 0.0


@pytest.mark.parametrize("route,kw,per_step", [
    ("kernel", KERNELS, 1),
    ("eager", dict(KERNELS, advect_impl="jnp", sor_impl="jnp"), 0),
    ("vorticity", dict(KERNELS, vorticity_eps=2.0), 1),
    ("f32_scalars", dict(KERNELS, scalar_dtype="float32"), 0),
    ("f32_mask", KERNELS, 0),
    ("sharded", dict(KERNELS, shape=(8, 16, 16)), 0),
])
def test_source_launches_count_the_route(route, kw, per_step):
    cfg = T.SmokeConfig(**kw)
    n = advect3d_kernel.source_launches
    if route == "sharded":
        mesh = make_mesh(["cpu"] * 4, grid_shape=(2, 2))
        fn = make_sharded_smoke_step(cfg, mesh)
        st = shard_smoke_state(T.init_smoke(cfg, device="cpu"), cfg, mesh)
        for _ in range(2):
            st = fn(st)
    elif route == "f32_mask":
        _stirred(cfg, steps=2, src=ts.source_tensor(cfg, "cpu").float())
    else:
        _stirred(cfg, steps=2)
    assert advect3d_kernel.source_launches == n + 2 * per_step

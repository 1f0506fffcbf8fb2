"""The port's 2D sharded step (``parallel/sharded.py``) on a 2x4 mesh of CPU
devices: against the port's own single-device step over the route matrix
of tests/test_sharded.py, and against the JAX package's
``make_sharded_step`` under ``shard_map`` on the 8-device CPU mesh.

Inputs come from a numpy seed (the state is kicked by seeded impulses).
Tolerances, each with its reason:

* against the single-device step, those of test_sharded.py: the eager
  semi-Lagrangian route and Jacobi rtol 1e-5 / atol 1e-5
  (:53-58, :280-282); wider SOR halos vs per-half-sweep exchange rtol 2e-6
  / atol 2e-6 (:125-127); vorticity, MacCormack and multigrid rtol 1e-4 /
  atol 1e-4 (:143-145, :263-268, :298-300); RK2 rtol 1e-3 / atol 5e-4
  (:175-180: a one-ulp shift of the window-rebased coordinate can move a
  stencil by a cell); the kernel routes against the single-device eager
  step rtol 1e-4 / atol 1e-4 (:242-247).  The kernel routes (K1, K2 and K4
  in block mode, through their plain versions here) must also equal the
  port's single-device kernel step bit for bit;
* against JAX's sharded step: rtol 1e-4 / atol 1e-4, the kernel route in
  interpret mode;
* the mesh-reduced metrics rtol 1e-4 / atol 1e-5 (:201-205);
* the sharded render: every pixel equal;
* the batched (dp x sp) mesh: the spatial step on a batch-2 mesh against
  JAX's at rtol 1e-4 / atol 1e-4, and bit-equal to the batch-1 mesh's;
  ``shard_state(..., batched=True)`` block for block equal to JAX's
  shards; the member stack stepped on it against JAX's
  ``jax.jit(jax.vmap(step))`` (``test_sharded.py:88-110``) at rtol 1e-5 /
  atol 1e-5, the single-device tolerance above, both members equal.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental import pallas as pl

import esp32_fluid_simulation_tpu as J
from esp32_fluid_simulation_tpu.parallel import (
    make_mesh as jmake_mesh, make_sharded_step as jmake_sharded_step,
    sharded_state_sharding as jsharding)
from esp32_fluid_simulation_tpu_torch import (SimConfig, Impulses,
                                              SimState, init_state,
                                              make_step,
                                              make_step_with_metrics)
from esp32_fluid_simulation_tpu_torch.interop import tensor_to_numpy
from esp32_fluid_simulation_tpu_torch.parallel import (
    gather, make_mesh, make_sharded_render, make_sharded_step,
    make_sharded_step_with_metrics, shard_state, unshard_state)
from esp32_fluid_simulation_tpu_torch.render import render_rgb565

torch.set_num_threads(1)

SHAPE = (64, 96)
KICKS = ([(20, 30), (40, 50)], [(90.0, -45.0), (-60.0, 120.0)])


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(["cpu"] * 8, grid_shape=(2, 4))


def _imp(cfg, pos, vel):
    return Impulses.from_lists(cfg, pos, vel, device="cpu")


def _kicked(cfg, steps=3):
    """A few single-device steps with seeded impulses: a non-trivial
    state."""
    fn = make_step(cfg)
    st = init_state(cfg, device="cpu")
    rng = np.random.default_rng(7)
    for _ in range(steps):
        pos = [(int(rng.integers(0, SHAPE[0])), int(rng.integers(0, SHAPE[1])))
               for _ in range(2)]
        st = fn(st, _imp(cfg, pos, KICKS[1]))
    return st


def _run_both(cfg, mesh, st, imps, **kw):
    """(single-device state, unsharded sharded state) after ``imps``."""
    single = make_step(cfg)
    sharded = make_sharded_step(cfg, mesh, **kw)
    a, b = st, shard_state(st, cfg, mesh)
    for imp in imps:
        a, b = single(a, imp), sharded(b, imp)
    return a, unshard_state(b, "cpu")


def _close(got, want, **tol):
    for name in ("velocity", "color"):
        np.testing.assert_allclose(getattr(got, name).float().numpy(),
                                   getattr(want, name).float().numpy(),
                                   **tol)


def test_sharded_step_matches_single_device(mesh):
    cfg = SimConfig(shape=SHAPE, sor_iters=10, omega=1.8)
    st = _kicked(cfg)
    want, got = _run_both(cfg, mesh, st,
                          [_imp(cfg, [(10, 10)], [(50.0, 80.0)])])
    _close(got, want, rtol=1e-5, atol=1e-5)
    assert got.step == want.step == st.step + 1


@pytest.mark.parametrize("solver", ["fused_pallas", "sor_pallas"])
@pytest.mark.parametrize("color_dtype", ["float32", "bfloat16"])
def test_sharded_kernel_routes_match_single_device(mesh, solver,
                                                   color_dtype):
    """K2 and K1 or K4 in block mode: bit-equal to the single-device
    kernel step, and within rtol 1e-4 / atol 1e-4 of the eager step (the
    float32 fields: the eager advection lerps a bf16 dye in bf16, the
    kernel in float32, ROADMAP.md queue 3)."""
    kw = dict(shape=SHAPE, sor_iters=3, color_dtype=color_dtype)
    kcfg = SimConfig(solver=solver, advect_impl="pallas", advect_max_disp=8,
                     **kw)
    ref = SimConfig(solver="sor", advect_impl="jnp", **kw)
    imps = [_imp(kcfg, *KICKS)] + [Impulses.none(kcfg, device="cpu")] * 2
    want, got = _run_both(kcfg, mesh, init_state(kcfg, device="cpu"), imps,
                          max_disp=8)
    assert torch.equal(got.velocity, want.velocity)
    assert torch.equal(got.color, want.color)
    eager = init_state(ref, device="cpu")
    for imp in imps:
        eager = make_step(ref)(eager, imp)
    np.testing.assert_allclose(got.velocity.numpy(), eager.velocity.numpy(),
                               rtol=1e-4, atol=1e-4)
    if color_dtype == "float32":
        np.testing.assert_allclose(got.color.numpy(), eager.color.numpy(),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("sor_halo", [2, 5, 20])
def test_sharded_sor_halo_depths_exact(mesh, sor_halo):
    cfg = SimConfig(shape=SHAPE, sor_iters=10, omega=1.8)
    st = shard_state(_kicked(cfg, steps=2), cfg, mesh)
    imp = _imp(cfg, [(10, 10)], [(50.0, 80.0)])
    base = unshard_state(make_sharded_step(cfg, mesh, sor_halo=1)(st, imp),
                         "cpu")
    wide = unshard_state(make_sharded_step(cfg, mesh, sor_halo=sor_halo)(
        st, imp), "cpu")
    np.testing.assert_allclose(wide.velocity.numpy(), base.velocity.numpy(),
                               rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("case,tol", [
    (dict(vorticity_eps=3.0), dict(rtol=1e-4, atol=1e-4)),
    (dict(advector="rk2", sor_iters=4), dict(rtol=1e-3, atol=5e-4)),
    (dict(advector="maccormack"), dict(rtol=1e-4, atol=1e-4)),
    (dict(solver="multigrid", mg_cycles=2), dict(rtol=1e-4, atol=1e-4)),
    (dict(solver="jacobi", sor_iters=20, omega=0.9),
     dict(rtol=1e-5, atol=1e-5)),
], ids=["vorticity", "rk2", "maccormack", "multigrid", "jacobi"])
def test_sharded_eager_routes_match_single_device(mesh, case, tol):
    cfg = SimConfig(shape=SHAPE, **case)
    imp = _imp(cfg, [(32, 48)], [(150.0, -90.0)])
    steps = 1 if cfg.solver == "jacobi" else 3
    imps = [imp] + [Impulses.none(cfg, device="cpu")] * (steps - 1)
    want, got = _run_both(cfg, mesh, init_state(cfg, device="cpu"), imps,
                          sor_halo=4 if cfg.solver == "jacobi" else 1)
    _close(got, want, **tol)


def test_sharded_maccormack_kernel_matches_eager(mesh):
    """``advect_impl="pallas"`` MacCormack (K2 block mode with
    ``return_minmax``, both passes) against the sharded eager MacCormack,
    as test_sharded.py:303-332, at rtol 1e-4 / atol 1e-4; and bit-equal to
    the single-device K5 step."""
    kw = dict(shape=SHAPE, advector="maccormack", sor_iters=3)
    ref = SimConfig(advect_impl="jnp", **kw)
    kcfg = SimConfig(advect_impl="pallas", advect_max_disp=8, **kw)
    imps = ([_imp(ref, [(32, 48)], [(150.0, -90.0)])]
            + [Impulses.none(ref, device="cpu")] * 2)
    fr = make_sharded_step(ref, mesh, max_disp=8)
    fk = make_sharded_step(kcfg, mesh, max_disp=8)
    sr = shard_state(init_state(ref, device="cpu"), ref, mesh)
    sk = shard_state(init_state(kcfg, device="cpu"), kcfg, mesh)
    single = init_state(kcfg, device="cpu")
    for imp in imps:
        sr, sk = fr(sr, imp), fk(sk, imp)
        single = make_step(kcfg)(single, imp)
    sr, sk = unshard_state(sr, "cpu"), unshard_state(sk, "cpu")
    _close(sk, sr, rtol=1e-4, atol=1e-4)
    assert torch.equal(sk.velocity, single.velocity)
    assert torch.equal(sk.color, single.color)


def test_sharded_multi_step_stability(mesh):
    cfg = SimConfig(shape=SHAPE)
    fn = make_sharded_step(cfg, mesh)
    st = shard_state(init_state(cfg, device="cpu"), cfg, mesh)
    for t in range(5):
        st = fn(st, _imp(cfg, [(32, 48)], [(200.0, 150.0)]) if t == 0
                else Impulses.none(cfg, device="cpu"))
    v = unshard_state(st, "cpu").velocity
    assert torch.isfinite(v).all() and float(v.abs().max()) > 0
    assert st.step == 5


def test_sharded_step_with_metrics_matches_single_device(mesh):
    cfg = SimConfig(shape=SHAPE, sor_iters=4)
    imp = _imp(cfg, [(32, 48)], [(120.0, -60.0)])
    st = _kicked(cfg, steps=2)
    _, want = make_step_with_metrics(cfg)(st, imp)
    out, got = make_sharded_step_with_metrics(cfg, mesh)(
        shard_state(st, cfg, mesh), imp)
    assert bool(got["finite"]) and bool(want["finite"])
    assert set(got) == set(want)
    for key in ("div_pre_max", "div_post_max", "poisson_residual_l2",
                "max_speed"):
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   rtol=1e-4, atol=1e-5)
    # the metrics step's state is the plain sharded step's
    plain = unshard_state(make_sharded_step(cfg, mesh)(
        shard_state(st, cfg, mesh), imp), "cpu")
    out = unshard_state(out, "cpu")
    assert torch.equal(out.velocity, plain.velocity)
    assert torch.equal(out.color, plain.color)


@pytest.mark.parametrize("s", [4, 1])
def test_sharded_render_matches_single(mesh, s):
    cfg = SimConfig(shape=SHAPE, scaling=s)
    st = _kicked(cfg, steps=2)
    want = render_rgb565(st.color, s=s)
    got = gather(make_sharded_render(cfg, mesh)(
        shard_state(st, cfg, mesh).color), "cpu")
    assert got.shape == want.shape == cfg.render_shape
    assert torch.equal(got, want)


def _jax_state(st):
    return J.SimState(velocity=jnp.asarray(st.velocity.numpy()),
                      color=jnp.asarray(tensor_to_numpy(st.color)),
                      step=jnp.int32(st.step))


@pytest.mark.parametrize("route", ["kernel", "eager"])
def test_sharded_step_follows_jax_sharded_step(monkeypatch, mesh, route):
    """The same state, mesh shape and impulses through JAX's
    ``make_sharded_step`` (``fused_pallas`` + pallas advect in interpret
    mode, or the eager SOR route) and the port's."""
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    kw = (dict(solver="fused_pallas", advect_impl="pallas",
               advect_max_disp=8, sor_iters=3) if route == "kernel"
          else dict(sor_iters=6))
    cfg = SimConfig(shape=SHAPE, **kw)
    jcfg = J.SimConfig(shape=SHAPE, **kw)
    st = _kicked(SimConfig(shape=SHAPE, sor_iters=3), steps=2)
    pos, val = [(10, 10), (33, 70)], [(50.0, 80.0), (-40.0, 30.0)]
    jmesh = jmake_mesh(jax.devices()[:8], grid_shape=(2, 4))
    jst = jax.device_put(_jax_state(st), jsharding(jcfg, jmesh))
    jout = jmake_sharded_step(jcfg, jmesh, max_disp=8, donate=False)(
        jst, J.Impulses.from_lists(jcfg, pos, val))
    out = unshard_state(make_sharded_step(cfg, mesh, max_disp=8)(
        shard_state(st, cfg, mesh), _imp(cfg, pos, val)), "cpu")
    np.testing.assert_allclose(out.velocity.numpy(),
                               np.asarray(jout.velocity), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(out.color.numpy(), np.asarray(jout.color),
                               rtol=1e-4, atol=1e-4)
    assert out.step == int(jout.step)


def test_sharded_step_refusals(mesh):
    """As in JAX: domain_tile configs, unsupported solvers and the 3D
    ``fused_pallas`` raise NotImplementedError, a grid the mesh does not
    divide ValueError; a batched mesh runs (its case is
    ``test_batched_mesh_step_follows_jax``)."""
    with pytest.raises(NotImplementedError, match="domain_tile"):
        make_sharded_step(SimConfig(shape=(128, 256), domain_tile=(32, 32)),
                          mesh)
    with pytest.raises(NotImplementedError, match="sor_adaptive"):
        make_sharded_step(SimConfig(shape=SHAPE, solver="sor_adaptive"),
                          mesh)
    with pytest.raises(ValueError, match="not divisible"):
        make_sharded_step(SimConfig(shape=(65, 96)), mesh)
    with pytest.raises(NotImplementedError, match="fused"):
        make_sharded_step(SimConfig(shape=(16, 16, 16),
                                    solver="fused_pallas"), mesh)
    make_sharded_step(SimConfig(shape=SHAPE),
                      make_mesh(["cpu"] * 8, batch=2, grid_shape=(2, 2)))
    with pytest.raises(ValueError, match="exceeds the shard extent"):
        # K1's halo (2*12+2) is wider than the 24-column blocks
        make_sharded_step(SimConfig(shape=SHAPE, solver="fused_pallas",
                                    sor_iters=12), mesh)(
            shard_state(init_state(SimConfig(shape=SHAPE), device="cpu"),
                        SimConfig(shape=SHAPE), mesh),
            Impulses.none(SimConfig(shape=SHAPE), device="cpu"))


def test_sharded_step_max_disp_follows_config(mesh):
    """``max_disp=None`` is ``cfg.advect_max_disp``; kernel advection
    refuses another clamp than the single-device step's."""
    cfg = SimConfig(shape=SHAPE, sor_iters=4, advect_max_disp=5)
    st = shard_state(_kicked(cfg, steps=2), cfg, mesh)
    imp = _imp(cfg, [(10, 10)], [(50.0, 80.0)])
    got = unshard_state(make_sharded_step(cfg, mesh)(st, imp), "cpu")
    want = unshard_state(make_sharded_step(cfg, mesh, max_disp=5)(st, imp),
                         "cpu")
    assert torch.equal(got.velocity, want.velocity)
    with pytest.raises(ValueError, match="advect_max_disp"):
        make_sharded_step(SimConfig(shape=SHAPE, advect_impl="pallas"), mesh,
                          max_disp=8)


def _batched_jax_mesh():
    return jmake_mesh(jax.devices()[:8], batch=2, grid_shape=(2, 2))


@pytest.fixture(scope="module")
def batched_mesh():
    return make_mesh(["cpu"] * 8, batch=2, grid_shape=(2, 2))


def test_batched_mesh_step_follows_jax(batched_mesh):
    """``make_sharded_step`` on the batch-2 mesh: JAX's state spec has no
    ``batch`` axis, so the spatial step runs replicated over it and gives
    the batch-1 result."""
    cfg = SimConfig(shape=SHAPE, sor_iters=6)
    jcfg = J.SimConfig(shape=SHAPE, sor_iters=6)
    st = _kicked(cfg, steps=2)
    pos, val = [(10, 10), (33, 70)], [(50.0, 80.0), (-40.0, 30.0)]
    jmesh = _batched_jax_mesh()
    jst = jax.device_put(_jax_state(st), jsharding(jcfg, jmesh))
    jout = jmake_sharded_step(jcfg, jmesh, max_disp=8, donate=False)(
        jst, J.Impulses.from_lists(jcfg, pos, val))
    out = unshard_state(make_sharded_step(cfg, batched_mesh, max_disp=8)(
        shard_state(st, cfg, batched_mesh), _imp(cfg, pos, val)), "cpu")
    np.testing.assert_allclose(out.velocity.numpy(),
                               np.asarray(jout.velocity), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(out.color.numpy(), np.asarray(jout.color),
                               rtol=1e-4, atol=1e-4)
    one = make_mesh(["cpu"] * 4, grid_shape=(2, 2))
    flat = unshard_state(make_sharded_step(cfg, one, max_disp=8)(
        shard_state(st, cfg, one), _imp(cfg, pos, val)), "cpu")
    assert torch.equal(out.velocity, flat.velocity)
    assert torch.equal(out.color, flat.color)


def _member_stack(cfg, n, seed):
    """``n`` seeded members: a kicked state each, stacked."""
    rng = np.random.default_rng(seed)
    fn = make_step(cfg)
    members = []
    for _ in range(n):
        st = init_state(cfg, device="cpu")
        pos = [(int(rng.integers(0, SHAPE[0])), int(rng.integers(0, SHAPE[1])))
               for _ in range(2)]
        members.append(fn(st, _imp(cfg, pos, KICKS[1])))
    return SimState(velocity=torch.stack([m.velocity for m in members]),
                    color=torch.stack([m.color for m in members]), step=1)


def test_batched_shard_state_places_as_jax(batched_mesh):
    """Each block of ``shard_state(..., batched=True)`` is the JAX shard at
    the same mesh position, ``P("batch", None, "x", "y")``, and
    ``unshard_state`` restores the stack."""
    cfg = SimConfig(shape=SHAPE)
    jcfg = J.SimConfig(shape=SHAPE)
    stack = _member_stack(cfg, 4, seed=3)
    sharded = shard_state(stack, cfg, batched_mesh, batched=True)
    jmesh = _batched_jax_mesh()
    jsh = jsharding(jcfg, jmesh, batched=True)
    for name in ("velocity", "color"):
        jarr = jax.device_put(jnp.asarray(getattr(stack, name).numpy()),
                              getattr(jsh, name))
        pos = {d: idx for idx, d in np.ndenumerate(jmesh.devices)}
        assert len(jarr.addressable_shards) == 8
        for shard in jarr.addressable_shards:
            r, a, b = pos[shard.device]
            got = getattr(sharded, name)[r][a][b]
            assert got.device == batched_mesh.devices[r, a, b]
            np.testing.assert_array_equal(got.numpy(),
                                          np.asarray(shard.data))
    back = unshard_state(sharded, "cpu", batched=True)
    assert torch.equal(back.velocity, stack.velocity)
    assert torch.equal(back.color, stack.color)
    with pytest.raises(ValueError, match="not divisible by batch"):
        shard_state(_member_stack(cfg, 3, seed=4), cfg, batched_mesh,
                    batched=True)


def test_batched_member_stack_step_follows_jax_vmap(batched_mesh):
    """The member stack on the batch-2 mesh, each batch row stepping its
    members with the spatial step over its own 2x2 shards, against JAX's
    ``jax.jit(jax.vmap(step))`` of the stack placed with ``P("batch")``
    (``tests/test_sharded.py:88-110``)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from esp32_fluid_simulation_tpu_torch.parallel.topology import Mesh

    cfg = SimConfig(shape=(32, 64))
    jcfg = J.SimConfig(shape=(32, 64))
    pos, val = [(16, 32)], [(100.0, -50.0)]
    st0 = init_state(cfg, device="cpu")
    stack = SimState(velocity=torch.stack([st0.velocity] * 2),
                     color=torch.stack([st0.color] * 2), step=0)
    sharded = shard_state(stack, cfg, batched_mesh, batched=True)
    out = []
    for r in range(2):
        row = Mesh(batched_mesh.devices[r:r + 1])
        step = make_sharded_step(cfg, row)
        v, c = sharded.velocity[r], sharded.color[r]
        member = SimState(velocity=[[blk[0] for blk in x] for x in v],
                          color=[[blk[0] for blk in x] for x in c], step=0)
        out.append(unshard_state(step(member, _imp(cfg, pos, val)), "cpu"))
    jfn = J.make_step(jcfg, donate=False)
    jst0 = J.init_state(jcfg)
    jbatch = jax.tree.map(lambda x: jnp.stack([x, x]), jst0)
    jimp = J.Impulses.from_lists(jcfg, pos, val)
    jimp_b = jax.tree.map(lambda x: jnp.stack([x, x]), jimp)
    spec = NamedSharding(_batched_jax_mesh(), P("batch"))
    jbatch = jax.device_put(jbatch, jax.tree.map(lambda _: spec, jst0))
    jout = jax.jit(jax.vmap(lambda s, i: jfn(s, i)))(jbatch, jimp_b)
    jv, jc = np.asarray(jout.velocity), np.asarray(jout.color)
    for r in range(2):
        np.testing.assert_allclose(out[r].velocity.numpy(), jv[r],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(out[r].color.numpy(), jc[r],
                                   rtol=1e-5, atol=1e-5)
    assert torch.equal(out[0].velocity, out[1].velocity)
    assert torch.equal(out[0].color, out[1].color)


def test_make_mesh_layout():
    """Near-square factoring, a repeated device, and the JAX-style
    ``shape`` mapping; no CUDA device means ``devices=None`` raises."""
    m = make_mesh(["cpu"] * 8)
    assert m.shape == {"batch": 1, "x": 2, "y": 4}
    assert make_mesh(["cpu"] * 6, grid_shape=(3, 2)).shape["x"] == 3
    assert all(d == torch.device("cpu") for d in m.devices.flat)
    with pytest.raises(ValueError):
        make_mesh(["cpu"] * 6, grid_shape=(2, 2))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()
    st = init_state(SimConfig(shape=SHAPE), device="cpu")
    back = unshard_state(shard_state(st, SimConfig(shape=SHAPE), m), "cpu")
    assert isinstance(back, SimState) and torch.equal(back.color, st.color)

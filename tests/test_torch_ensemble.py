"""Ensembles and tiled domains (BASELINE config 4) in the port against the
JAX package (CPU).

* the tiled-domain building blocks — ``init_color``, ``impulse_overlay``,
  the member impulse targets, their overlay and scatter, and
  ``_to/_from_members`` — bit for bit;
* ``_step_tiled``'s eager path against JAX's (which vmaps the member ops)
  at rtol 1e-4 / atol 1e-4 (test_models_extra.py:142-193);
* the kernel route (the plain versions of K1 and K2 with ``member=`` and
  the overlay) against JAX's kernel route (Pallas in interpret mode) and
  against the member loop (``mode="vmap"``), at rtol 1e-4 / atol 1e-4
  (test_models_extra.py:230-260, test_pallas.py:349-388), including odd
  member sizes, where the red-black parity of the whole supergrid makes
  both kernel routes differ from the member loop;
* ``make_ensemble_multi_step`` against stepping, the ``apply_fn`` contract
  of ``_step_tiled``, the mode refusals and the auto-vmap guard, the tiled
  ``step_render`` frame, and the ensemble state's interop.
"""

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental import pallas as pl

import esp32_fluid_simulation_tpu as J
import esp32_fluid_simulation_tpu_torch as T
from esp32_fluid_simulation_tpu.models import ensemble as jens
from esp32_fluid_simulation_tpu.models import stable_fluids as jsf
from esp32_fluid_simulation_tpu_torch.io_host.touch import scripted_swirl
from esp32_fluid_simulation_tpu_torch.interop import (
    ensemble_state_from_numpy, ensemble_state_to_numpy, impulses_from_numpy,
    tensor_from_numpy)
from esp32_fluid_simulation_tpu_torch.models import ensemble as tens
from esp32_fluid_simulation_tpu_torch.models import stable_fluids as tsf
from esp32_fluid_simulation_tpu_torch.ops.cuda.advect import (
    member_overlay_reference)

torch.set_num_threads(1)

F = np.float32
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture
def interpret_pallas(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def _t(x):
    return tensor_from_numpy(np.asarray(x), device="cpu")


def _f32(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32))


def _member_imps(pkg, cfg, n, t=0):
    """Per-member impulse lists: member 0 writes one cell twice (the later
    slot wins), the others two cells each; slot positions move with t."""
    kw = {"device": "cpu"} if pkg is T else {}
    return [pkg.Impulses.from_lists(
        cfg, [(8 + k + t, 9), (8 + k + t, 9) if k == 0 else (20, 4 + k)],
        [(float(50 + 30 * k), -40.0), (25.0, float(-60 + 10 * k))], **kw)
        for k in range(n)]


def _stacks(cfg_kw, n, t=0):
    jcfg, tcfg = J.SimConfig(**cfg_kw), T.SimConfig(**cfg_kw)
    return (jens.stack_impulses(_member_imps(J, jcfg, n, t)),
            T.stack_impulses(_member_imps(T, tcfg, n, t)))


@pytest.mark.parametrize("color_dtype", ["float32", "bfloat16"])
def test_init_color_domain_tile_matches_jax(color_dtype):
    """Each member tile gets the member's blurred sector pattern."""
    kw = dict(shape=(48, 80), domain_tile=(24, 40), color_dtype=color_dtype)
    want = _f32(jsf.init_color(J.SimConfig(**kw)))
    got = tsf.init_color(T.SimConfig(**kw), device="cpu")
    assert got.dtype == T.SimConfig(**kw).torch_color_dtype
    # XLA on the CPU flushes the bf16 blur's subnormal tail to zero where
    # PyTorch keeps it (ROADMAP queue 3), hence the tiny atol
    np.testing.assert_allclose(_f32(got), want, rtol=0, atol=1e-30)
    member = tsf.init_color(T.SimConfig(shape=(24, 40),
                                        color_dtype=color_dtype),
                            device="cpu")
    assert torch.equal(got[:, 24:, 40:], member)


def test_impulse_overlay_matches_jax():
    """Duplicate cells (the last active slot wins), an out-of-range
    position (clamped), an inactive slot, a zero-velocity write."""
    shape = (16, 20)
    pos = [(3, 4), (3, 4), (15, 2), (40, -7), (3, 4), (9, 9)]
    val = [(1.0, 2.0), (3.0, 4.0), (5.0, 6.0), (7.0, 8.0), (9.0, 10.0),
           (0.0, 0.0)]
    jimp = J.Impulses.from_lists(J.SimConfig(shape=shape, max_impulses=8),
                                 pos, val)
    jimp = jimp._replace(active=jimp.active.at[4].set(False))
    timp = impulses_from_numpy(*(np.asarray(x) for x in jimp), device="cpu")
    got = tsf.impulse_overlay(timp, shape)
    assert got.dtype == torch.float32 and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jsf.impulse_overlay(jimp, shape)))


def test_member_impulses_match_jax(rng):
    """The member impulse targets, their overlay and their scatter onto the
    supergrid velocity, and the batched Impulses crossing from JAX."""
    kw = dict(shape=(8, 10), max_impulses=3)
    n = 6
    cfg_super, gh, gw = jens.tiled_ensemble_config(J.SimConfig(**kw), n)
    jimp, timp = _stacks(kw, n)
    # member 3 sends a position past its tile (clamped to the member) and
    # member 5 an inactive slot
    jimp = jimp._replace(pos=jimp.pos.at[3, 1].set(jnp.array([30, -4])),
                         active=jimp.active.at[5, 0].set(False))
    timp = impulses_from_numpy(*(np.asarray(x) for x in jimp), device="cpu")
    for g, w in zip(timp, T.stack_impulses(_member_imps(
            T, T.SimConfig(**kw), n))):
        assert g.shape == w.shape and g.dtype == w.dtype
    want = jens._member_impulse_targets(jimp, gh, gw, 8, 10)
    got = tens._member_impulse_targets(timp, gh, gw, 8, 10)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(
        member_overlay_reference(timp, gh, gw, 8, 10).numpy(),
        np.asarray(jens._member_impulse_overlay(jimp, gh, gw, 8, 10)))
    vel = rng.normal(0, 5, (2,) + cfg_super.shape).astype(F)
    np.testing.assert_array_equal(
        tens._apply_member_impulses(_t(vel), timp, gh, gw, 8, 10).numpy(),
        np.asarray(jens._apply_member_impulses(jnp.asarray(vel), jimp, gh,
                                               gw, 8, 10)))


def test_members_layout_matches_jax(rng):
    x = rng.random((3, 48, 80), dtype=F)
    want = np.asarray(jsf._to_members(jnp.asarray(x), 24, 20))
    got = tsf._to_members(_t(x), 24, 20)
    assert tuple(got.shape) == (8, 3, 24, 20) and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)
    back = tsf._from_members(got, 48, 80)
    assert back.is_contiguous() and torch.equal(back, _t(x))


@pytest.mark.parametrize("solver", ["sor", "jacobi"])
def test_step_tiled_eager_path_matches_jax(solver):
    """A 2x2 supergrid of 24x40 members stepped 3 times with impulses in
    three members (test_models_extra.py:142-193): the port loops over the
    members where JAX vmaps them."""
    kw = dict(shape=(48, 80), domain_tile=(24, 40), sor_iters=4,
              solver=solver)
    jcfg, tcfg = J.SimConfig(**kw), T.SimConfig(**kw)
    pos = [(10, 12), (10 + 24, 12), (12, 12 + 40), (30, 50)]
    val = [(90.0, -45.0), (-60.0, 120.0), (50.0, 80.0), (-70.0, -30.0)]
    jst, tst = jsf.init_state(jcfg), tsf.init_state(tcfg, device="cpu")
    jstep = J.make_step(jcfg, donate=False)
    for t in range(3):
        jimp = (J.Impulses.from_lists(jcfg, pos, val) if t == 0
                else J.Impulses.none(jcfg))
        timp = (T.Impulses.from_lists(tcfg, pos, val, device="cpu") if t == 0
                else T.Impulses.none(tcfg, device="cpu"))
        jst = jstep(jst, jimp)
        tst = T.step(tst, timp, tcfg)
    assert tst.step == 3
    np.testing.assert_allclose(tst.velocity.numpy(), np.asarray(jst.velocity),
                               **TOL)
    np.testing.assert_allclose(tst.color.numpy(), np.asarray(jst.color),
                               **TOL)


def test_odd_members_follow_jax_kernel_route(interpret_pallas):
    """Odd 33x35 members (``_tiled_compatible`` admits them) on a 2x2
    supergrid, 2 steps.  The kernel route of the port (plain K1/K2 with
    ``member=``) follows JAX's (Pallas in interpret mode), and the member
    loops of both packages agree.  The two routes differ: the red-black
    colour is the supergrid's parity, so members 1 and 2, whose origins
    (0, 35) and (33, 0) are odd, sweep their colours in the other order
    than alone; members 0 and 3, at even origins, agree."""
    kw = dict(shape=(33, 35), sor_iters=4, max_impulses=2,
              advect_impl="pallas", advect_max_disp=8)
    n = 4
    jcfg, tcfg = J.SimConfig(**kw), T.SimConfig(**kw)
    jst, tst = jens.init_ensemble(jcfg, n), T.init_ensemble(tcfg, n,
                                                            device="cpu")
    out = {}
    for mode in ("auto", "vmap"):
        jfn = jens.make_ensemble_step(jcfg, donate=False, mode=mode)
        tfn = T.make_ensemble_step(tcfg, mode=mode)
        js, ts = jst, tst
        for t in range(2):
            jimp, timp = _stacks(kw, n, t)
            js, ts = jfn(js, jimp), tfn(ts, timp)
        np.testing.assert_allclose(ts.velocity.numpy(),
                                   np.asarray(js.velocity), **TOL)
        np.testing.assert_allclose(ts.color.numpy(), np.asarray(js.color),
                                   **TOL)
        out[mode] = ts
    dv = (out["auto"].velocity - out["vmap"].velocity).abs().amax(
        dim=(1, 2, 3))
    assert float(dv[1]) > 0.1 and float(dv[2]) > 0.1
    assert float(dv[0]) < 1e-4 and float(dv[3]) < 1e-3


@pytest.mark.parametrize("advect_impl", ["auto", "pallas"])
def test_ensemble_auto_tiled_matches_vmap(advect_impl):
    """Even 32x32 members, 6 of them, 3 steps (test_models_extra.py:
    230-260): the tiled route (on the CPU the eager path under "auto", the
    kernel route's plain versions under "pallas") against the member loop,
    and the "auto" route against JAX's."""
    kw = dict(shape=(32, 32), sor_iters=4, max_impulses=2,
              advect_impl=advect_impl)
    n = 6
    cfg = T.SimConfig(**kw)
    st = T.init_ensemble(cfg, n, device="cpu")
    fn_auto = T.make_ensemble_step(cfg)
    fn_vmap = T.make_ensemble_step(cfg, mode="vmap")
    sa = sv = st
    for t in range(3):
        _, imp = _stacks(kw, n)
        if t:
            imp = T.stack_impulses([T.Impulses.none(cfg, device="cpu")] * n)
        sa, sv = fn_auto(sa, imp), fn_vmap(sv, imp)
    assert sa.step == sv.step == 3
    assert tuple(sa.velocity.shape) == (n, 2, 32, 32)
    np.testing.assert_allclose(sa.velocity.numpy(), sv.velocity.numpy(),
                               **TOL)
    np.testing.assert_allclose(sa.color.numpy(), sv.color.numpy(), **TOL)
    # members got different kicks -> different fields
    assert not torch.allclose(sa.velocity[0], sa.velocity[1])
    if advect_impl == "auto":
        jcfg = J.SimConfig(**kw)
        js = jens.init_ensemble(jcfg, n)
        jfn = jens.make_ensemble_step(jcfg, donate=False)
        for t in range(3):
            jimp, _ = _stacks(kw, n)
            if t:
                jimp = jens.stack_impulses([J.Impulses.none(jcfg)] * n)
            js = jfn(js, jimp)
        np.testing.assert_allclose(sa.velocity.numpy(),
                                   np.asarray(js.velocity), **TOL)
        np.testing.assert_allclose(sa.color.numpy(), np.asarray(js.color),
                                   **TOL)


def test_tiled_member0_equals_the_member_alone(rng):
    """Member 0 of the tiled kernel route sits at the origin: its
    coordinates, walls and colours are those of the member stepped alone on
    the non-member kernels, so the two agree bit for bit."""
    kw = dict(shape=(32, 48), sor_iters=4, max_impulses=2,
              advect_impl="pallas")
    n = 4
    cfg = T.SimConfig(**kw)
    alone = dataclasses.replace(cfg, solver="fused_pallas")
    st = T.init_ensemble(cfg, n, device="cpu")
    s0 = tsf.init_state(alone, device="cpu")
    fn = T.make_ensemble_step(cfg)
    for t in range(3):
        imps = _member_imps(T, cfg, n, t)
        st = fn(st, T.stack_impulses(imps))
        s0 = T.step(s0, imps[0], alone)
    assert torch.equal(st.velocity[0], s0.velocity)
    assert torch.equal(st.color[0], s0.color)


@pytest.mark.parametrize("mode", ["auto", "vmap"])
def test_ensemble_multi_step_matches_stepwise(mode):
    """``make_ensemble_multi_step`` (one layout conversion per call) ==
    iterating ``make_ensemble_step`` (test_models_extra.py:262-290); the
    same ops in the same order, so bit for bit."""
    cfg = T.SimConfig(shape=(32, 32), sor_iters=4, max_impulses=2,
                      advect_impl="pallas")
    n = 4
    st = T.init_ensemble(cfg, n, device="cpu")
    per_step = [T.stack_impulses(
        [T.Impulses.from_lists(cfg, [(8 + k + t, 9)], [(40.0, -30.0 + k)],
                               device="cpu") for k in range(n)])
        for t in range(3)]
    out = T.make_ensemble_multi_step(cfg, mode=mode)(
        st, T.stack_schedule(per_step))
    ref = st
    step = T.make_ensemble_step(cfg, mode=mode)
    for imp in per_step:
        ref = step(ref, imp)
    assert out.step == ref.step == 3
    assert torch.equal(out.velocity, ref.velocity)
    assert torch.equal(out.color, ref.color)


@pytest.mark.parametrize("kernel_path", [True, False])
def test_step_tiled_apply_fn_overrides_impulses(kernel_path):
    """A caller's ``apply_fn`` replaces the impulse application on both
    paths (``stable_fluids.py:228-260``): the impulses are not applied,
    and no overlay is built from them."""
    kw = dict(shape=(64, 64), domain_tile=(32, 32), sor_iters=3)
    if kernel_path:
        kw.update(solver="fused_pallas", advect_impl="pallas")
    cfg = T.SimConfig(**kw)
    st = tsf.init_state(cfg, device="cpu")
    imp = T.Impulses.from_lists(cfg, [(10, 12), (40, 50)],
                                [(90.0, -45.0), (-60.0, 120.0)],
                                device="cpu")
    none = T.Impulses.none(cfg, device="cpu")
    plain = tsf._step_tiled(st, none, cfg)
    kicked = tsf._step_tiled(st, imp, cfg)
    ignored = tsf._step_tiled(st, imp, cfg, apply_fn=lambda v: v)
    applied = tsf._step_tiled(st, none, cfg, apply_fn=functools.partial(
        tsf.apply_impulses, imp=imp))
    assert torch.equal(ignored.velocity, plain.velocity)
    assert torch.equal(ignored.color, plain.color)
    assert torch.equal(applied.velocity, kicked.velocity)
    assert torch.equal(applied.color, kicked.color)
    assert not torch.equal(kicked.velocity, plain.velocity)


def test_ensemble_mode_refusals_and_auto_vmap_guard():
    """``mode="tiled"`` refuses an incompatible config; under ``"auto"`` the
    member loop raises from 64 members on unless ``"vmap"`` is explicit,
    and stays quiet for small ensembles (test_sharded_tiled.py:118-133)."""
    cfg = T.SimConfig(shape=(16, 16), vorticity_eps=2.0, sor_iters=2)
    with pytest.raises(ValueError, match="not tiled-ensemble compatible"):
        T.make_ensemble_step(cfg, mode="tiled")
    with pytest.raises(ValueError, match="not tiled-ensemble compatible"):
        T.make_ensemble_multi_step(cfg, mode="tiled")
    with pytest.raises(ValueError, match="unknown ensemble mode"):
        T.make_ensemble_step(cfg, mode="vectorized")
    state = T.init_ensemble(cfg, 64, device="cpu")
    imps = T.stack_impulses([scripted_swirl(cfg, m, device="cpu")
                             for m in range(64)])
    with pytest.raises(ValueError, match="vmap ensemble path"):
        T.make_ensemble_step(cfg)(state, imps)
    with pytest.raises(ValueError, match="vmap ensemble path"):
        T.make_ensemble_multi_step(cfg)(
            state, T.stack_schedule([imps]))
    out = T.make_ensemble_step(cfg, mode="vmap")(state, imps)
    assert torch.isfinite(out.velocity).all()
    small = T.SimState(state.velocity[:4], state.color[:4], 0)
    out2 = T.make_ensemble_step(cfg)(small, T.Impulses(*(x[:4]
                                                         for x in imps)))
    assert torch.isfinite(out2.velocity).all() and out2.step == 1


def test_tiled_helpers_match_jax():
    """``tiled_ensemble_config`` factorization and the member impulse
    offsetting of ``tiled_member_impulses`` (test_models_extra.py:
    195-216)."""
    member = T.SimConfig(shape=(24, 40), sor_iters=4)
    for n in (6, 7, 16, 256):
        cfg, gh, gw = T.tiled_ensemble_config(member, n, solver="sor")
        jcfg, jgh, jgw = jens.tiled_ensemble_config(
            J.SimConfig(shape=(24, 40), sor_iters=4), n, solver="sor")
        assert (gh, gw) == (jgh, jgw) and cfg.shape == jcfg.shape
        assert cfg.domain_tile == (24, 40)
    cfg, gh, gw = T.tiled_ensemble_config(member, 6)
    assert cfg.solver == "fused_pallas"
    imp = T.tiled_member_impulses(cfg, member, gh, gw,
                                  [([], [])] * 5 + [([(3, 4)], [(1.0, 2.0)])],
                                  device="cpu")
    assert int(imp.active.sum()) == 1
    assert tuple(imp.pos[0].tolist()) == ((5 // gw) * 24 + 3,
                                          (5 % gw) * 40 + 4)


def test_tiled_step_render_frame_is_the_render(interpret_pallas,
                                               monkeypatch):
    """``step_render`` on a ``domain_tile`` config packs the frame on the
    member-mode dye store: the state equals ``step``'s and the frame
    ``render_rgb565(color, s=1)``, bit for bit (test_pallas.py:643-666);
    one step follows JAX's tiled ``step_render`` (velocity rtol 1e-5 /
    atol 2e-5, the bf16 dye to one bf16 ulp, as
    test_torch_slice.py:98-124)."""
    monkeypatch.setattr(jsf, "_use_pallas_advect", lambda cfg: True)
    kw = dict(shape=(64, 128), scaling=1, solver="fused_pallas",
              advect_impl="pallas", color_dtype="bfloat16",
              advect_max_disp=8, domain_tile=(32, 64))
    jcfg, tcfg = J.SimConfig(**kw), T.SimConfig(**kw)
    pos, val = [(5, 7), (40, 100)], [(30.0, -12.0), (-8.0, 25.0)]
    st = tsf.init_state(tcfg, device="cpu")
    imp = T.Impulses.from_lists(tcfg, pos, val, device="cpu")
    st2, frame = T.step_render(st, imp, tcfg)
    ref = T.step(st, imp, tcfg)
    assert frame.dtype == torch.uint16 and tuple(frame.shape) == (63, 127)
    assert torch.equal(st2.velocity, ref.velocity)
    assert torch.equal(st2.color.view(torch.int16),
                       ref.color.view(torch.int16))
    assert torch.equal(frame, T.render_rgb565(ref.color, s=1,
                                              unit_range=True))
    jst, jframe = jsf.step_render(jsf.init_state(jcfg),
                                  J.Impulses.from_lists(jcfg, pos, val), jcfg)
    np.testing.assert_allclose(st2.velocity.numpy(), np.asarray(jst.velocity),
                               rtol=1e-5, atol=2e-5)
    jc, tc = _f32(jst.color), _f32(st2.color)
    np.testing.assert_allclose(tc, jc, rtol=2 ** -7, atol=1e-30)
    same = (tc == jc).all(axis=0)[:-1, :-1]
    np.testing.assert_array_equal(frame.numpy()[same], np.asarray(jframe)[same])


def test_step_with_metrics_ignores_domain_tile():
    """As in JAX (``stable_fluids.py:391-424``), the metrics step steps the
    whole grid as one domain."""
    kw = dict(shape=(32, 48), sor_iters=3)
    tiled = T.SimConfig(domain_tile=(16, 24), **kw)
    whole = T.SimConfig(**kw)
    st = tsf.init_state(whole, device="cpu")
    imp = T.Impulses.from_lists(whole, [(5, 7)], [(30.0, -12.0)],
                                device="cpu")
    a, ma = T.make_step_with_metrics(tiled)(st, imp)
    b, mb = T.make_step_with_metrics(whole)(st, imp)
    assert torch.equal(a.velocity, b.velocity)
    assert torch.equal(a.color, b.color)
    assert all(torch.equal(ma[k], mb[k]) for k in ma)


def test_ensemble_state_interop_round_trip():
    """A JAX ensemble state (``[n]`` step array) crosses to the member
    stack (one int step) and back; members at different steps raise."""
    cfg = J.SimConfig(shape=(12, 10), color_dtype="bfloat16")
    js = jens.init_ensemble(cfg, 3)
    js = js._replace(step=js.step + 5)
    st = ensemble_state_from_numpy(*jax.tree_util.tree_map(np.asarray, js),
                                   device="cpu")
    assert st.step == 5 and tuple(st.velocity.shape) == (3, 2, 12, 10)
    assert st.color.dtype == torch.bfloat16
    v, c, step = ensemble_state_to_numpy(st)
    np.testing.assert_array_equal(v, np.asarray(js.velocity))
    np.testing.assert_array_equal(c, np.asarray(js.color).view(np.uint16))
    np.testing.assert_array_equal(step, np.asarray(js.step))
    assert step.dtype == np.int32
    with pytest.raises(ValueError, match="different steps"):
        ensemble_state_from_numpy(v, c, np.array([1, 2, 2]), device="cpu")

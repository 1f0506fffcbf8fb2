"""The rest of the 2D model as a whole against the JAX package (CPU).

* The four self-golden trajectories ``tests/golden/path_{maccormack,rk2,
  vorticity,multigrid}.npz`` at test_golden_paths.py's tolerance (rtol
  1e-4 / atol 1e-4), on the composed path, and for MacCormack also with
  ``advect_impl="pallas"`` (the plain K5; the backtrace stays inside
  ``max_disp``, which the test asserts, so the CFL clamp never binds).
* Config 3 (``examples/config3_2048_maccormack_multigrid.json``) shrunk to
  64^2 with ``advect_impl="pallas"`` (the plain K5 runs) against the JAX
  composed path, the CPU oracle (JAX never picks its kernels off TPU).
  float32 dye: rtol 1e-4 / atol 1e-4, since the plain K5 does the eager
  op's float32 arithmetic inside the clamp.  bf16 dye: the eager op lerps
  and limits in bf16 (fractions cast to bf16, ``ops/advect.py:85``) where
  K5 lerps in float32 and rounds once at the store, so the dye agrees to
  a few bf16 ulps (atol 2^-5 on [0, 1] values) and its mean to 1e-3.
* ``step_with_metrics`` against the JAX one: the same five keys, values
  at rtol 1e-4 (absolute 1e-4 for the near-zero residuals); K1 runs in
  interpret mode on the JAX side.
* Vorticity with ``solver="fused_pallas"``: impulses, confinement, then K1
  without impulses, against the JAX step with the interpret-mode K1.
* ``step_render`` of a MacCormack ``fused_pallas`` config equals ``step``
  + ``render_rgb565``: the K2 RGB565 path is not taken.
"""

import dataclasses
import functools
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental import pallas as pl

import esp32_fluid_simulation_tpu as J
import esp32_fluid_simulation_tpu_torch as T
from esp32_fluid_simulation_tpu.models import stable_fluids as jsf
from esp32_fluid_simulation_tpu_torch.models import stable_fluids as tsf
from tools.gen_golden_paths import CONFIGS, STEPS, schedule

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "golden"
CONFIG3 = ROOT / "examples" / "config3_2048_maccormack_multigrid.json"


@pytest.fixture
def interpret_pallas(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def _golden_impulses(cfg, t):
    """``tools/gen_golden_paths.py::schedule`` on the port."""
    return T.Impulses.from_lists(
        cfg, [(10 + t, 12), (30, 40 + t), (20, 55)],
        [(130.0, -70.0), (-80.0, 140.0), (60.0, 60.0)], device="cpu")


def _swirl(pkg, cfg, t):
    h, w = cfg.shape
    pos = [(h // 4 + t, w // 3), (h // 2, w // 2 + t), (3 * h // 4, w - 9)]
    val = [(120.0, -60.0), (-90.0, 150.0), (50.0, 50.0)]
    if pkg is T:
        return T.Impulses.from_lists(cfg, pos, val, device="cpu")
    return J.Impulses.from_lists(cfg, pos, val)


def _run_jax(cfg, steps, imps, step_fn=None):
    st = J.init_state(cfg)
    fn = step_fn or J.make_step(cfg, donate=False)
    for t in range(steps):
        st = fn(st, imps(J, cfg, t))
    return st


# The goldens come from the jitted JAX step.  XLA on the CPU contracts a
# multiply and an add inside one fusion into an FMA; an eager step cannot,
# so JAX's own step under ``jax.disable_jit()`` misses the vorticity and
# multigrid goldens at rtol 1e-4 / atol 1e-4 on one velocity cell each (by
# 1.6e-4 and 2.2e-4 beyond the bound).  The port equals that eager step to
# the bit, and is held to the goldens at the absolute tolerance the eager
# JAX step needs there.
GOLDEN_ATOL = {"vorticity": 3e-4, "multigrid": 3e-4}


@pytest.mark.parametrize("name,kw", [
    ("maccormack", {}), ("maccormack", dict(advect_impl="pallas")),
    ("rk2", {}), ("vorticity", {}), ("multigrid", {})],
    ids=["maccormack", "maccormack_k5", "rk2", "vorticity", "multigrid"])
def test_port_reproduces_path_golden(name, kw):
    jcfg = CONFIGS[name]
    cfg = dataclasses.replace(T.SimConfig.from_json(jcfg.to_json()), **kw)
    st = T.init_state(cfg, device="cpu")
    fn = T.make_step(cfg)
    jst = J.init_state(jcfg)
    max_step = 0.0
    for t in range(STEPS):
        max_step = max(max_step, float(st.velocity.abs().max()) * cfg.dt)
        st = fn(st, _golden_impulses(cfg, t))
        with jax.disable_jit():
            jst = jsf.step(jst, schedule(jcfg, t), jcfg)
    # inside the CFL clamp, so the kernel path computes the eager one
    assert max_step < cfg.advect_max_disp
    np.testing.assert_array_equal(st.velocity.numpy(),
                                  np.asarray(jst.velocity))
    np.testing.assert_array_equal(st.color.numpy(), np.asarray(jst.color))
    atol = GOLDEN_ATOL.get(name, 1e-4)
    with np.load(GOLDEN / f"path_{name}.npz") as z:
        np.testing.assert_allclose(st.velocity.numpy(), z["velocity"],
                                   rtol=1e-4, atol=atol)
        np.testing.assert_allclose(st.color.float().numpy(), z["color"],
                                   rtol=1e-4, atol=1e-4)


def _config3_64(**kw):
    base = dict(T.SimConfig.from_json(CONFIG3.read_text()).__dict__,
                shape=(64, 64))
    return dict(base, **kw)


@pytest.fixture(scope="module")
def jax_config3():
    """The JAX composed config-3 trajectory at 64^2 by dye dtype, run op
    by op: the two dtypes share the compiles of every velocity op."""
    cache = {}

    def run(color_dtype, steps):
        if color_dtype not in cache:
            cfg = J.SimConfig(**_config3_64(color_dtype=color_dtype,
                                            advect_impl="jnp"))
            cache[color_dtype] = _run_jax(
                cfg, steps, _swirl, step_fn=functools.partial(jsf.step,
                                                              cfg=cfg))
        return cache[color_dtype]

    return run


@pytest.mark.parametrize("color_dtype", ["float32", "bfloat16"])
def test_config3_shrunk_kernel_path_follows_jax(jax_config3, color_dtype):
    tcfg = T.SimConfig(**_config3_64(color_dtype=color_dtype,
                                     advect_impl="pallas"))
    assert tcfg.solver == "multigrid" and tcfg.advector == "maccormack"
    steps = 3
    jst = jax_config3(color_dtype, steps)
    tst = T.init_state(tcfg, device="cpu")
    render = T.make_step_render(tcfg)
    for t in range(steps):
        assert float(tst.velocity.abs().max()) * tcfg.dt < 12
        tst, frame = render(tst, _swirl(T, tcfg, t))
    assert frame.shape == (63, 63) and frame.dtype == torch.uint16
    assert tst.color.dtype == tcfg.torch_color_dtype
    np.testing.assert_allclose(tst.velocity.numpy(), np.asarray(jst.velocity),
                               rtol=1e-4, atol=1e-4)
    tc = tst.color.float().numpy()
    jc = np.asarray(jst.color, np.float32)
    if color_dtype == "float32":
        np.testing.assert_allclose(tc, jc, rtol=1e-4, atol=1e-4)
    else:
        np.testing.assert_allclose(tc, jc, rtol=0, atol=2 ** -5)
        assert abs(tc.mean() - jc.mean()) < 1e-3


METRIC_CONFIGS = {
    "sor": dict(shape=(24, 32)),
    "fused_pallas": dict(shape=(24, 32), solver="fused_pallas"),
    "rk2_jacobi": dict(shape=(24, 32), advector="rk2", solver="jacobi",
                       sor_iters=20),
    "maccormack_vort": dict(shape=(25, 33), advector="maccormack",
                            sor_iters=6, vorticity_eps=2.0),
}


@pytest.mark.parametrize("name", sorted(METRIC_CONFIGS))
def test_step_with_metrics_follows_jax(name, interpret_pallas):
    kw = METRIC_CONFIGS[name]
    jcfg, tcfg = J.SimConfig(**kw), T.SimConfig(**kw)
    jst, tst = J.init_state(jcfg), T.init_state(tcfg, device="cpu")
    jfn = jax.jit(functools.partial(jsf.step_with_metrics, cfg=jcfg))
    tfn = T.make_step_with_metrics(tcfg)
    for t in range(2):
        jst, jm = jfn(jst, _swirl(J, jcfg, t))
        tst, tm = tfn(tst, _swirl(T, tcfg, t))
    assert sorted(tm) == sorted(jm) == sorted(
        ["div_pre_max", "div_post_max", "poisson_residual_l2", "max_speed",
         "finite"])
    for key, val in tm.items():
        assert isinstance(val, torch.Tensor) and val.dim() == 0, key
    assert bool(tm["finite"]) and bool(jm["finite"])
    for key in ("div_pre_max", "div_post_max", "poisson_residual_l2",
                "max_speed"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                   rtol=1e-4, atol=1e-4, err_msg=key)
    assert float(tm["div_post_max"]) < float(tm["div_pre_max"])
    np.testing.assert_allclose(tst.velocity.numpy(), np.asarray(jst.velocity),
                               rtol=1e-4, atol=2e-4)
    np.testing.assert_allclose(tst.color.float().numpy(),
                               np.asarray(jst.color, np.float32),
                               rtol=1e-4, atol=2e-4)


def test_metrics_state_equals_step_state():
    """The metrics step advances the state as ``step`` does (fused
    projection: scatter + K1 without impulses == K1's own drain)."""
    cfg = T.SimConfig(**METRIC_CONFIGS["fused_pallas"], advect_impl="pallas",
                      advect_max_disp=8)
    st = T.init_state(cfg, device="cpu")
    a, _ = T.step_with_metrics(st, _swirl(T, cfg, 0), cfg)
    b = T.step(st, _swirl(T, cfg, 0), cfg)
    assert a.step == b.step == 1
    assert torch.equal(a.velocity, b.velocity)
    assert torch.equal(a.color, b.color)


def test_vorticity_fused_projection_follows_jax(interpret_pallas,
                                                monkeypatch):
    """``fused_pallas`` + ``vorticity_eps > 0``: apply_impulses ->
    vorticity_confinement -> K1 without impulses, in both packages (K1 at
    test_torch_kernels_ref.py's tolerance, rtol 1e-4 / atol 2e-5)."""
    kw = dict(shape=(32, 128), solver="fused_pallas", vorticity_eps=2.0,
              sor_iters=6)
    jcfg, tcfg = J.SimConfig(**kw), T.SimConfig(**kw)
    seen = []
    orig = tsf.project_fused

    def spy(vel, *args, impulses=None):
        seen.append(impulses)
        return orig(vel, *args, impulses=impulses)

    monkeypatch.setattr(tsf, "project_fused", spy)
    jst = _run_jax(jcfg, 2, _swirl,
                   step_fn=functools.partial(jsf.step, cfg=jcfg))
    tst = T.init_state(tcfg, device="cpu")
    for t in range(2):
        tst = T.step(tst, _swirl(T, tcfg, t), tcfg)
    assert seen == [None, None]
    np.testing.assert_allclose(tst.velocity.numpy(), np.asarray(jst.velocity),
                               rtol=1e-4, atol=2e-5)
    np.testing.assert_allclose(tst.color.numpy(), np.asarray(jst.color),
                               rtol=1e-4, atol=2e-5)


@pytest.mark.parametrize("kw", [dict(advector="maccormack"),
                                dict(vorticity_eps=2.0)],
                         ids=["maccormack", "vorticity"])
def test_step_render_unfused_features_equal_step_then_render(kw,
                                                             monkeypatch):
    """A ``fused_pallas`` + kernel-advect config at ``scaling=1`` that
    runs MacCormack or confinement does not take the K2 RGB565 path: no
    advection call asks for a frame, the state is ``step``'s and the frame
    ``render_rgb565`` of that state."""
    cfg = T.SimConfig(shape=(32, 48), scaling=1, solver="fused_pallas",
                      advect_impl="pallas", color_dtype="bfloat16",
                      advect_max_disp=8, **kw)
    st = T.init_state(cfg, device="cpu")
    imp = _swirl(T, cfg, 0)
    asked = []
    orig = tsf.advect_kernel

    def spy(*args, **kwargs):
        asked.append(kwargs.get("rgb565", False))
        return orig(*args, **kwargs)

    monkeypatch.setattr(tsf, "advect_kernel", spy)
    st1, frame = T.step_render(st, imp, cfg)
    assert not any(asked)
    ref = T.step(st, imp, cfg)
    assert torch.equal(st1.velocity, ref.velocity)
    assert torch.equal(st1.color.view(torch.int16),
                       ref.color.view(torch.int16))
    want = T.render_rgb565(ref.color, s=1, unit_range=cfg.clamps_dye)
    assert torch.equal(frame.view(torch.int16), want.view(torch.int16))
    # the same config without the feature takes the fused path
    asked.clear()
    T.step_render(st, imp, dataclasses.replace(cfg, advector="semilag",
                                               vorticity_eps=0.0))
    assert asked == [False, True]

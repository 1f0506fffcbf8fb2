"""The port's host-side modules against the JAX package (CPU).

* ``utils/uq32.py`` outputs equal JAX's;
* ``render/upscale.py::decimate_mean`` (d = 1, 2, 3 on 61x81, 17x25 and
  256^2, float32 and bfloat16) equals JAX's, float32 at 0 difference and
  bfloat16 within one bf16 ulp (rtol 2^-7), with the same crop of grids d
  does not divide; ``render_rgbx`` equals JAX's;
* checkpoints cross between the packages: a float32 one both ways, a JAX
  bfloat16 one into the port (JAX's own loader raises on it) with equal
  bits; ``dump_arr`` writes JAX's bytes and sidecar;
* the guarded step, normal and NaN-salted, and ``MetricsLogger``'s rows
  follow JAX at the golden tolerance (rtol 1e-4, atol 2e-4,
  ``tests/test_golden.py:36-41``); the checked step names the stage;
* the native library's ``rgb565_to_rgb888`` equals the JAX package's on
  all 65,536 words, swapped and not;
* ``TouchCalibration.to_grid`` and ``drags_from_touch_trace`` follow JAX
  over a seeded trace of raw touch samples;
* every step factory takes JAX's parameters first, in JAX's order
  (``donate`` included, which has no effect on eager code).
"""

import inspect
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import esp32_fluid_simulation_tpu as J
import esp32_fluid_simulation_tpu_torch as T
from esp32_fluid_simulation_tpu.io_host import native as jnative
from esp32_fluid_simulation_tpu.io_host import touch as jtouch
from esp32_fluid_simulation_tpu.render import upscale as jup
from esp32_fluid_simulation_tpu.utils import checkpoint as jck
from esp32_fluid_simulation_tpu.utils import metrics as jmetrics
from esp32_fluid_simulation_tpu.utils import uq32 as juq
from esp32_fluid_simulation_tpu.utils import watchdog as jwd
from esp32_fluid_simulation_tpu_torch.io_host import native as tnative
from esp32_fluid_simulation_tpu_torch.io_host import touch as ttouch
from esp32_fluid_simulation_tpu_torch.render import upscale as tup
from esp32_fluid_simulation_tpu_torch.utils import checkpoint as tck
from esp32_fluid_simulation_tpu_torch.utils import debug as tdebug
from esp32_fluid_simulation_tpu_torch.utils import metrics as tmetrics
from esp32_fluid_simulation_tpu_torch.utils import uq32 as tuq
from esp32_fluid_simulation_tpu_torch.utils import watchdog as twd
from esp32_fluid_simulation_tpu_torch.interop import (impulses_from_numpy,
                                                      state_from_numpy)

RTOL, ATOL = 1e-4, 2e-4          # tests/test_golden.py:36-41
BF16_ULP = 2.0 ** -7             # one bf16 ulp, relative
SMALL = (17, 25)


def _bits(a):
    """bfloat16 values (either package) as their raw uint16 words."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(a).view(np.uint16)


def _jax_state(state):
    return J.SimState(velocity=jnp.asarray(state.velocity.numpy()),
                      color=jnp.asarray(_color_np(state.color)),
                      step=jnp.asarray(state.step, jnp.int32))


def _color_np(c):
    if c.dtype == torch.bfloat16:
        return _bits(c).view(jnp.bfloat16)
    return c.numpy()


def test_uq32_matches_jax():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.random(4096), [0.0, 0.5, 1.0 - 2 ** -33, 1.0,
                                           -0.25, 1.5]])
    np.testing.assert_array_equal(tuq.float_to_uq32(x), juq.float_to_uq32(x))
    raw = rng.integers(0, 2 ** 32, 4096, dtype=np.uint64).astype(np.uint32)
    np.testing.assert_array_equal(tuq.uq32_to_float(raw),
                                  juq.uq32_to_float(raw))
    for bits in (5, 6):
        np.testing.assert_array_equal(tuq.uq32_top_bits(raw, bits),
                                      juq.uq32_top_bits(raw, bits))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(61, 81), (17, 25), (256, 256)])
@pytest.mark.parametrize("d", [1, 2, 3])
def test_decimate_mean_matches_jax(d, shape, dtype):
    x = np.random.default_rng(d).random((3,) + shape).astype(np.float32)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = tup.decimate_mean(tx, d)
    want = jup.decimate_mean(jnp.asarray(x, getattr(jnp, dtype)), d)
    assert tuple(got.shape) == want.shape == (
        3, shape[0] // d, shape[1] // d)
    assert got.dtype == tx.dtype
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=0 if dtype == "float32" else BF16_ULP,
                               atol=0)


def test_decimate_mean_crops_and_refuses():
    x = np.random.default_rng(5).random((3, 10, 7)).astype(np.float32)
    got = tup.decimate_mean(torch.from_numpy(x), 3)
    want = x[:, :9, :6].reshape(3, 3, 3, 2, 3).mean(axis=(2, 4))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError):
        tup.decimate_mean(torch.from_numpy(x), 11)


@pytest.mark.parametrize("s", [1, 4])
def test_render_rgbx_matches_jax(s):
    x = np.random.default_rng(s).random((3, 13, 17)).astype(np.float32)
    got = tup.render_rgbx(torch.from_numpy(x), s=s)
    assert got.dtype == torch.uint32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jup.render_rgbx(jnp.asarray(x),
                                                             s=s)))


def _stepped(cfg_kw, steps=3):
    """A port state after ``steps`` swirl steps, and its config."""
    cfg = T.SimConfig(**cfg_kw)
    st = T.init_state(cfg, device="cpu")
    step = T.make_step(cfg)
    for t in range(steps):
        st = step(st, ttouch.scripted_swirl(cfg, t, device="cpu"))
    return st, cfg


def test_checkpoint_float32_crosses_both_ways(tmp_path):
    st, cfg = _stepped(dict(shape=SMALL))
    jcfg = J.SimConfig.from_json(cfg.to_json())
    # port -> JAX
    tck.save_checkpoint(str(tmp_path / "port.npz"), st, cfg)
    jst, jcfg2 = jck.load_checkpoint(str(tmp_path / "port.npz"))
    assert jcfg2 == jcfg and int(jst.step) == st.step
    assert jst.step.dtype == jnp.int32
    np.testing.assert_array_equal(np.asarray(jst.velocity),
                                  st.velocity.numpy())
    np.testing.assert_array_equal(np.asarray(jst.color), st.color.numpy())
    # JAX -> port
    jck.save_checkpoint(str(tmp_path / "jax.npz"), jst, jcfg)
    back, cfg2 = tck.load_checkpoint(str(tmp_path / "jax.npz"),
                                     device="cpu")
    assert cfg2 == cfg and back.step == st.step
    assert torch.equal(back.velocity, st.velocity)
    assert torch.equal(back.color, st.color)


def test_checkpoint_bfloat16_from_jax_and_round_trip(tmp_path):
    jcfg = J.SimConfig(shape=SMALL, color_dtype="bfloat16")
    jst = J.init_state(jcfg)
    jst = J.make_step(jcfg, donate=False)(
        jst, jtouch.scripted_swirl(jcfg, 0))
    jck.save_checkpoint(str(tmp_path / "jax.npz"), jst, jcfg)
    with pytest.raises(TypeError):      # the JAX loader's fault
        jck.load_checkpoint(str(tmp_path / "jax.npz"))
    st, cfg = tck.load_checkpoint(str(tmp_path / "jax.npz"), device="cpu")
    assert cfg.color_dtype == "bfloat16" and st.step == 1
    assert st.color.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(st.color), _bits(jst.color))
    np.testing.assert_array_equal(st.velocity.numpy(),
                                  np.asarray(jst.velocity))
    # the port writes the raw words as V2, JAX's bytes, and reads them back
    tck.save_checkpoint(str(tmp_path / "port.npz"), st, cfg)
    with np.load(tmp_path / "port.npz") as z:
        assert z["color"].dtype == np.dtype("V2")
        assert z["step"].dtype == np.int32
        np.testing.assert_array_equal(z["color"].view(np.uint16),
                                      _bits(jst.color))
    again, _ = tck.load_checkpoint(str(tmp_path / "port.npz"), device="cpu")
    assert torch.equal(again.color, st.color) and again.step == 1
    with pytest.raises(ValueError):     # raw words for a float32 config
        tck._from_numpy(np.zeros(2, np.dtype("V2")), "float32", "cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dump_arr_matches_jax(tmp_path, dtype):
    x = np.random.default_rng(7).random((2, 5, 6)).astype(np.float32)
    t = torch.from_numpy(x).to(getattr(torch, dtype))
    tck.dump_arr(str(tmp_path / "t.arr"), t)
    jck.dump_arr(str(tmp_path / "j.arr"), jnp.asarray(x, getattr(jnp, dtype)))
    assert (tmp_path / "t.arr").read_bytes() == (tmp_path / "j.arr").read_bytes()
    assert json.loads((tmp_path / "t.arr.json").read_text()) == json.loads(
        (tmp_path / "j.arr.json").read_text())
    back = tck.load_arr(str(tmp_path / "j.arr"))
    np.testing.assert_array_equal(back, t.float().numpy())


@pytest.mark.parametrize("salted", [False, True])
def test_guarded_step_matches_jax(salted):
    cfg = T.SimConfig(shape=SMALL, sor_iters=6)
    jcfg = J.SimConfig.from_json(cfg.to_json())
    st, _ = _stepped(dict(shape=SMALL, sor_iters=6), steps=2)
    if salted:
        st.velocity[0, 3, 3] = float("nan")
    imp = ttouch.scripted_swirl(cfg, 2, device="cpu")
    jimp = jtouch.scripted_swirl(jcfg, 2)
    out, was_reset = twd.make_guarded_step(cfg, donate=False)(st, imp)
    jout, jreset = jwd.make_guarded_step(jcfg, donate=False)(_jax_state(st),
                                                             jimp)
    assert was_reset.dim() == 0 and was_reset.dtype == torch.bool
    assert bool(was_reset) == bool(jreset) == salted
    assert out.step == int(jout.step) == 3
    np.testing.assert_allclose(out.velocity.numpy(),
                               np.asarray(jout.velocity), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(out.color.numpy(), np.asarray(jout.color),
                               rtol=RTOL, atol=ATOL)
    if salted:
        fresh = T.init_state(cfg, device="cpu")
        assert torch.equal(out.color, fresh.color)
        assert float(out.velocity.abs().max()) == 0.0


def test_metrics_logger_rows_match_jax(tmp_path):
    cfg = T.SimConfig(shape=SMALL, sor_iters=6)
    jcfg = J.SimConfig.from_json(cfg.to_json())
    st = T.init_state(cfg, device="cpu")
    jst = J.init_state(jcfg)
    tfn = T.make_step_with_metrics(cfg, donate=False)
    jfn = J.make_step_with_metrics(jcfg, donate=False)
    tlog = tmetrics.MetricsLogger(str(tmp_path / "t.jsonl"), every=2)
    jlog = jmetrics.MetricsLogger(str(tmp_path / "j.jsonl"), every=2)
    for t in range(6):
        st, m = tfn(st, ttouch.scripted_swirl(cfg, t, device="cpu"))
        jst, jm = jfn(jst, jtouch.scripted_swirl(jcfg, t))
        tlog.log(t + 1, m, extra={"run": "a"})
        jlog.log(t + 1, jm, extra={"run": "a"})
    tlog.close()
    jlog.close()
    rows = [json.loads(line) for line in open(tmp_path / "t.jsonl")]
    assert rows == tlog.history and len(rows) == 3
    for got, want in zip(tlog.history, jlog.history):
        assert set(got) == set(want)
        for k in want:
            if k == "time":
                continue
            assert type(got[k]) is type(want[k]), k
            if isinstance(want[k], float):
                np.testing.assert_allclose(got[k], want[k], rtol=RTOL,
                                           atol=ATOL, err_msg=k)
            else:
                assert got[k] == want[k], k
    assert tmetrics.summarize(tlog.history).keys() == \
        jmetrics.summarize(jlog.history).keys()
    assert tmetrics.summarize([]) == {}


def test_checked_step_names_the_stage():
    cfg = T.SimConfig(shape=SMALL, sor_iters=6)
    st = T.init_state(cfg, device="cpu")
    imp = ttouch.scripted_swirl(cfg, 0, device="cpu")
    checked = tdebug.make_checked_step(cfg)
    err, out = checked(st, imp)
    assert err.get() is None
    err.throw()
    want = T.make_step(cfg)(st, imp)
    torch.testing.assert_close(out.velocity, want.velocity, rtol=RTOL,
                               atol=ATOL)
    assert torch.equal(out.color, want.color)
    bad = st._replace(color=st.color.clone())
    bad.color[1, 4, 4] = float("nan")   # an inf would clamp to 1
    err, _ = checked(bad, imp)
    assert "dye" in err.get()
    with pytest.raises(FloatingPointError, match="dye"):
        err.throw()
    bad = st._replace(velocity=st.velocity.clone())
    bad.velocity[1, 8, 8] = float("nan")
    assert "self-advect" in checked(bad, imp)[0].get()
    with pytest.raises(NotImplementedError):
        tdebug.make_checked_step(T.SimConfig(shape=(32, 32),
                                             domain_tile=(16, 16)))


@pytest.mark.parametrize("swapped", [False, True])
def test_rgb565_to_rgb888_matches_jax_library(swapped):
    words = np.arange(1 << 16, dtype=np.uint16).reshape(256, 256)
    got = tnative.rgb565_to_rgb888(words, swapped=swapped)
    want = jnative.rgb565_to_rgb888(words, swapped=swapped)
    assert got.shape == (256, 256, 3)
    np.testing.assert_array_equal(got, want)


def test_touch_parity_over_a_seeded_trace():
    rng = np.random.default_rng(11)
    trace = [(bool(t), int(x), int(y)) for t, x, y in zip(
        rng.random(400) < 0.7, rng.integers(0, 4096, 400),
        rng.integers(0, 4096, 400))]
    for shape in [(61, 81), (240, 320), (4096, 4096)]:
        cfg = T.SimConfig(shape=shape)
        jcfg = J.SimConfig(shape=shape)
        cal, jcal = ttouch.TouchCalibration(), jtouch.TouchCalibration()
        for _, x, y in trace[:50]:
            assert cal.to_grid(x, y, cfg) == jcal.to_grid(x, y, jcfg)
        drags = ttouch.drags_from_touch_trace(trace, cfg, cal)
        assert drags == jtouch.drags_from_touch_trace(trace, jcfg, jcal)
        assert len(drags) > 100
        imp = ttouch.drags_to_impulses(drags[:cfg.max_impulses], cfg,
                                       device="cpu")
        jimp = jtouch.drags_to_impulses(drags[:cfg.max_impulses], jcfg)
        want = impulses_from_numpy(
            *(np.asarray(x) for x in jimp), device="cpu")
        for a, b in zip(imp, want):
            assert torch.equal(a, b.to(a.dtype))


_FACTORIES = [
    ("models.stable_fluids", "make_step"),
    ("models.stable_fluids", "make_step_render"),
    ("models.stable_fluids", "make_step_with_metrics"),
    ("models.stable_fluids", "make_multi_step"),
    ("models.ensemble", "make_ensemble_step"),
    ("models.ensemble", "make_ensemble_multi_step"),
    ("models.smoke3d", "make_smoke_step"),
    ("parallel.sharded", "make_sharded_step"),
    ("parallel.sharded", "make_sharded_step_with_metrics"),
    ("parallel.sharded3d", "make_sharded_step_3d"),
    ("parallel.sharded_smoke", "make_sharded_smoke_step"),
    ("parallel.sharded_tiled", "make_sharded_tiled_step"),
    ("parallel.sharded_tiled", "make_sharded_ensemble_step"),
    ("utils.watchdog", "make_guarded_step"),
]


@pytest.mark.parametrize("module,name", _FACTORIES)
def test_factory_signatures_follow_jax(module, name):
    import importlib
    jfn = getattr(importlib.import_module(
        f"esp32_fluid_simulation_tpu.{module}"), name)
    tfn = getattr(importlib.import_module(
        f"esp32_fluid_simulation_tpu_torch.{module}"), name)
    jparams = list(inspect.signature(jfn).parameters)
    tparams = list(inspect.signature(tfn).parameters)
    assert tparams[:len(jparams)] == jparams, (jparams, tparams)
    assert "donate" in tparams


def test_positional_calls_reach_jax_parameters():
    """``make_ensemble_step(cfg, False, "vmap")`` takes the member loop, as
    in JAX, where ``donate`` is second."""
    cfg = T.SimConfig(shape=(16, 16), sor_iters=4)
    n = 2
    ens = T.init_ensemble(cfg, n, device="cpu")
    imps = T.stack_impulses([ttouch.scripted_swirl(cfg, 3 * m, device="cpu")
                             for m in range(n)])
    by_position = T.make_ensemble_step(cfg, False, "vmap")(ens, imps)
    by_name = T.make_ensemble_step(cfg, mode="vmap")(ens, imps)
    assert torch.equal(by_position.velocity, by_name.velocity)
    assert torch.equal(by_position.color, by_name.color)
    with pytest.raises(ValueError):          # "bogus" reaches mode
        T.make_ensemble_step(cfg, True, "bogus")
    st = T.init_state(cfg, device="cpu")
    imp = ttouch.scripted_swirl(cfg, 0, device="cpu")
    a = T.make_step_render(cfg, False, False)(st, imp)[1]   # bswap, donate
    b = T.make_step_render(cfg, bswap=False)(st, imp)[1]
    assert torch.equal(a, b)

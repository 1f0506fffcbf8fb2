"""The port's main path as a whole against the JAX package (CPU).

* the reference workload reproduces the golden trajectory at
  test_golden.py's tolerance (rtol 1e-4, atol 2e-4), on the composed path
  and on the kernel configuration (whose wrappers run their plain versions
  on CPU tensors);
* the port's ``render_rgb565`` of the JAX state is pixel-equal to the JAX
  frame;
* ``step_render`` on a 64x128 kernel configuration (test_pallas.py
  :550-573) follows the JAX ``step_render`` (Pallas in interpret mode) for
  3 steps.  Tolerances found: velocity rtol 1e-5 / atol 2e-5; bf16 dye one
  bf16 ulp (rtol 2^-7) — the Pallas kernel's backtrace is contracted into
  an FMA under XLA, and XLA on the CPU flushes the blur's subnormal tail to
  zero (|d| < 2e-38) where PyTorch keeps it; the frames agree wherever the
  stored dye does;
* config JSON, the interop round trip, and the package importing no JAX.
"""

import ast
import functools
import json
import os
import subprocess
import sys
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
from esp32_fluid_simulation_tpu_torch.interop import (
    impulses_from_numpy, state_from_numpy, state_to_numpy, tensor_from_numpy,
    tensor_to_numpy)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "golden" / "ref_61x81_4steps.npz"
PKG = ROOT / "esp32_fluid_simulation_tpu_torch"


def _schedule(t):
    return [((10 + t, 20), (120.0, -60.0)),
            ((30, 40 + t), (-90.0, 150.0)),
            ((45, 60), (50.0, 50.0))]


def _imps(pkg, cfg, t):
    sched = _schedule(t)
    kw = {"device": "cpu"} if pkg is T else {}
    return pkg.Impulses.from_lists(cfg, [p for p, _ in sched],
                                   [v for _, v in sched], **kw)


@pytest.mark.parametrize("kw", [{}, dict(solver="fused_pallas",
                                         advect_impl="pallas")])
def test_port_matches_golden(kw):
    with np.load(GOLDEN) as z:
        want_v, want_c = z["velocity"], z["color"]
    cfg = T.SimConfig(**kw)
    st = T.init_state(cfg, device="cpu")
    fn = T.make_step(cfg)
    for t in range(4):
        st = fn(st, _imps(T, cfg, t))
    assert st.step == 4
    np.testing.assert_allclose(st.velocity.numpy(),
                               np.moveaxis(want_v, -1, 0),
                               rtol=1e-4, atol=2e-4)
    np.testing.assert_allclose(st.color.numpy(),
                               np.clip(np.moveaxis(want_c, -1, 0), 0, 1),
                               rtol=1e-4, atol=2e-4)


def test_render_of_jax_state_is_pixel_equal():
    cfg = J.SimConfig()
    st = J.init_state(cfg)
    fn = J.make_step(cfg, donate=False)
    for t in range(4):
        st = fn(st, _imps(J, cfg, t))
    ported = state_from_numpy(*jax.tree_util.tree_map(np.asarray, st),
                               device="cpu")
    for s in (4, 1):
        want = np.asarray(J.render_rgb565(st.color, s=s))
        got = T.render_rgb565(ported.color, s=s)
        assert got.dtype == torch.uint16
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(T.render_rgb8(ported.color).numpy(),
                                  np.asarray(J.render_rgb8(st.color)))


def test_step_render_kernel_config_follows_jax(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    monkeypatch.setattr(jsf, "_use_pallas_advect", lambda cfg: True)
    kw = dict(shape=(64, 128), scaling=1, solver="fused_pallas",
              advect_impl="pallas", color_dtype="bfloat16",
              advect_max_disp=8)
    jcfg, tcfg = J.SimConfig(**kw), T.SimConfig(**kw)
    jst, tst = jsf.init_state(jcfg), tsf.init_state(tcfg, device="cpu")
    pos = [(5, 7), (20, 40), (20, 40), (99, -3)]
    for t in range(3):
        val = [(30.0, -12.0 + t), (-8.0, 25.0), (99.0, 1.0), (5.0, 5.0)]
        jst, jframe = jsf.step_render(jst, J.Impulses.from_lists(
            jcfg, pos, val), jcfg)
        tst, tframe = T.step_render(tst, T.Impulses.from_lists(
            tcfg, pos, val, device="cpu"), tcfg)
    assert tst.step == 3 and tframe.dtype == torch.uint16
    assert tframe.shape == (63, 127)
    np.testing.assert_allclose(tst.velocity.numpy(), np.asarray(jst.velocity),
                               rtol=1e-5, atol=2e-5)
    jc = np.asarray(jst.color.astype(jnp.float32))
    tc = tst.color.float().numpy()
    np.testing.assert_allclose(tc, jc, rtol=2 ** -7, atol=1e-30)
    same = (tc == jc).all(axis=0)[:-1, :-1]
    np.testing.assert_array_equal(tframe.numpy()[same],
                                  np.asarray(jframe)[same])
    assert (tframe.numpy() == np.asarray(jframe)).mean() > 0.999


def test_fused_step_render_equals_step_then_render():
    """The frame riding the K2 dye store == render_rgb565 of the stepped
    color at s=1, bit for bit (test_pallas.py:550-573 on the port)."""
    cfg = T.SimConfig(shape=(64, 128), scaling=1, solver="fused_pallas",
                      advect_impl="pallas", color_dtype="bfloat16",
                      advect_max_disp=8)
    st = T.init_state(cfg, device="cpu")
    imp = T.Impulses.from_lists(cfg, [(5, 7), (20, 40)],
                                [(30.0, -12.0), (-8.0, 25.0)], device="cpu")
    st2, frame = T.step_render(st, imp, cfg)
    ref = T.step(st, imp, cfg)
    assert torch.equal(st2.velocity, ref.velocity)
    assert torch.equal(st2.color.view(torch.int16),
                       ref.color.view(torch.int16))
    want = T.render_rgb565(ref.color, s=1, unit_range=True)
    assert torch.equal(frame.view(torch.int16), want.view(torch.int16))


def test_apply_impulses_matches_jax(rng):
    """Last active slot wins at a duplicated cell, out-of-range positions
    clamp, inactive slots write nothing."""
    shape = (16, 20)
    vel = rng.normal(0, 5, (2,) + shape).astype(np.float32)
    pos = [(3, 4), (3, 4), (15, 2), (40, -7), (3, 4)]
    val = [(1.0, 2.0), (3.0, 4.0), (5.0, 6.0), (7.0, 8.0), (9.0, 10.0)]
    jimp = J.Impulses.from_lists(J.SimConfig(shape=shape, max_impulses=8),
                                 pos, val)
    jimp = jimp._replace(active=jimp.active.at[4].set(False))
    timp = impulses_from_numpy(*(np.asarray(x) for x in jimp), device="cpu")
    want = np.asarray(jsf.apply_impulses(jnp.asarray(vel), jimp))
    got = tsf.apply_impulses(torch.from_numpy(vel), timp).numpy()
    np.testing.assert_array_equal(got, want)


def test_multi_step_equals_step_loop():
    cfg = T.SimConfig(shape=(24, 32))
    imps = [_imps(T, cfg, t) for t in range(3)]
    st = T.init_state(cfg, device="cpu")
    ref = st
    for imp in imps:
        ref = T.step(ref, imp, cfg)
    got = T.make_multi_step(cfg)(st, T.stack_schedule(imps))
    assert got.step == 3
    assert torch.equal(got.velocity, ref.velocity)
    assert torch.equal(got.color, ref.color)


@pytest.mark.parametrize("kw,item", [
    (dict(shape=(16, 16), advect_impl="pallas",
          advect_sample_dtype="bfloat16"), "Not to port"),
])
def test_unported_features_raise(kw, item):
    cfg = T.SimConfig(**kw)
    st = T.init_state(cfg, device="cpu")
    imp = T.Impulses.none(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match=item):
        T.step(st, imp, cfg)
    with pytest.raises(NotImplementedError, match=item):
        T.make_step_with_metrics(cfg)(st, imp)


@pytest.mark.parametrize("kw", [dict(vorticity_eps=0.5),
                                dict(advector="maccormack")],
                         ids=["vorticity_eps", "maccormack"])
def test_ported_features_follow_jax(kw):
    """Features ported from raising: the step and the metrics step follow
    the JAX package on the reference workload (rtol 1e-4 / atol 2e-4, as
    test_port_matches_golden)."""
    jcfg, tcfg = J.SimConfig(**kw), T.SimConfig(**kw)
    jst, tst = J.init_state(jcfg), T.init_state(tcfg, device="cpu")
    jstep = J.make_step(jcfg, donate=False)
    for t in range(3):
        jst = jstep(jst, _imps(J, jcfg, t))
        tst = T.step(tst, _imps(T, tcfg, t), tcfg)
    np.testing.assert_allclose(tst.velocity.numpy(), np.asarray(jst.velocity),
                               rtol=1e-4, atol=2e-4)
    np.testing.assert_allclose(tst.color.numpy(), np.asarray(jst.color),
                               rtol=1e-4, atol=2e-4)
    st, metrics = T.make_step_with_metrics(tcfg)(tst, _imps(T, tcfg, 3))
    assert st.step == 4 and bool(metrics["finite"])


def test_config_json_round_trip_both_ways():
    for path in sorted((ROOT / "examples").glob("*.json")):
        text = path.read_text()
        jcfg, tcfg = J.SimConfig.from_json(text), T.SimConfig.from_json(text)
        assert json.loads(jcfg.to_json()) == json.loads(tcfg.to_json())
        assert T.SimConfig.from_json(jcfg.to_json()) == tcfg
        assert J.SimConfig.from_json(tcfg.to_json()) == jcfg
    cfg0 = T.SimConfig.from_json(
        (ROOT / "examples" / "config0_4096_production.json").read_text())
    assert cfg0.torch_dtype == torch.float32
    assert cfg0.torch_color_dtype == torch.bfloat16
    assert cfg0.render_shape == (4095, 4095) and cfg0.clamps_dye


def test_interop_bf16_round_trip_is_bitwise(rng):
    bits = rng.integers(0, 1 << 16, size=(3, 7, 9), dtype=np.uint16)
    bits[0, 0, :4] = [0x7FC0, 0xFF80, 0x0001, 0x8000]  # nan, -inf, subnormal, -0
    arr = bits.view(jnp.bfloat16)
    t = tensor_from_numpy(arr, device="cpu")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(tensor_to_numpy(t), bits)
    # a JAX state crosses both ways untouched
    cfg = J.SimConfig(shape=(12, 10), color_dtype="bfloat16")
    st = J.init_state(cfg)
    v, c, step = state_to_numpy(state_from_numpy(
        *jax.tree_util.tree_map(np.asarray, st), device="cpu"))
    np.testing.assert_array_equal(v, np.asarray(st.velocity))
    np.testing.assert_array_equal(c, np.asarray(st.color).view(np.uint16))
    assert step == 0


def test_port_imports_no_jax():
    """The port, its host side and entry points included, imports neither
    JAX nor the JAX package, and loads the native host library from its
    own build directory only."""
    code = ("import sys\n"
            "from pathlib import Path\n"
            "import esp32_fluid_simulation_tpu_torch, "
            "esp32_fluid_simulation_tpu_torch.interop, "
            "esp32_fluid_simulation_tpu_torch.io_host.touch, "
            "esp32_fluid_simulation_tpu_torch.render.cuda_upscale, "
            "esp32_fluid_simulation_tpu_torch.run, "
            "esp32_fluid_simulation_tpu_torch.utils, "
            "esp32_fluid_simulation_tpu_torch.io_host.native, "
            "esp32_fluid_simulation_tpu_torch.io_host.pipeline, "
            "esp32_fluid_simulation_tpu_torch.io_host.server, "
            "esp32_fluid_simulation_tpu_torch.parallel.dcn, "
            "esp32_fluid_simulation_tpu_torch.demo\n"
            "from esp32_fluid_simulation_tpu_torch.io_host import native\n"
            "native.load_library()\n"
            "assert 'jax' not in sys.modules, 'jax imported'\n"
            "assert 'esp32_fluid_simulation_tpu' not in sys.modules, "
            "'the JAX package imported'\n"
            "libs = {Path(line.split()[-1]) for line in "
            "open('/proc/self/maps') if 'libfluidhost' in line}\n"
            "assert libs == {native.LIB_PATH}, libs\n"
            "assert native.LIB_PATH.parent == "
            "Path.cwd() / 'build' / 'native', native.LIB_PATH\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr

    def refused(name):
        top = name.split(".")[0]
        return top == "jax" or top == "esp32_fluid_simulation_tpu"

    for src in list(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]:
        for line in src.read_text().splitlines():
            words = line.replace(",", " ").split()
            if words[:1] == ["import"]:
                names = [w for w in words[1:] if w != "as"]
            elif words[:1] == ["from"] and len(words) > 1:
                names = [words[1]]
            else:
                continue
            assert not any(refused(w) for w in names), (src, line)
        assert "libfluidhost.so" not in src.read_text() or \
            src.name == "native.py", src


def test_ops_and_render_import_no_layer_above():
    """No module under ``ops/`` or ``render/`` imports the models, the mesh,
    the host side, the utilities or the entry points, at its top or inside
    a function: the kernels and their plain versions sit below every
    caller."""
    above = {"models", "parallel", "io_host", "utils", "run", "demo"}
    for src in sorted((PKG / "ops").rglob("*.py")) + sorted(
            (PKG / "render").rglob("*.py")):
        package = src.relative_to(ROOT).parts[:-1]
        for node in ast.walk(ast.parse(src.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name.split(".") for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                base = list(package[:len(package) - node.level + 1]
                            if node.level else [])
                base += node.module.split(".") if node.module else []
                names = [base] if node.module else [base + [a.name]
                                                    for a in node.names]
            else:
                continue
            for name in names:
                assert not (name[0] == PKG.name and len(name) > 1
                            and name[1] in above), (src, node.lineno, name)


def test_chip_smoke_refuses_without_gpu():
    """Without a CUDA device the chip check exits non-zero, printing no
    result (this test only runs where there is none)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode != 0
    assert res.stdout == ""

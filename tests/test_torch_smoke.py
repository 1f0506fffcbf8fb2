"""The port's 3D smoke plume as a whole against the JAX package (CPU).

* ``smoke_step`` on the composed path follows the JAX ``smoke_step`` for 5
  steps at 16^3 (RB-SOR, bf16 and f32 scalars) and 24^3 (multigrid, the
  golden's config), at test_golden_paths.py's tolerance (rtol 1e-4 /
  atol 1e-4).  PyTorch rounds the bf16 source and buoyancy chain after
  every op; the states still agree inside that tolerance with the eager
  JAX step and with the jitted golden.
* the port reproduces ``tests/golden/path_smoke3d.npz`` at that tolerance;
* the port's kernel selection forced on (the wrappers run their plain
  versions on CPU tensors) against the JAX composed path, the CPU oracle
  (JAX never picks its kernels off TPU).  float32 scalars: rtol 1e-4 /
  atol 1e-4.  bf16 scalars: one bf16 ulp (rtol 2^-7) over an absolute
  floor of 1e-4, and the velocity at rtol 1e-4 / atol 1e-4: the plain K7
  interpolates in float32 where the eager op lerps in bf16, which differs
  by a bf16 rounding of values near the plume's front (~1e-4);
* the plume rises (test_models_extra.py:17-34) on the port;
* entry points put state on the card unless told otherwise, and the smoke
  state crosses between the packages bit for bit.
"""

import dataclasses
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import esp32_fluid_simulation_tpu_torch as T
from esp32_fluid_simulation_tpu.models import smoke3d as js
from esp32_fluid_simulation_tpu.render import render_smoke as j_render_smoke
from esp32_fluid_simulation_tpu_torch import interop
from esp32_fluid_simulation_tpu_torch.io_host import touch
from esp32_fluid_simulation_tpu_torch.models import smoke3d as ts

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "path_smoke3d.npz")
STEPS = 5
SOR16 = dict(shape=(16, 16, 16))
MG24 = dict(shape=(24, 24, 24), solver="multigrid", sor_iters=4)


@pytest.fixture(scope="module")
def jax_runs():
    """JAX trajectories by config, computed once per module.  The JAX
    ``smoke_step`` runs op by op: jitting it costs 8-30 s of compile on
    the CPU, the eager ops' compiles are shared between configs."""
    cache = {}

    def run(**kw):
        key = tuple(sorted(kw.items()))
        if key not in cache:
            cfg = js.SmokeConfig(**kw)
            st = js.init_smoke(cfg)
            for _ in range(STEPS):
                st = js.smoke_step(st, cfg)
            cache[key] = jax.tree_util.tree_map(
                lambda x: np.asarray(x, np.float32), st)
        return cache[key]

    return run


def _port_run(kw, steps=STEPS):
    cfg = T.SmokeConfig(**kw)
    st = T.init_smoke(cfg, device="cpu")
    fn = T.make_smoke_step(cfg)
    for _ in range(steps):
        st = fn(st)
    return st


def _assert_close(st, want, **tol):
    np.testing.assert_allclose(st.velocity.numpy(), want[0], **tol)
    np.testing.assert_allclose(st.density.float().numpy(), want[1], **tol)
    np.testing.assert_allclose(st.temperature.float().numpy(), want[2],
                               **tol)


@pytest.mark.parametrize("kw", [SOR16, dict(SOR16, scalar_dtype="float32"),
                                MG24], ids=["sor16", "sor16_f32", "mg24"])
def test_composed_step_follows_jax(jax_runs, kw):
    st = _port_run(kw)
    assert st.step == STEPS
    assert st.density.dtype == T.SmokeConfig(**kw).torch_sdtype
    _assert_close(st, jax_runs(**kw), rtol=1e-4, atol=1e-4)


def test_port_reproduces_golden():
    st = _port_run(MG24)
    with np.load(GOLDEN) as z:
        _assert_close(st, (z["velocity"], z["density"], z["temperature"]),
                      rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("sdtype", ["float32", "bfloat16"])
def test_kernel_selection_plain_versions_follow_jax(jax_runs, monkeypatch,
                                                    sdtype):
    kw = dict(SOR16, scalar_dtype=sdtype)
    for name in ("_use_pallas_advect3d", "_use_pallas_sor3d",
                 "_use_fd3d_kernel"):
        monkeypatch.setattr(ts, name, lambda cfg, vel: True)
    calls = {}

    def spying(name, at):
        orig = getattr(ts, name)

        def spy(*args, **kw):
            # the backtrace must stay inside the CFL clamp for the composed
            # (unclamped) path to be an oracle; ``vel`` is argument ``at``
            # and ``dt`` the next (with bf16 scalars the second call is
            # ``advect3d_source_kernel``)
            calls["disp"] = max(calls.get("disp", 0.0),
                                float(args[at].abs().max()) * args[at + 1])
            calls["n"] = calls.get("n", 0) + 1
            return orig(*args, **kw)

        monkeypatch.setattr(ts, name, spy)

    spying("advect3d_kernel", 1)
    spying("advect3d_source_kernel", 2)
    st = _port_run(kw)
    assert calls["n"] == 2 * STEPS
    assert calls["disp"] < T.SmokeConfig().advect_max_disp
    want = jax_runs(**kw)
    if sdtype == "float32":
        _assert_close(st, want, rtol=1e-4, atol=1e-4)
    else:
        np.testing.assert_allclose(st.velocity.numpy(), want[0], rtol=1e-4,
                                   atol=1e-4)
        for got, w in ((st.density, want[1]), (st.temperature, want[2])):
            np.testing.assert_allclose(got.float().numpy(), w, rtol=2 ** -7,
                                       atol=1e-4)


def test_plume_rises():
    st = _port_run(dict(shape=(32, 24, 24), mg_cycles=1), steps=25)
    rho = st.density.float().numpy()
    assert np.isfinite(rho).all() and rho.max() > 0.05
    src_top = int(0.9 * 32 - 0.08 * 24) - 2
    assert rho[:src_top].sum() > 0.0
    v = st.velocity.numpy()
    assert np.isfinite(v).all()
    assert (v[0] * rho).sum() < 0


def test_source_mask_built_once_per_device(monkeypatch):
    built = []
    orig = ts.source_tensor
    monkeypatch.setattr(ts, "source_tensor",
                        lambda cfg, dev: built.append(dev) or orig(cfg, dev))
    cfg = T.SmokeConfig(shape=(8, 8, 8))
    fn = T.make_smoke_step(cfg)
    st = T.init_smoke(cfg, device="cpu")
    for _ in range(3):
        st = fn(st)
    assert built == [torch.device("cpu")]
    # the mask is built on the device; it equals the JAX package's numpy
    # mask, also where a cell lies exactly on the sphere
    for kw in (dict(shape=(8, 8, 8)),
               dict(shape=(13, 10, 7), source_center=(0.5, 0.3, 0.5),
                    source_radius=5 / 7)):
        np.testing.assert_array_equal(
            orig(T.SmokeConfig(**kw), "cpu").float().numpy(),
            js._source_mask(js.SmokeConfig(**kw)))


def test_smoke_unported_and_bad_configs_raise(jax_runs):
    """``vorticity_eps > 0`` is ported: it follows the JAX step (rtol 1e-4
    / atol 1e-4, as the composed step above); a solver the smoke does not
    have is refused."""
    kw = dict(shape=(8, 8, 8), vorticity_eps=0.5)
    cfg = T.SmokeConfig(**kw)
    _assert_close(_port_run(kw), jax_runs(**kw), rtol=1e-4, atol=1e-4)
    st = T.init_smoke(cfg, device="cpu")
    with pytest.raises(ValueError, match="solver"):
        T.smoke_step(st, dataclasses.replace(cfg, vorticity_eps=0.0,
                                             solver="jacobi"))


def test_render_smoke_of_port_state_follows_jax(jax_runs):
    """The port's MIP of its own 5-step state equals the JAX MIP of the
    JAX state wherever the two densities agree."""
    got = _port_run(SOR16).density
    want = jax_runs(**SOR16)[1]
    frame = interop.tensor_to_numpy(T.render_smoke(got))
    jframe = np.asarray(j_render_smoke(jnp.asarray(want, jnp.bfloat16)))
    same = (got.float().numpy() == want).all(axis=0)
    assert same.mean() > 0.95 and (frame == jframe).mean() > 0.99
    np.testing.assert_array_equal(frame[same], jframe[same])


def test_smoke_state_round_trip_is_bitwise():
    cfg = js.SmokeConfig(shape=(6, 5, 4))
    st = js.init_smoke(cfg)
    st = st._replace(density=st.density + jnp.bfloat16(0.375))
    tst = interop.smoke_state_from_numpy(
        *jax.tree_util.tree_map(np.asarray, st), device="cpu")
    assert tst.density.dtype == torch.bfloat16 and tst.step == 0
    v, d, t, step = interop.smoke_state_to_numpy(tst)
    np.testing.assert_array_equal(v, np.asarray(st.velocity))
    np.testing.assert_array_equal(d, np.asarray(st.density).view(np.uint16))
    np.testing.assert_array_equal(t, np.asarray(st.temperature).view(
        np.uint16))
    assert step == 0


_ENTRY_POINTS = {
    "init_smoke": lambda: T.init_smoke(T.SmokeConfig(shape=(4, 4, 4))),
    "init_state": lambda: T.init_state(T.SimConfig(shape=(8, 8))),
    "Impulses.none": lambda: T.Impulses.none(T.SimConfig()),
    "Impulses.from_lists": lambda: T.Impulses.from_lists(
        T.SimConfig(), [(1, 2)], [(3.0, 4.0)]),
    "scripted_swirl": lambda: touch.scripted_swirl(T.SimConfig(), 0),
    "drags_to_impulses": lambda: touch.drags_to_impulses(
        [((1, 2), (3.0, 4.0))], T.SimConfig()),
    "tensor_from_numpy": lambda: interop.tensor_from_numpy(np.zeros(3)),
    "state_from_numpy": lambda: interop.state_from_numpy(
        np.zeros((2, 4, 4), np.float32), np.zeros((3, 4, 4), np.float32)),
    "impulses_from_numpy": lambda: interop.impulses_from_numpy(
        np.zeros((2, 2), np.int32), np.zeros((2, 2), np.float32),
        np.zeros(2, bool)),
    "smoke_state_from_numpy": lambda: interop.smoke_state_from_numpy(
        *(np.zeros(s, np.float32) for s in ((3, 4, 4, 4), (4, 4, 4),
                                            (4, 4, 4)))),
}


@pytest.mark.parametrize("name", sorted(_ENTRY_POINTS))
def test_entry_points_default_to_the_card(name):
    """Without ``device`` the state goes to CUDA: here, with no card,
    PyTorch raises; on a GPU machine every tensor lies on the card."""
    make = _ENTRY_POINTS[name]
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            make()
        return
    out = make()
    tensors = out if isinstance(out, tuple) else (out,)
    assert all(t.is_cuda for t in tensors if isinstance(t, torch.Tensor))

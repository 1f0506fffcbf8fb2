"""The port's curl and vorticity confinement against the JAX package (CPU).

* ``curl2d``, ``curl3d`` and ``vorticity_confinement`` (2D and 3D) on the
  same numpy-seeded velocities, at test_torch_ops.py's finite-difference
  tolerance (rtol 1e-6 / atol 1e-6; the force divides by ``|grad|w||``, so
  it is compared at rtol 1e-5 / atol 1e-5);
* the 3D smoke step with ``vorticity_eps=2.0`` at 12^3 for 5 steps against
  the JAX ``smoke_step``, at test_golden_paths.py's tolerance (rtol 1e-4 /
  atol 1e-4), as test_torch_smoke.py holds the plume without it;
* the 2D dye-bed step with confinement, on the composed path, against the
  JAX step.
"""

import importlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import esp32_fluid_simulation_tpu as J
import esp32_fluid_simulation_tpu_torch as T
from esp32_fluid_simulation_tpu.models import smoke3d as js

j_fd = importlib.import_module("esp32_fluid_simulation_tpu.ops.fd")
t_fd = importlib.import_module("esp32_fluid_simulation_tpu_torch.ops.fd")

torch.set_num_threads(1)

F = np.float32


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("dx", [1.0, 0.7])
def test_curl2d_matches_jax(rng, dx):
    v = (3 * rng.standard_normal((2, 13, 17))).astype(F)
    np.testing.assert_allclose(t_fd.curl2d(_t(v), dx).numpy(),
                               np.asarray(j_fd.curl2d(jnp.asarray(v), dx)),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dx", [1.0, 0.7])
def test_curl3d_matches_jax(rng, dx):
    v = (3 * rng.standard_normal((3, 6, 9, 11))).astype(F)
    got = t_fd.curl3d(_t(v), dx).numpy()
    assert got.shape == v.shape
    np.testing.assert_allclose(got,
                               np.asarray(j_fd.curl3d(jnp.asarray(v), dx)),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shape", [(13, 17), (6, 9, 11)], ids=["2d", "3d"])
@pytest.mark.parametrize("eps,dx", [(2.0, 1.0), (0.5, 0.7)])
def test_vorticity_confinement_matches_jax(rng, shape, eps, dx):
    v = (20 * rng.standard_normal((len(shape),) + shape)).astype(F)
    got = t_fd.vorticity_confinement(_t(v), eps, 1 / 30, dx).numpy()
    want = np.asarray(j_fd.vorticity_confinement(jnp.asarray(v), eps,
                                                 1 / 30, dx))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert np.abs(got - v).max() > 1e-3


def test_vorticity_confinement_leaves_irrotational_flow_alone():
    """A constant field has no vorticity: the force is zero (the ``tiny``
    keeps the normalisation finite), as test_ops_fd.py:92-95 checks."""
    for shape in ((9, 12), (5, 6, 7)):
        v = torch.full((len(shape),) + shape, 3.0)
        out = t_fd.vorticity_confinement(v, 5.0, 1 / 30)
        assert torch.equal(out, v)


def test_smoke_step_with_vorticity_follows_jax():
    kw = dict(shape=(12, 12, 12), vorticity_eps=2.0)
    jcfg, tcfg = js.SmokeConfig(**kw), T.SmokeConfig(**kw)
    jst = js.init_smoke(jcfg)
    tst = T.init_smoke(tcfg, device="cpu")
    step = T.make_smoke_step(tcfg)
    for _ in range(5):
        jst = js.smoke_step(jst, jcfg)
        tst = step(tst)
    want = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), jst)
    np.testing.assert_allclose(tst.velocity.numpy(), want.velocity,
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tst.density.float().numpy(), want.density,
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tst.temperature.float().numpy(),
                               want.temperature, rtol=1e-4, atol=1e-4)
    # confinement changed the flow (the same run without it differs)
    plain = T.make_smoke_step(T.SmokeConfig(shape=(12, 12, 12)))
    st = T.init_smoke(tcfg, device="cpu")
    for _ in range(5):
        st = plain(st)
    assert (st.velocity - tst.velocity).abs().max() > 1e-4


def test_2d_step_with_vorticity_follows_jax():
    kw = dict(shape=(24, 32), vorticity_eps=2.0, sor_iters=6)
    jcfg, tcfg = J.SimConfig(**kw), T.SimConfig(**kw)
    jst, tst = J.init_state(jcfg), T.init_state(tcfg, device="cpu")
    jstep = J.make_step(jcfg, donate=False)
    for t in range(3):
        pos, val = [(5 + t, 7), (12, 20)], [(90.0, -40.0), (-30.0, 70.0)]
        jst = jstep(jst, J.Impulses.from_lists(jcfg, pos, val))
        tst = T.step(tst, T.Impulses.from_lists(tcfg, pos, val,
                                                device="cpu"), tcfg)
    np.testing.assert_allclose(tst.velocity.numpy(), np.asarray(jst.velocity),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tst.color.numpy(), np.asarray(jst.color),
                               rtol=1e-4, atol=1e-4)

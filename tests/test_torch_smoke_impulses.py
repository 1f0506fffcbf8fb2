"""The 3D smoke plume's drag queue on the port (CPU).

* ``impulses=None`` leaves the step what it is without a queue: the
  closure with no argument, with None and with an all-inactive queue agree
  bit for bit, and follow the JAX composed ``smoke_step`` at
  ``test_torch_smoke.py``'s tolerances, on the composed path and with the
  kernels' plain versions forced;
* ``apply_impulses_`` drains a 3D queue with a repeated cell, a position
  off the grid and inactive slots as the JAX ``apply_impulses`` does (the
  last active slot wins, positions clamped), bit for bit, into the
  velocity's own storage; ``apply_impulses`` still returns a fresh tensor;
* ``smoke_step`` drains into the velocity the advection returned, in
  place, after the source and buoyancy and before the projection: the
  pokes show in the projected velocity, and ``Impulses.from_lists`` takes
  a ``SmokeConfig``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import esp32_fluid_simulation_tpu_torch as T
from esp32_fluid_simulation_tpu.models import smoke3d as js
from esp32_fluid_simulation_tpu.models.stable_fluids import (
    apply_impulses as j_apply_impulses)
from esp32_fluid_simulation_tpu.state import Impulses as JImpulses
from esp32_fluid_simulation_tpu_torch.models import smoke3d as ts
from esp32_fluid_simulation_tpu_torch.models.stable_fluids import (
    apply_impulses, apply_impulses_)

torch.set_num_threads(1)

STEPS = 3
SOR16 = dict(shape=(16, 16, 16))
KERNELS = dict(shape=(12, 14, 10), advect_impl="pallas", sor_impl="pallas")
# a repeated cell (slots 0, 2 and 4: the last active, 2, wins), a
# position off the grid (clamped to its corner), inactive slots (3, 4, 6)
POS = [(3, 4, 5), (-2, 40, 7), (3, 4, 5), (1, 1, 1), (3, 4, 5), (9, 0, 2),
       (2, 2, 2)]
VEL = [(1.0, 2.0, 3.0), (-4.0, 5.0, -6.0), (7.0, -8.0, 9.0),
       (10.0, 11.0, 12.0), (13.0, 14.0, 15.0), (-16.0, 17.0, 18.0),
       (19.0, 20.0, 21.0)]
ACTIVE = [True, True, True, False, False, True, False]


def _queue(k=8):
    n = len(POS)
    pos = torch.zeros((k, 3), dtype=torch.int32)
    vel = torch.zeros((k, 3), dtype=torch.float32)
    act = torch.zeros((k,), dtype=torch.bool)
    pos[:n] = torch.tensor(POS, dtype=torch.int32)
    vel[:n] = torch.tensor(VEL)
    act[:n] = torch.tensor(ACTIVE)
    return T.Impulses(pos=pos, velocity=vel, active=act)


def _field(shape=(10, 12, 9)):
    g = torch.Generator().manual_seed(11)
    return torch.randn((3,) + shape, generator=g)


@pytest.mark.parametrize("kw", [SOR16, KERNELS], ids=["sor16", "kernels"])
def test_no_queue_is_the_plain_step(kw):
    cfg = T.SmokeConfig(**kw)
    fn = T.make_smoke_step(cfg)
    a = b = c = T.init_smoke(cfg, device="cpu")
    none = T.Impulses.none(cfg, device="cpu")
    for _ in range(STEPS):
        a, b, c = fn(a), fn(b, None), fn(c, none)
    for name in ("velocity", "density", "temperature"):
        x = getattr(a, name)
        assert torch.equal(x, getattr(b, name)), name
        assert torch.equal(x, getattr(c, name)), name
    assert a.step == b.step == c.step == STEPS
    # the JAX composed path, the CPU oracle (JAX never picks its kernels
    # off TPU): test_torch_smoke.py's kernel-selection check
    jcfg = js.SmokeConfig(shape=kw["shape"])
    st = js.init_smoke(jcfg)
    for _ in range(STEPS):
        st = js.smoke_step(st, jcfg)
    want = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), st)
    np.testing.assert_allclose(a.velocity.numpy(), want[0], rtol=1e-4,
                               atol=1e-4)
    for got, w in ((a.density, want[1]), (a.temperature, want[2])):
        # the plain K7 interpolates bf16 scalars in float32, the JAX
        # composed path in bf16: one bf16 ulp (test_torch_smoke.py)
        np.testing.assert_allclose(got.float().numpy(), w, rtol=2 ** -7,
                                   atol=1e-4)


def test_drain_3d_in_place_follows_jax():
    vel = _field()
    before = vel.clone()
    imp = _queue()
    ptr = vel.data_ptr()
    out = apply_impulses_(vel, imp)
    assert out is vel and out.data_ptr() == ptr
    jimp = JImpulses(pos=jnp.asarray(imp.pos.numpy()),
                     velocity=jnp.asarray(imp.velocity.numpy()),
                     active=jnp.asarray(imp.active.numpy()))
    want = np.asarray(j_apply_impulses(jnp.asarray(before.numpy()), jimp))
    np.testing.assert_array_equal(out.numpy(), want)
    # by hand: the last active slot at (3, 4, 5), the clamped corner
    assert out[:, 3, 4, 5].tolist() == [7.0, -8.0, 9.0]
    assert out[:, 0, 11, 7].tolist() == [-4.0, 5.0, -6.0]
    assert out[:, 9, 0, 2].tolist() == [-16.0, 17.0, 18.0]
    changed = (out != before).any(dim=0).nonzero().tolist()
    assert sorted(changed) == [[0, 11, 7], [3, 4, 5], [9, 0, 2]]
    # the fresh-tensor form leaves its input alone
    again = apply_impulses(before, imp)
    assert again.data_ptr() != before.data_ptr()
    assert torch.equal(again, out) and not torch.equal(before, out)


def test_step_drains_in_place_before_the_projection(monkeypatch):
    cfg = T.SmokeConfig(**KERNELS)
    fn = T.make_smoke_step(cfg)
    st = T.init_smoke(cfg, device="cpu")
    seen = []
    orig = ts.apply_impulses_

    def spy(vel, imp):
        seen.append(vel.data_ptr())
        out = orig(vel, imp)
        seen.append(out.data_ptr())
        return out

    monkeypatch.setattr(ts, "apply_impulses_", spy)
    imp = T.Impulses.from_lists(cfg, [(6, 7, 5), (6, 3, 3)],
                                [(0.0, 30.0, -30.0), (0.0, -20.0, 10.0)],
                                device="cpu")
    assert imp.pos.shape == (cfg.max_impulses, 3) and cfg.ndim == 3
    stirred = fn(st, imp)
    assert len(seen) == 2 and seen[0] == seen[1]
    plain = fn(st)
    assert len(seen) == 2
    # the pokes reach the projected velocity; the scalars, advected
    # before the drain, do not move
    dv = (stirred.velocity - plain.velocity).abs()
    assert float(dv[1:, 6, 7, 5].max()) > 5.0
    assert torch.equal(stirred.density, plain.density)
    assert torch.equal(stirred.temperature, plain.temperature)

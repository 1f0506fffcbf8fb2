"""The single-device 3D dye bed: the port's ``step`` and
``step_with_metrics`` for a 3D ``SimConfig`` against the JAX package's,
run eagerly (``jax.disable_jit()``), on the same state and impulses (CPU).

Neither package runs a kernel here: JAX's kernel advection and its
single-device ``sor_pallas`` are 2D only.  Shapes follow
tests/test_sharded3d.py: ``(12, 32, 48)``, multigrid ``(16, 32, 64)``, 3
steps with two impulses on the first.  Tolerance rtol 1e-5 / atol 1e-5 on
the fields and the metrics (0 to 3e-8 seen: the eager ops are the same
arithmetic in the same order; confinement's square roots and divisions
may round apart on speeds of ~100).
"""

import dataclasses

import numpy as np
import jax
import pytest
import torch

import esp32_fluid_simulation_tpu as J
from esp32_fluid_simulation_tpu.models import stable_fluids as jsf
from esp32_fluid_simulation_tpu_torch import SimConfig, Impulses, init_state
from esp32_fluid_simulation_tpu_torch.interop import (state_from_numpy,
                                                      state_to_numpy)
from esp32_fluid_simulation_tpu_torch.models import stable_fluids as tsf

torch.set_num_threads(1)

POS = [(6, 16, 24), (3, 8, 40)]
VAL = [(40.0, 90.0, -45.0), (-30.0, -60.0, 120.0)]
TOL = dict(rtol=1e-5, atol=1e-5)


def _cfg(**kw):
    kw.setdefault("shape", (12, 32, 48))
    kw.setdefault("sor_iters", 4)
    kw.setdefault("omega", 1.7)
    return SimConfig(**kw)


@pytest.mark.parametrize("kw", [
    dict(), dict(advector="rk2"), dict(advector="maccormack"),
    dict(solver="jacobi", sor_iters=12, omega=0.9),
    dict(shape=(16, 32, 64), solver="multigrid", mg_cycles=2),
    dict(vorticity_eps=2.0)],
    ids=["semilag", "rk2", "maccormack", "jacobi", "multigrid",
         "vorticity"])
@pytest.mark.parametrize("metrics", [False, True], ids=["step", "metrics"])
def test_dyebed3d_follows_jax(kw, metrics):
    cfg = _cfg(**kw)
    jcfg = J.SimConfig(**dataclasses.asdict(cfg))
    st = init_state(cfg, device="cpu")
    jst = J.init_state(jcfg)
    np.testing.assert_array_equal(st.color.numpy(), np.asarray(jst.color))
    fn = tsf.step_with_metrics if metrics else tsf.step
    jfn = jsf.step_with_metrics if metrics else jsf.step
    for t in range(3):
        imp, jimp = ((Impulses.from_lists(cfg, POS, VAL, device="cpu"),
                      J.Impulses.from_lists(jcfg, POS, VAL)) if t == 0 else
                     (Impulses.none(cfg, device="cpu"),
                      J.Impulses.none(jcfg)))
        out = fn(st, imp, cfg)
        with jax.disable_jit():
            jout = jfn(jst, jimp, jcfg)
        (st, m), (jst, jm) = ((out, jout) if metrics
                              else ((out, {}), (jout, {})))
        assert set(m) == set(jm)
        for key in m:
            np.testing.assert_allclose(float(m[key]), float(jm[key]), **TOL,
                                       err_msg=key)
    assert st.velocity.shape == (3,) + cfg.shape and st.step == 3
    assert float(st.velocity.abs().max()) > 1.0
    np.testing.assert_allclose(st.velocity.numpy(), np.asarray(jst.velocity),
                               **TOL)
    np.testing.assert_allclose(st.color.numpy(), np.asarray(jst.color),
                               **TOL)


@pytest.mark.parametrize("color_dtype", ["float32", "bfloat16"])
def test_dyebed3d_state_round_trip_is_bitwise(color_dtype):
    """A 3D ``SimState`` from JAX through ``interop`` and back, bit for bit
    (bf16 as its raw bits)."""
    jcfg = J.SimConfig(shape=(6, 10, 14), color_dtype=color_dtype)
    jst = J.init_state(jcfg)
    jst = jst._replace(velocity=jst.velocity.at[1, 2, 3, 4].set(7.25))
    st = state_from_numpy(*(np.asarray(x) for x in jst), device="cpu")
    assert st.velocity.shape == (3, 6, 10, 14)
    assert st.color.dtype == getattr(torch, color_dtype)
    v, c, step = state_to_numpy(st)
    np.testing.assert_array_equal(v, np.asarray(jst.velocity))
    want_c = np.asarray(jst.color)
    if color_dtype == "bfloat16":
        want_c = want_c.view(np.uint16)
    np.testing.assert_array_equal(c, want_c)
    assert int(step) == int(jst.step)

"""The port's multi-process mesh (``parallel/dcn.py`` on
``torch.distributed``) against the port's single-process steps and the JAX
package (CPU, gloo).

Two processes of 4 positions each form one 2x4 mesh over a 32x64 grid
(``sor_iters=4``, the CFL clamp at 3 cells), as ``tests/test_dcn.py`` runs
JAX's, stepped 3 times by ``scripted_swirl`` at 60 cells/s; the eager
route, the kernel route, multigrid (its coarse ladder gathered across the
processes) and ``with_metrics``, and the eager route on four processes of
two positions (each mesh row split between two processes).  Tolerances,
each with its reason:

* in each child, its blocks against the port's single-device ``make_step``
  at atol 1e-4 (JAX's ``dcn.py:98-108``); on the kernel route (K1 and K2
  in block mode, through their plain versions here) at 0: a shard's cells
  equal the single-device kernel step's to the bit
  (``parallel/sharded.py``);
* in the parent, the stitched blocks against the same steps on the port's
  single-process 2x4 mesh bit for bit (the same arithmetic per block: only
  the transport differs), and against JAX's ``step`` on the same inputs
  at rtol 1e-4 / atol 1e-4 (``tests/test_golden.py:36-41``'s rtol, JAX's
  dcn atol);
* the mesh metrics against the single-process mesh's: the maxima and
  ``finite`` equal, the residual's l2 at rtol 1e-6 (its sum of squares
  associates over the processes in another order);
* the 3D dye bed (multigrid, its coarse ladder gathered across the
  processes, with the metrics; and K7 block + the K9 block chain), the 3D
  smoke plume (eager, and K7 block + the K9 block chain) and the sharded
  tiled ensemble (``tests/dcn_models_worker.py``), each gathered whole in
  every process, against the single-process mesh's bit for bit, the
  metrics as above.

Each dryrun starts two Python processes (~4 s); a failing child makes
``run_dcn_dryrun`` raise ``RuntimeError`` with its output.
"""

import inspect
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import dcn_models_worker
import esp32_fluid_simulation_tpu as J
from esp32_fluid_simulation_tpu.io_host.touch import (
    scripted_swirl as jscripted_swirl)
from esp32_fluid_simulation_tpu_torch import SimConfig, init_state
from esp32_fluid_simulation_tpu_torch.io_host.touch import scripted_swirl
from esp32_fluid_simulation_tpu_torch.parallel import (
    make_mesh, make_sharded_step, shard_state, unshard_state)
from esp32_fluid_simulation_tpu_torch.parallel import dcn
from esp32_fluid_simulation_tpu_torch.parallel.dcn import (SWIRL_SPEED,
                                                           dcn_results,
                                                           run_dcn_dryrun)

torch.set_num_threads(1)

SHAPE, STEPS = (32, 64), 3
BASE = dict(shape=SHAPE, sor_iters=4, advect_max_disp=3)
TIMEOUT = 120.0
ROOT = Path(__file__).resolve().parent.parent
# name: (config fields, child atol, with_metrics, processes)
CASES = {
    "fused_pallas": (dict(solver="fused_pallas", advect_impl="pallas"), 0.0,
                     False, 2),
    "multigrid": (dict(solver="multigrid"), 1e-4, False, 2),
    "with_metrics": ({}, 1e-4, True, 2),
    # 4 processes of 2 positions: the y exchanges cross processes too
    "four_processes": ({}, 1e-4, False, 4),
}


def _stitch(out_dir, n_procs, prefix="velocity"):
    """The whole field from the children's ``rank<r>.npz`` blocks, and
    each rank's metrics."""
    blocks, metrics = {}, []
    for r in range(n_procs):
        with np.load(out_dir / f"rank{r}.npz") as z:
            metrics.append({k[len("metric_"):]: z[k] for k in z.files
                            if k.startswith("metric_")})
            for k in z.files:
                if k.startswith(prefix + "_"):
                    a, b = map(int, k.split("_")[1:])
                    blocks[(a, b)] = z[k]
    nx = 1 + max(a for a, _ in blocks)
    ny = 1 + max(b for _, b in blocks)
    whole = np.concatenate([np.concatenate([blocks[(a, b)]
                                            for b in range(ny)], axis=-1)
                            for a in range(nx)], axis=-2)
    return whole, metrics


def _single_process(cfg, with_metrics=False):
    """The same steps on the port's single-process 2x4 mesh."""
    mesh = make_mesh(["cpu"] * 8, grid_shape=(2, 4))
    fn = make_sharded_step(cfg, mesh, with_metrics=with_metrics)
    st = shard_state(init_state(cfg, device="cpu"), cfg, mesh)
    metrics = None
    for t in range(STEPS):
        st = fn(st, scripted_swirl(cfg, t, speed=SWIRL_SPEED, device="cpu"))
        if with_metrics:
            st, metrics = st
    return unshard_state(st, "cpu"), metrics


def _dryrun(tmp_path, cfg=None, n=2, **kw):
    out = run_dcn_dryrun(num_processes=n, devices_per_process=8 // n,
                         steps=STEPS, timeout=TIMEOUT, cfg=cfg,
                         out_dir=str(tmp_path), device="cpu", **kw)
    ok = [ln for ln in out.splitlines() if "sharded steps" in ln]
    assert len(ok) == n
    for ln in ok:
        assert f"over a 2x4 mesh spanning {n} processes OK" in ln
    res = dcn_results(out)
    assert [r["device"] for r in res] == ["cpu"] * n
    assert not any(r["host_staged"] for r in res)
    # the wrappers count launches of their CUDA kernels only
    assert all(k == 0 for r in res for k in r["launches"].values())
    return out


def test_two_process_mesh_matches_single_device_and_jax(tmp_path):
    _dryrun(tmp_path)
    vel, _ = _stitch(tmp_path, 2, "velocity")
    col, _ = _stitch(tmp_path, 2, "color")
    cfg = SimConfig(**BASE)
    single, _ = _single_process(cfg)
    assert np.array_equal(vel, single.velocity.numpy())
    assert np.array_equal(col, single.color.numpy())

    jcfg = J.SimConfig(**BASE)
    jst = J.init_state(jcfg)
    jstep = J.make_step(jcfg, donate=False)
    for t in range(STEPS):
        jst = jstep(jst, jscripted_swirl(jcfg, t, speed=SWIRL_SPEED))
    np.testing.assert_allclose(vel, np.asarray(jst.velocity), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(col, np.asarray(jst.color), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("case", list(CASES))
def test_process_mesh_routes_match_single_process_mesh(tmp_path, case):
    kw, atol, with_metrics, n = CASES[case]
    cfg = SimConfig(**BASE, **kw)
    _dryrun(tmp_path, cfg, n, atol=atol, with_metrics=with_metrics)
    vel, metrics = _stitch(tmp_path, n, "velocity")
    col, _ = _stitch(tmp_path, n, "color")
    single, want = _single_process(cfg, with_metrics)
    assert np.array_equal(vel, single.velocity.numpy())
    assert np.array_equal(col, single.color.numpy())
    if not with_metrics:
        assert metrics == [{}] * n
        return
    for got in metrics:
        assert set(got) == set(want)
        for key in ("div_pre_max", "div_post_max", "max_speed", "finite"):
            assert got[key] == want[key].numpy(), key
        np.testing.assert_allclose(got["poisson_residual_l2"],
                                   want["poisson_residual_l2"].numpy(),
                                   rtol=1e-6, atol=0)


@pytest.mark.parametrize("case", ["nccl_without_cards",
                                  "mesh_does_not_divide_grid"])
def test_child_failure_raises_with_its_output(case):
    """``nccl`` asked for on a host with fewer cards than processes, and a
    process count whose 2x3 mesh does not divide the 32x64 grid: the
    children fail, and the parent raises with their output."""
    if case == "nccl_without_cards":
        n = torch.cuda.device_count() + 1
        kw = dict(num_processes=n, devices_per_process=1, backend="nccl",
                  device="cuda")
        want = "nccl needs a card per process"
    else:
        kw = dict(num_processes=3, devices_per_process=2,
                  device="cpu", cfg=SimConfig(**BASE))
        want = "not divisible by mesh"
    with pytest.raises(RuntimeError, match="dcn child") as err:
        run_dcn_dryrun(steps=1, timeout=TIMEOUT, **kw)
    assert want in str(err.value)
    assert "--- dcn child 0 output ---" in str(err.value)


def test_entry_points_default_to_the_card(monkeypatch):
    """The worker, the dryrun and the command line put the blocks on the
    card unless the caller asks for the CPU; with no card visible the
    default raises and does not fall back to the CPU."""
    for fn in (dcn.dcn_worker_body, run_dcn_dryrun):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    seen = {}
    monkeypatch.setattr(dcn, "dcn_worker_body",
                        lambda *a, **kw: seen.update(kw))
    dcn.main(["0", "2", "0"])
    assert (seen["backend"], seen["device"]) == ("gloo", "cuda")
    if torch.cuda.device_count() == 0:
        with pytest.raises(RuntimeError, match="no CUDA device is visible"):
            dcn._process_device(0, 2, "gloo", "cuda")
    else:
        assert dcn._process_device(1, 2, "gloo", "cuda").type == "cuda"
    assert dcn._process_device(1, 2, "gloo", "cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="nccl carries CUDA tensors only"):
        dcn._process_device(0, 2, "nccl", "cpu")


def test_3d_and_tiled_steps_across_processes(tmp_path):
    """The 3D and tiled sharded steps inherit the process-aware layout,
    exchanges, gathers and metrics: two gloo processes of 4 positions run
    ``dcn_models_worker.models`` on one 2x4 mesh and gather every result
    whole."""
    worker = Path(__file__).with_name("dcn_models_worker.py")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(r), "2", str(tmp_path / "store"),
         str(tmp_path)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], outs
    want = dcn_models_worker.models(make_mesh(["cpu"] * 8,
                                              grid_shape=(2, 4)))
    for r in range(2):
        with np.load(tmp_path / f"rank{r}.npz") as z:
            assert sorted(z.files) == sorted(want)
            for key, w in want.items():
                if key.endswith("poisson_residual_l2"):
                    np.testing.assert_allclose(z[key], w, rtol=1e-6, atol=0)
                else:
                    assert np.array_equal(z[key], w), key

"""The 3D and tiled sharded steps of the port across processes: one child
of ``tests/test_torch_dcn.py::test_3d_and_tiled_steps_across_processes``.

    python tests/dcn_models_worker.py RANK N STORE OUT_DIR

joins a gloo group of N processes through a ``FileStore`` at STORE, runs
``models`` on a 2x4 mesh over every process's CPU positions, and writes
the whole (gathered) results to ``OUT_DIR/rank<RANK>.npz``.  The test runs
``models`` on a single-process 2x4 mesh and compares.  Imports torch and
the port only, so a child starts in a few seconds.
"""

import datetime
import sys

import numpy as np
import torch
import torch.distributed as dist

from esp32_fluid_simulation_tpu_torch import (Impulses, SimConfig,
                                              SmokeConfig, init_ensemble,
                                              init_smoke, init_state,
                                              stack_impulses)
from esp32_fluid_simulation_tpu_torch.io_host.touch import scripted_swirl
from esp32_fluid_simulation_tpu_torch.parallel import (
    make_process_mesh, make_sharded_ensemble_step, make_sharded_smoke_step,
    make_sharded_step, shard_smoke_state, shard_state, unshard_smoke_state,
    unshard_state)

POS3 = [(3, 16, 24), (5, 8, 40)]
VAL3 = [(20.0, 45.0, -30.0), (-15.0, -30.0, 40.0)]
STEPS = 2

# the 3D dye bed's routes: (name, config fields, with_metrics)
BEDS = (("bed3d_mg", dict(solver="multigrid"), True),
        ("bed3d_kernel", dict(solver="sor_pallas", advect_impl="pallas"),
         False))
# the smoke plume's: eager, and K7 block + the K9 block chain
SMOKES = (("smoke", {}), ("smoke_kernel", dict(advect_impl="pallas",
                                               sor_impl="pallas")))


def models(mesh):
    """The 3D dye bed (multigrid with the metrics; K7 block + the K9 block
    chain), the 3D smoke plume (eager; kernel routes) and the sharded tiled
    ensemble on ``mesh``, each gathered whole; a dict of float32 numpy
    arrays.  The kernel routes run their plain versions on the CPU."""
    out = {}
    for name, kw, with_metrics in BEDS:
        cfg = SimConfig(shape=(8, 32, 64), sor_iters=4, advect_max_disp=3,
                        **kw)
        fn = make_sharded_step(cfg, mesh, with_metrics=with_metrics)
        st = shard_state(init_state(cfg, device="cpu"), cfg, mesh)
        imp = Impulses.from_lists(cfg, POS3, VAL3, device="cpu")
        for _ in range(STEPS):
            st = fn(st, imp)
            if with_metrics:
                st, metrics = st
                for k, v in metrics.items():
                    out[f"{name}_metric_{k}"] = v
        st = unshard_state(st, "cpu")
        out[f"{name}_velocity"], out[f"{name}_color"] = st.velocity, st.color

    for name, kw in SMOKES:
        scfg = SmokeConfig(shape=(8, 32, 64), sor_iters=4,
                           scalar_dtype="float32", **kw)
        fn = make_sharded_smoke_step(scfg, mesh)
        sm = shard_smoke_state(init_smoke(scfg, device="cpu"), scfg, mesh)
        for _ in range(STEPS):
            sm = fn(sm)
        sm = unshard_smoke_state(sm, "cpu")
        out[f"{name}_velocity"] = sm.velocity
        out[f"{name}_density"] = sm.density
        out[f"{name}_temperature"] = sm.temperature

    member = SimConfig(shape=(16, 16), sor_iters=3)
    n = 8   # a 2x4 member grid, one member a shard
    fn, _ = make_sharded_ensemble_step(member, mesh, n)
    ens = init_ensemble(member, n, device="cpu")
    for t in range(STEPS):
        ens = fn(ens, stack_impulses([
            scripted_swirl(member, 7 * m + t, speed=60.0, device="cpu")
            for m in range(n)]))
    out["ensemble_velocity"], out["ensemble_color"] = ens.velocity, ens.color
    return {k: v.float().numpy() for k, v in out.items()}


def main(rank, n, store, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=n, rank=rank,
                            timeout=datetime.timedelta(seconds=60))
    try:
        mesh = make_process_mesh(["cpu"] * (8 // n), grid_shape=(2, 4))
        np.savez(f"{out_dir}/rank{rank}.npz", **models(mesh))
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])

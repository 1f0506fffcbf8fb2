"""Roofline estimator: the speed-of-light step time of a config on a GPU
(counterpart of ``esp32_fluid_simulation_tpu/utils/roofline.py``).

The simulation is bound by device-memory bandwidth (stencils and gathers
do a handful of flops per float), so the roofline is bytes per step over
the memory rate.  ``step_traffic_bytes`` itemizes the per-step traffic of
each stage under the two implementation paths, with the JAX package's
bytes stage by stage: they model the TPU kernels' tiles, halo re-reads
included (``halo_overlap``).  ``chip_smoke.py``'s ``bound()`` counts the
port's own kernels instead, by the tensors each one reads and writes.

Composed path: every op round-trips its operands through device memory.
Fused-kernel path: advection reads field + velocity once and writes once
(plus the halo-overlap factor); the fused projection reads the velocity
window once and writes velocity + pressure; the render writes only uint16
pixels.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

from ..config import SimConfig


@dataclasses.dataclass(frozen=True)
class GpuSpec:
    name: str
    hbm_gbps: float          # device-memory bandwidth, GB/s
    f32_tflops: float        # float32 outside the tensor cores, TFLOP/s


# NVIDIA's data sheet, H100 SXM at its 700 W power limit: 3.35 TB/s of
# HBM3, 67 TFLOP/s float32 outside the tensor cores
GPU_SPECS = {
    "h100": GpuSpec("h100", 3350.0, 67.0),
}


def _bytes(cfg: SimConfig, channels: int = 1) -> int:
    n = 1
    for s in cfg.shape:
        n *= s
    itemsize = 2 if cfg.dtype == "bfloat16" else 4
    return n * channels * itemsize


def step_traffic_bytes(cfg: SimConfig, fused: bool) -> Dict[str, float]:
    """Estimated device-memory bytes per step, itemized per stage (the TPU
    kernels' model: see the module docstring)."""
    nd = cfg.ndim
    vel = _bytes(cfg, nd)
    scal = _bytes(cfg, 1)
    col_item = 2 if cfg.color_dtype == "bfloat16" else 4
    col = _bytes(cfg, 3) * col_item // (2 if cfg.dtype == "bfloat16" else 4)
    halo_overlap = 1.15  # tile halo re-reads in the fused kernels

    t = {}
    if fused:
        # kernel advect: read vel (backtrace input) + field window + write
        t["advect_vel"] = (vel + vel * halo_overlap + vel)
        t["advect_color"] = (vel + col * halo_overlap + col)
        # fused projection: read vel window, write vel + pressure
        t["projection"] = vel * halo_overlap + vel + scal
    else:
        # composed: advect does gather reads ~4 corners amortized to ~2x
        t["advect_vel"] = vel * 3 + vel
        t["advect_color"] = vel + col * 3 + col
        # divergence (r vel, w div) + 2*iters half-sweeps (r p,d; w p) + grad
        t["projection"] = (vel + scal) \
            + 2 * cfg.sor_iters * (3 * scal) + (vel + scal + vel)
    # render: read color (+ write uint16 pixels)
    px = 1
    for s in cfg.render_shape:
        px *= s
    t["render"] = col * (halo_overlap if fused else 2.5) + px * 2
    return t


def speed_of_light(cfg: SimConfig, gpu: str = "h100",
                   fused: bool = True) -> Dict[str, float]:
    """Ideal step time / FPS on ``gpu`` for this config."""
    spec = GPU_SPECS[gpu]
    traffic = step_traffic_bytes(cfg, fused)
    total = sum(traffic.values())
    ms = total / (spec.hbm_gbps * 1e9) * 1e3
    return {
        "gpu": gpu,
        "fused": fused,
        "bytes_per_step": total,
        "ideal_ms_per_step": ms,
        "ideal_fps": 1e3 / ms if ms > 0 else float("inf"),
        "per_stage_bytes": traffic,
    }

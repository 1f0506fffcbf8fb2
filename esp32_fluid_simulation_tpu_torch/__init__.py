"""esp32_fluid_simulation_tpu_torch — the PyTorch + CUDA port of
``esp32_fluid_simulation_tpu`` for one NVIDIA H100.

It mirrors the JAX package file for file (each module names its
counterpart by path); the JAX package stays the reference it is tested
against.  Plain tensor code is PyTorch; the TPU's Pallas kernels on the
main path are hand-written CUDA kernels under ``csrc/`` (``ops/cuda``,
``render/cuda_upscale.py``, ``render/cuda_smoke.py``), built at first use.
Every entry point that creates state puts it on the card (``"cuda"``)
unless the caller names another device.  Layout:

  L0  array conventions      channels-first tensors (``state.py``)
  L2  numerical ops          ``ops/`` (advect, fd, poisson, cuda kernels)
  L3  application runtime    ``models/`` step functions (the 2D dye bed,
                             its ensembles and tiled domains, the 3D smoke
                             plume), ``render/``,
                             ``io_host/`` touch input, ``parallel/``
                             single-process meshes (the sharded steps)
  L4  host side and entry    ``utils/`` (checkpoints, metrics, watchdog,
      points                 debug step), ``native/`` + ``io_host/native``
                             (the C++ host runtime), ``io_host/pipeline``
                             and ``io_host/server`` (the three-thread
                             pipeline, the web shell), ``run`` (the
                             headless runner), ``demo``
"""

from .config import SimConfig, reference_config
from .state import SimState, Impulses
from .models import (init_state, step, make_step, step_render,
                     make_step_render, step_with_metrics,
                     make_step_with_metrics,
                     make_multi_step, stack_schedule, init_ensemble,
                     stack_impulses, make_ensemble_step,
                     make_ensemble_multi_step, tiled_ensemble_config,
                     tiled_member_impulses, SmokeConfig, SmokeState,
                     init_smoke, smoke_step, make_smoke_step)
from .render import render_rgb565, render_rgb8, render_smoke

__version__ = "0.1.0"

__all__ = [
    "SimConfig",
    "reference_config",
    "SimState",
    "Impulses",
    "init_state",
    "step",
    "make_step",
    "step_render",
    "make_step_render",
    "step_with_metrics",
    "make_step_with_metrics",
    "make_multi_step",
    "stack_schedule",
    "init_ensemble",
    "stack_impulses",
    "make_ensemble_step",
    "make_ensemble_multi_step",
    "tiled_ensemble_config",
    "tiled_member_impulses",
    "render_rgb565",
    "render_rgb8",
    "SmokeConfig",
    "SmokeState",
    "init_smoke",
    "smoke_step",
    "make_smoke_step",
    "render_smoke",
]

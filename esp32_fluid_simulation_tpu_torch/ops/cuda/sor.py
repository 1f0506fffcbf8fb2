"""K4: the whole 2D red-black SOR pressure solve on the GPU
(``csrc/sor.cu``).

Replaces ``esp32_fluid_simulation_tpu/ops/pallas/sor.py:sor_solve_pallas``
(single device; its ``member=`` mode is K6, its block mode K11).
``sor_solve_kernel`` launches the CUDA kernels for CUDA tensors and runs
``sor_solve_reference``, its plain PyTorch version (``ops.poisson.
sor_solve``: zero init, even parity first, the same neighbour order and
``-1/a_ii`` LUT), for CPU tensors — only because they lie on the CPU.  Any
other device raises.  The half-sweep is K1's (``csrc/rb2d.cuh``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..poisson import sor_solve
from .build import load, stream_of

_UNPORTED = {"member": "K6, ROADMAP.md queue 1 item 8",
             "global_offset": "K11, ROADMAP.md queue 1 item 10",
             "global_shape": "K11, ROADMAP.md queue 1 item 10",
             "halo": "K11, ROADMAP.md queue 1 item 10"}


def sor_solve_reference(d, dx=1.0, iters=10, omega=1.96):
    """Plain PyTorch version: ``ops.poisson.sor_solve`` in 2D."""
    return sor_solve(d, dx, iters, omega)


def sor_solve_kernel(d: torch.Tensor, dx: float = 1.0, iters: int = 10,
                     omega: float = 1.96, **unported) -> torch.Tensor:
    """Pressure ``p`` with ``lap(p) = d`` after ``iters`` red-black SOR
    sweeps from zero, for an ``[H, W]`` float32 ``d``."""
    for key, value in unported.items():
        if key not in _UNPORTED:
            raise TypeError(f"sor_solve_kernel got an unexpected argument "
                            f"{key!r}")
        # None and the JAX default halo=0 mean "not asked for"
        if value is not None and not (key == "halo" and value == 0):
            raise NotImplementedError(f"sor_solve_kernel: {key}= is not "
                                      f"ported yet ({_UNPORTED[key]})")
    if d.device.type == "cpu":
        return sor_solve_reference(d, dx, iters, omega)
    if not d.is_cuda:
        raise ValueError(f"sor_solve_kernel: unsupported device {d.device}")
    if d.dim() != 2 or d.dtype != torch.float32:
        raise ValueError("sor_solve_kernel: d must be float32 [H, W]")
    if not d.is_contiguous():
        raise ValueError("sor_solve_kernel: d must be contiguous")
    h, w = d.shape
    # the half-sweeps put rows on grid.y, 8 a block, at most 65535 blocks
    if h < 2 or w < 2 or h > 8 * 65535 or iters < 0:
        raise ValueError(f"sor_solve_kernel: shape {tuple(d.shape)} / iters "
                         f"{iters} not supported (2 <= H <= 524280, W >= 2, "
                         "iters >= 0)")
    p = torch.empty_like(d)
    dxd = torch.empty_like(d)
    lib = load()
    with torch.cuda.device(d.device):
        lib.call("fluid_sor", d.data_ptr(), p.data_ptr(), dxd.data_ptr(), h,
                 w, float(dx), int(iters), float(omega),
                 float(np.float32(1.0 - omega)), stream_of(d))
    sor_solve_kernel.launches += 1
    return p


sor_solve_kernel.launches = 0

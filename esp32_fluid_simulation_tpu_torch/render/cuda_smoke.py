"""K10: the smoke MIP render on the GPU (``csrc/smoke_mip.cu``).

Replaces ``esp32_fluid_simulation_tpu/render/pallas_smoke.py:
render_smoke_mip_pallas``.  ``render_smoke_mip_kernel`` launches the CUDA
kernel for CUDA tensors and runs ``render_smoke_mip_reference``, its plain
PyTorch version, for CPU tensors — only because they lie on the CPU.  Any
other device raises.

NaN rule (both versions, and the JAX ``render_smoke``): the maximum over
depth propagates NaN, and a NaN pixel packs to 0.

The launch plan (``mip_plan``) is worked out here, in Python, and the
kernel follows it: one launch of ``blocks`` blocks of ``THREADS_X x
SEGMENTS`` threads.  A thread owns ``vec`` adjacent pixels (of the volume
seen as ``[D, H*W]``) and one depth segment of ``seg_len`` planes; the
segments' maxima are combined in shared memory.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .smoke import heat_colormap
from .upscale import pack_rgb565
from ..spans import span
from ..ops.cuda.build import launch
from ..ops.cuda.modes import FLOATS, check_launch

# Launch geometry: pixel groups and depth segments a block, the fastest
# cold at 256^3 bf16 within 1% (tools/torch_k10_mip.py --sweep, PERF.md)
THREADS_X = 32
SEGMENTS = 16
_INT_MAX = 2 ** 31 - 1


class MipPlan(NamedTuple):
    """One K10 launch.  Segment ``s`` covers planes ``[s * seg_len,
    min(D, (s + 1) * seg_len))``, empty once ``s * seg_len >= D``; thread
    ``t`` of the grid (``t = block * threads_x + x``) owns pixels
    ``[t * vec, (t + 1) * vec)`` of the ``H*W``; ``tail`` pixel slots of
    the last block lie past the image and are not written."""
    vec: int
    seg_len: int
    segments: int
    threads_x: int
    blocks: int
    tail: int

    @property
    def route(self) -> str:
        """"vector" (16-byte loads) or "scalar" (one pixel a thread)."""
        return "vector" if self.vec > 1 else "scalar"


def mip_plan(density: torch.Tensor) -> MipPlan:
    """The launch plan for a contiguous ``[D, H, W]`` volume.  16-byte
    loads need the base aligned to 16 bytes and ``H*W`` a multiple of the
    pixels a load carries (else every plane after the first is
    misaligned); otherwise the scalar route."""
    d, h, w = density.shape
    npix = h * w
    vec = 16 // density.element_size()
    if density.data_ptr() % 16 or npix % vec:
        vec = 1
    blocks = -(-npix // (vec * THREADS_X))
    return MipPlan(vec, -(-d // SEGMENTS), SEGMENTS, THREADS_X, blocks,
                   blocks * THREADS_X * vec - npix)


def render_smoke_mip_reference(density, bswap=True, vmax=1.0):
    """Plain PyTorch version: max over axis 0, heat colormap, RGB565."""
    t = torch.amax(density, dim=0).to(torch.float32) * float(
        np.float32(1.0 / vmax))
    return pack_rgb565(heat_colormap(t), bswap=bswap)


def render_smoke_mip_kernel(density: torch.Tensor, bswap: bool = True,
                            vmax: float = 1.0) -> torch.Tensor:
    """``[D, H, W]`` float32/bfloat16 density -> uint16 ``[H, W]`` RGB565
    maximum-intensity projection along axis 0."""
    with span("fluid.k10.mip"):
        if density.device.type == "cpu":
            return render_smoke_mip_reference(density, bswap, vmax)
        if density.dim() != 3:
            raise ValueError("render_smoke_mip_kernel: density must be "
                             "[D, H, W]")
        check_launch("render_smoke_mip_kernel", density=(density, FLOATS))
        d, h, w = density.shape
        plan = mip_plan(density)
        # the grid is one-dimensional, at most 2^31 - 1 blocks
        if (min(d, h, w) < 1 or max(d, h, w) > _INT_MAX
                or plan.blocks > _INT_MAX):
            raise ValueError(f"render_smoke_mip_kernel: shape "
                             f"{tuple(density.shape)} not supported")
        out = torch.empty((h, w), dtype=torch.uint16, device=density.device)
        launch("fluid_smoke_mip", density, density, out, d, h, w,
               int(density.dtype == torch.bfloat16), plan.vec, plan.seg_len,
               plan.threads_x, plan.segments, float(np.float32(1.0 / vmax)),
               int(bswap))
        render_smoke_mip_kernel.launches += 1
        return out


render_smoke_mip_kernel.launches = 0

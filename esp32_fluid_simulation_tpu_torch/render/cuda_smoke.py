"""K10: the smoke MIP render on the GPU (``csrc/smoke_mip.cu``).

Replaces ``esp32_fluid_simulation_tpu/render/pallas_smoke.py:
render_smoke_mip_pallas``.  ``render_smoke_mip_kernel`` launches the CUDA
kernel for CUDA tensors and runs ``render_smoke_mip_reference``, its plain
PyTorch version, for CPU tensors — only because they lie on the CPU.  Any
other device raises.

NaN rule (both versions, and the JAX ``render_smoke``): the maximum over
depth propagates NaN, and a NaN pixel packs to 0.
"""

from __future__ import annotations

import numpy as np
import torch

from .smoke import heat_colormap
from .upscale import pack_rgb565
from ..ops.cuda.build import load, stream_of


def render_smoke_mip_reference(density, bswap=True, vmax=1.0):
    """Plain PyTorch version: max over axis 0, heat colormap, RGB565."""
    t = torch.amax(density, dim=0).to(torch.float32) * float(
        np.float32(1.0 / vmax))
    return pack_rgb565(heat_colormap(t), bswap=bswap)


def render_smoke_mip_kernel(density: torch.Tensor, bswap: bool = True,
                            vmax: float = 1.0) -> torch.Tensor:
    """``[D, H, W]`` float32/bfloat16 density -> uint16 ``[H, W]`` RGB565
    maximum-intensity projection along axis 0."""
    if density.device.type == "cpu":
        return render_smoke_mip_reference(density, bswap, vmax)
    if not density.is_cuda:
        raise ValueError(f"render_smoke_mip_kernel: unsupported device "
                         f"{density.device}")
    if density.dim() != 3:
        raise ValueError("render_smoke_mip_kernel: density must be "
                         "[D, H, W]")
    if density.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"render_smoke_mip_kernel: dtype {density.dtype} "
                         "not supported (float32, bfloat16)")
    if not density.is_contiguous():
        raise ValueError("render_smoke_mip_kernel: density must be "
                         "contiguous")
    d, h, w = density.shape
    # the launch puts rows on grid.y, 8 a block, at most 65535 blocks
    if min(d, h, w) < 1 or h > 8 * 65535:
        raise ValueError(f"render_smoke_mip_kernel: shape "
                         f"{tuple(density.shape)} not supported")
    out = torch.empty((h, w), dtype=torch.uint16, device=density.device)
    lib = load()
    with torch.cuda.device(density.device):
        lib.call("fluid_smoke_mip", density.data_ptr(), out.data_ptr(), d, h,
                 w, int(density.dtype == torch.bfloat16),
                 float(np.float32(1.0 / vmax)), int(bswap),
                 stream_of(density))
    render_smoke_mip_kernel.launches += 1
    return out


render_smoke_mip_kernel.launches = 0

"""K3: fused bilinear upscale + RGB565 pack on the GPU (``csrc/upscale.cu``:
one thread per source cell writes its ``s x s`` patch).

Replaces ``esp32_fluid_simulation_tpu/render/pallas_upscale.py:
render_rgb565_pallas``.  ``render_rgb565_kernel`` launches the CUDA kernel
for CUDA tensors and runs ``render_rgb565_reference``, its plain PyTorch
version, for CPU tensors — only because they lie on the CPU.  Any other
device raises.

``unit_range=True`` asserts the input lies in [0, 1] and lets the kernel
drop the lower clip; it is bit-exact for in-range inputs only, as in the
JAX package.
"""

from __future__ import annotations

import torch

from .upscale import pack_rgb565, upscale_bilinear
from ..spans import span
from ..ops.cuda.build import load, stream_of


def render_rgb565_reference(color, s, bswap=True, unit_range=False):
    """Plain PyTorch version: ``pack_rgb565(upscale_bilinear(color, s))``."""
    del unit_range  # equal on in-range inputs, the only ones it accepts
    return pack_rgb565(upscale_bilinear(color, s), bswap=bswap)


def render_rgb565_kernel(color: torch.Tensor, s: int, bswap: bool = True,
                         unit_range: bool = False) -> torch.Tensor:
    """``[3, H, W]`` float32/bfloat16 -> ``[(H-1)*s, (W-1)*s]`` uint16."""
    with span("fluid.k3.render"):
        if color.device.type == "cpu":
            return render_rgb565_reference(color, s, bswap, unit_range)
        if not color.is_cuda:
            raise ValueError(f"render_rgb565_kernel: unsupported device "
                             f"{color.device}")
        if color.dim() != 3 or color.shape[0] != 3:
            raise ValueError("render_rgb565_kernel: color must be [3, H, W]")
        if color.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"render_rgb565_kernel: dtype {color.dtype} not "
                             "supported (float32, bfloat16)")
        if not color.is_contiguous():
            raise ValueError("render_rgb565_kernel: color must be contiguous")
        _, h, w = color.shape
        # the launch puts source rows on grid.y, 8 a block, at most 65535
        # blocks; s fractions fit the kernel's table
        if not 1 <= s <= 4096 or h < 2 or w < 2 or h - 1 > 8 * 65535:
            raise ValueError(f"render_rgb565_kernel: s={s} on {h}x{w} not "
                             "supported")
        out = torch.empty(((h - 1) * s, (w - 1) * s), dtype=torch.uint16,
                          device=color.device)
        lib = load()
        with torch.cuda.device(color.device):
            lib.call("fluid_render_rgb565", color.data_ptr(), out.data_ptr(),
                     h, w, int(color.dtype == torch.bfloat16), int(s),
                     int(bswap), int(unit_range), stream_of(color))
        render_rgb565_kernel.launches += 1
        return out


render_rgb565_kernel.launches = 0

"""On-device render: separable bilinear upscale + RGB565 pack, and the
stream view's decimation and RGBX pack (counterpart of
``esp32_fluid_simulation_tpu/render/upscale.py``).

The reference's ``draw_routine`` (``.ino:99-191``) upscales the
(H-1)x(W-1) cell grid by incremental separable bilinear interpolation and
packs the top 5/6/5 bits of each channel, byte-swapped for SPI.  The last
node row/column are lerp endpoints only, hence ``((H-1)*s, (W-1)*s)``.
"""

from __future__ import annotations

import numpy as np
import torch


def upscale_bilinear(color: torch.Tensor, s: int) -> torch.Tensor:
    """Bilinear-upsample ``[C, H, W] -> [C, (H-1)*s, (W-1)*s]``: output
    pixel ``(i*s + a, j*s + b)`` blends nodes ``{i,i+1}x{j,j+1}`` at
    fractions ``(a/s, b/s)``, rows first."""
    if s == 1:
        return color[:, :-1, :-1]
    c = color.to(torch.float32)
    ch, h, w = c.shape
    # fractions a/s as IEEE float32 divisions (a tensor-by-scalar divide
    # may multiply by the reciprocal instead)
    t = torch.from_numpy(np.arange(s, dtype=np.float32)
                         / np.float32(s)).to(c.device)
    tr = t[None, None, :, None]
    rows = c[:, :-1, None, :] * (1 - tr) + c[:, 1:, None, :] * tr
    rows = rows.reshape(ch, (h - 1) * s, w)
    tc = t[None, None, None, :]
    out = rows[:, :, :-1, None] * (1 - tc) + rows[:, :, 1:, None] * tc
    return out.reshape(ch, (h - 1) * s, (w - 1) * s)


def pack_rgb565(rgb: torch.Tensor, bswap: bool = True) -> torch.Tensor:
    """Pack ``[3, H, W]`` unit floats to uint16 RGB565: ``floor(c * 2^k)``
    clipped to ``[0, 2^k - 1]`` (truncation equals floor after the clip),
    optionally byte-swapped (``__builtin_bswap16``, ``.ino:173``)."""
    def chan(c, bits):
        q = (c.to(torch.float32) * float(1 << bits)).to(torch.int32)
        return torch.clamp(q, 0, (1 << bits) - 1)

    word = (chan(rgb[0], 5) << 11) | (chan(rgb[1], 6) << 5) | chan(rgb[2], 5)
    if bswap:
        word = ((word << 8) | (word >> 8)) & 0xFFFF
    return word.to(torch.uint16)


def render_rgb565(color: torch.Tensor, s: int = 4, bswap: bool = True,
                  unit_range: bool = False) -> torch.Tensor:
    """Full render: upscale + RGB565 pack.

    Large upscales of CUDA tensors (``s > 1`` and at least 1,000,000 output
    pixels) go to the fused CUDA kernel (``render.cuda_upscale``), which
    writes only the uint16 pixels.  ``unit_range=True`` asserts ``color``
    lies in [0, 1] and lets the kernel drop its lower clip."""
    h, w = color.shape[-2], color.shape[-1]
    if s > 1 and color.is_cuda and (h - 1) * (w - 1) * s * s >= 1_000_000:
        from .cuda_upscale import render_rgb565_kernel
        return render_rgb565_kernel(color, s=s, bswap=bswap,
                                    unit_range=unit_range)
    return pack_rgb565(upscale_bilinear(color, s), bswap=bswap)


def render_rgb8(color: torch.Tensor, s: int = 4) -> torch.Tensor:
    """RGB888 render for host-side demo output (PNG/PPM)."""
    return torch.clamp(torch.floor(upscale_bilinear(color, s) * 256.0),
                       0, 255).to(torch.uint8)


def decimate_mean(color: torch.Tensor, d: int) -> torch.Tensor:
    """d:1 mean-pool of ``[C, H, W]`` for the stream view (the LCD is
    smaller than the sim; the reference upscales, production grids
    downsample), in ``color``'s dtype: the rows summed first, then the
    columns of the halved array, then one multiply by ``1/(d*d)``, as in
    JAX (``render/upscale.py:109-137``).

    Non-divisible dims are cropped to the largest d-multiple first (the
    reference's own 61x81 grid divides by nothing)."""
    if d == 1:
        return color
    _, h, w = color.shape
    hc, wc = (h // d) * d, (w // d) * d
    if hc == 0 or wc == 0:
        raise ValueError(f"decimation {d} exceeds grid {h}x{w}")
    color = color[:, :hc, :wc]
    r = color[:, 0::d]
    for i in range(1, d):
        r = r + color[:, i::d]
    out = r[:, :, 0::d]
    for i in range(1, d):
        out = out + r[:, :, i::d]
    # a 0-dim CPU tensor multiplies a CUDA tensor as a scalar, no copy
    scale = torch.tensor(1.0 / (d * d), dtype=torch.float32).to(out.dtype)
    return out * scale


def render_rgbx(color: torch.Tensor, s: int = 4) -> torch.Tensor:
    """Packed RGBX8888 render: one uint32 a pixel, little-endian
    ``R | G<<8 | B<<16``, the full-color wire format that
    ``io_host.native.jpeg_encode_rgbx`` encodes.  Channel quantization
    matches ``render_rgb8`` exactly (same bytes)."""
    q = torch.clamp(torch.floor(upscale_bilinear(color, s) * 256.0),
                    0, 255).to(torch.int32)
    return (q[0] | (q[1] << 8) | (q[2] << 16)).to(torch.uint32)

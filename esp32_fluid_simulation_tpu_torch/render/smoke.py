"""3D smoke views: axis slice or maximum-intensity projection (MIP), heat
colormap, RGB565/RGB8 pack (counterpart of
``esp32_fluid_simulation_tpu/render/smoke.py``).

The plume's serving shape is a 2D view of the density volume with only the
packed pixels leaving the device, the same contract as the 2D render:

* ``mode="slice"``: one plane ``density[index]`` along ``axis``;
* ``mode="mip"``: the maximum over ``axis`` (NaN-propagating, as
  ``jnp.max`` is).

The view maps through a fire ramp (black -> red -> yellow -> white) and
packs like ``render.upscale.pack_rgb565``.  MIPs along axis 0 of CUDA
tensors with at least 128^2 pixels go to the K10 kernel
(``render.cuda_smoke``), which reads the volume once and writes only the
uint16 pixels.
"""

from __future__ import annotations

import numpy as np
import torch

from ..spans import span
from .upscale import pack_rgb565


def heat_colormap(t: torch.Tensor) -> torch.Tensor:
    """Unit-scale intensity -> ``[3, ...]`` float32 RGB:
    r = clip(3t, 0, 1), g = clip(3t - 1, 0, 1), b = clip(3t - 2, 0, 1)."""
    t = t.to(torch.float32)
    r = torch.clamp(3.0 * t, 0.0, 1.0)
    g = torch.clamp(3.0 * t - 1.0, 0.0, 1.0)
    b = torch.clamp(3.0 * t - 2.0, 0.0, 1.0)
    return torch.stack([r, g, b])


def _view(density: torch.Tensor, mode: str, axis: int, index):
    if mode == "mip":
        return torch.amax(density, dim=axis)
    if mode == "slice":
        n = density.shape[axis]
        return density.select(axis, n // 2 if index is None else index)
    raise ValueError(f"unknown mode {mode!r} (want 'mip' or 'slice')")


def render_smoke(density: torch.Tensor, mode: str = "mip", axis: int = 0,
                 index: int | None = None, fmt: str = "rgb565",
                 bswap: bool = True, vmax: float = 1.0) -> torch.Tensor:
    """``[D, H, W]`` density -> packed 2D view: uint16 ``[H', W']`` for
    ``fmt="rgb565"``, uint8 ``[H', W', 3]`` for ``fmt="rgb8"``.  ``vmax``
    rescales intensities (the density is source-clamped to [0, 1])."""
    with span("fluid.render"):
        if density.dim() != 3:
            raise ValueError(f"density must be [D, H, W], got "
                             f"{tuple(density.shape)}")
        if fmt not in ("rgb565", "rgb8"):
            raise ValueError(f"unknown fmt {fmt!r}")
        if (mode == "mip" and axis == 0 and fmt == "rgb565" and density.is_cuda
                and density.shape[1] * density.shape[2] >= 128 * 128):
            from .cuda_smoke import render_smoke_mip_kernel
            # a view (a transpose, a slice) is copied to the kernel's layout
            return render_smoke_mip_kernel(density.contiguous(), bswap=bswap,
                                           vmax=vmax)
        view = _view(density, mode, axis, index)
        t = view.to(torch.float32) * float(np.float32(1.0 / vmax))
        rgb = heat_colormap(t)
        if fmt == "rgb565":
            return pack_rgb565(rgb, bswap=bswap)
        q = torch.clamp(torch.floor(rgb * 256.0), 0, 255).to(torch.uint8)
        return q.movedim(0, -1).contiguous()

"""K2: 2D semi-Lagrangian advection on the GPU (``csrc/advect.cu``).

Replaces ``esp32_fluid_simulation_tpu/ops/pallas/advect.py:advect_pallas``
(the "sloop" kernel).  ``advect_kernel`` launches the CUDA kernel for CUDA
tensors and runs ``advect_reference``, its plain PyTorch version, for CPU
tensors — only because they lie on the CPU.  Any other device raises.

Semantics (both versions): backtrace ``x - dt*v``; the displacement is
clamped to ``max_disp`` cells per axis (a CFL clamp that the unclamped
``ops.advect.advect`` does not apply); bilinear sample at the domain-clamped
coordinate, computed in float32; the no-slip factor from the unclamped
coordinate; the optional [0, 1] clip; the store in the field dtype; with
``rgb565`` also the ``[H-1, W-1]`` RGB565 frame of the *stored* dye.
"""

from __future__ import annotations

import torch

from ...render.upscale import pack_rgb565
from ..advect import noslip_axis_factor
from .build import load, stream_of

_UNPORTED = ("return_minmax", "overlay", "member", "global_offset",
             "global_shape", "halo", "sample_bf16")


def advect_reference(field, vel, dt, no_slip, max_disp=12, clip01=False,
                     rgb565=False, bswap=True):
    """Plain PyTorch version of the kernel (same arithmetic, same order)."""
    squeeze = field.dim() == 2
    f = (field[None] if squeeze else field).to(torch.float32)
    h, w = f.shape[-2:]
    dev = field.device
    fi = torch.arange(h, dtype=torch.float32, device=dev)[:, None].expand(h, w)
    fj = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(h, w)
    v = vel.to(torch.float32)
    si_raw = fi - v[0] * dt
    sj_raw = fj - v[1] * dt
    si = torch.minimum(torch.maximum(si_raw, fi - max_disp), fi + max_disp)
    sj = torch.minimum(torch.maximum(sj_raw, fj - max_disp), fj + max_disp)
    si = torch.clamp(si, 0.0, h - 1.0)
    sj = torch.clamp(sj, 0.0, w - 1.0)
    i0 = torch.clamp(torch.floor(si), 0.0, h - 2.0)
    j0 = torch.clamp(torch.floor(sj), 0.0, w - 2.0)
    di = si - i0
    dj = sj - j0
    one_m_dj = 1.0 - dj
    ii = i0.long()
    jj = j0.long()
    colv0 = f[:, ii, jj] * one_m_dj + f[:, ii, jj + 1] * dj
    colv1 = f[:, ii + 1, jj] * one_m_dj + f[:, ii + 1, jj + 1] * dj
    acc = colv0 * (1.0 - di) + colv1 * di
    if no_slip:
        acc = acc * (noslip_axis_factor(si_raw, h)
                     * noslip_axis_factor(sj_raw, w))
    if clip01:
        acc = torch.clamp(acc, 0.0, 1.0)
    out = acc.to(field.dtype)
    if rgb565:
        # the frame packs the stored values: clip01 keeps them in [0, 1]
        return out, pack_rgb565(out[:, :-1, :-1], bswap=bswap)
    return out[0] if squeeze else out


def advect_kernel(field: torch.Tensor, vel: torch.Tensor, dt: float,
                  no_slip: bool, max_disp: int = 12, clip01: bool = False,
                  rgb565: bool = False, bswap: bool = True,
                  self_advect: bool = False, **unported):
    """Advect ``field`` (``[C, H, W]`` or ``[H, W]``, float32 or bfloat16)
    through ``vel`` (``[2, H, W]`` float32).  Returns the new field, or
    ``(field, frame)`` with ``rgb565=True`` (a 3-channel field with
    ``clip01``).  ``self_advect=True`` advects the velocity by itself
    (``field`` is the velocity; ``vel`` is ignored) into a fresh tensor."""
    for key in unported:
        if key not in _UNPORTED:
            raise TypeError(f"advect_kernel got an unexpected argument {key!r}")
    if any(v is not None and v is not False for v in unported.values()):
        raise NotImplementedError(
            f"advect_kernel: {sorted(unported)} not ported yet (ROADMAP.md "
            "queue 2, K5/K6/K11)")
    if rgb565 and (not clip01 or field.dim() != 3 or field.shape[0] != 3):
        raise ValueError("rgb565 needs clip01 on a 3-channel field")
    if self_advect:
        if field.dim() != 3 or field.shape[0] != 2:
            raise ValueError("self_advect needs the [2, H, W] velocity as "
                             "field")
        vel = field
    if field.device.type == "cpu":
        return advect_reference(field, vel, dt, no_slip, max_disp=max_disp,
                                clip01=clip01, rgb565=rgb565, bswap=bswap)
    if not field.is_cuda:
        raise ValueError(f"advect_kernel: unsupported device {field.device}")

    f3 = field[None] if field.dim() == 2 else field
    c, h, w = f3.shape
    # the launch puts rows on grid.y, 8 a block, at most 65535 blocks
    if c not in (1, 2, 3) or h < 2 or w < 2 or h > 8 * 65535:
        raise ValueError(f"advect_kernel: field shape {tuple(field.shape)} "
                         "not supported (C <= 3, 2 <= H <= 524280, W >= 2)")
    if f3.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"advect_kernel: field dtype {f3.dtype} not "
                         "supported (float32, bfloat16)")
    if vel.shape != (2, h, w) or vel.dtype != torch.float32:
        raise ValueError("advect_kernel: vel must be float32 [2, H, W]")
    if vel.device != field.device:
        raise ValueError("advect_kernel: field and vel on different devices")
    if not (f3.is_contiguous() and vel.is_contiguous()):
        raise ValueError("advect_kernel: inputs must be contiguous")
    if not 0 <= max_disp < 2 ** 24:
        raise ValueError(f"advect_kernel: max_disp={max_disp} out of range")

    out = torch.empty_like(f3)
    frame = (torch.empty((h - 1, w - 1), dtype=torch.uint16,
                         device=field.device) if rgb565 else None)
    lib = load()
    with torch.cuda.device(field.device):
        lib.call("fluid_advect", f3.data_ptr(), vel.data_ptr(),
                 out.data_ptr(), frame.data_ptr() if rgb565 else None,
                 c, h, w, int(f3.dtype == torch.bfloat16), float(dt),
                 int(max_disp), int(no_slip), int(clip01), int(bswap),
                 stream_of(field))
    advect_kernel.launches += 1
    if rgb565:
        return out, frame
    return out[0] if field.dim() == 2 else out


advect_kernel.launches = 0

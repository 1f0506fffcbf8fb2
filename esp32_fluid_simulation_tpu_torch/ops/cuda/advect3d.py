"""K7: 3D semi-Lagrangian advection on the GPU (``csrc/advect3d.cu``).

Replaces ``esp32_fluid_simulation_tpu/ops/pallas/advect3d.py:
advect3d_pallas``, on a single device and in its block mode (K11).
``advect3d_kernel`` launches the CUDA kernel for CUDA tensors and runs
``advect3d_reference``, its plain PyTorch version, for CPU tensors — only
because they lie on the CPU.  Any other device raises.

Semantics (both versions): backtrace ``x - dt*v`` per axis, the
displacement clamped to ``max_disp`` cells per axis (a CFL clamp that the
unclamped ``ops.advect.advect`` does not apply), trilinear sample at the
domain-clamped coordinate accumulated in the TPU kernel's order, the
no-slip factor from the unclamped coordinate, all in float32, and the
store in the field dtype.  The eager ``ops.advect.advect`` lerps in the
field dtype instead, so for bfloat16 fields the two differ by bf16
rounding.  The TPU kernel's ``max_disp <= 62`` limit came from its lane
band; a direct gather has none, so only ``0 <= max_disp < 2**24`` (exact
in float32) is checked.

Block mode (K11, ``global_offset=``/``global_shape=``/``halo=``,
``advect3d.py:265-306``, the sharded 3D steps' kernel advection): ``field``
is one shard's ``[C, D, bh+2*halo, bw+2*halo]`` block with ``halo >=
max_disp + 1`` exchanged cells on each side of the two horizontal axes,
``vel`` the owned ``[3, D, bh, bw]`` block, ``global_offset`` the owned
block's global ``(row, col)`` origin (two ints or a 2-element integer
tensor, read once on the host) and ``global_shape`` the domain ``(D, H,
W)``, whose ``D`` is the field's: the vertical axis is shard-local.  The
backtrace, its clamps and the no-slip factor use global coordinates; only
the taps are read from the haloed field, so the owned result equals the
whole grid's to the bit.  The TPU kernel's ``halo <= pr`` limit (its
aligned sublane halo) is dropped.  ``advect3d_kernel.block_launches``
counts these launches.

Self-advect: ``vel=None`` means the field is the velocity.  On the whole
grid that is ``vel = field``; in block mode the backtrace reads the
velocity from the haloed field's owned interior (``field[:, :, halo:-halo,
halo:-halo]``), so a shard's owned velocity is read once, not a second time
as its own array (``csrc/advect3d.cu``, the ``SELF`` flag).

The plume's source and buoyancy (``advect3d_source_kernel``, a
``Source``; the whole grid): the density and temperature, read through one
pointer each, are advected as one 2-channel launch that applies
``apply_source`` to what it advects before it stores, writing the
buoyancy into axis 0 of ``vel`` in place (the step's own velocity, fresh
from the self-advect).  Every operation rounds where ``apply_source``'s
eager ops round, so the result equals the advection followed by
``apply_source`` to the bit.  The kernel takes float32 velocities and
bfloat16 scalars and mask, the plume's dtypes; the plain version
(``advect3d_source_reference``) any.  It runs under K7's span and counts
in ``advect3d_kernel.launches``; ``advect3d_kernel.source_launches``
counts its launches and, on the CPU, its plain version's runs, so the
route a step takes shows without a card.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..advect import noslip_axis_factor
from ...spans import span
from .build import launch
from .modes import F32, FLOATS, check_block3d, check_launch


class Source(NamedTuple):
    """The plume's source and buoyancy for a scalar launch: ``mask`` the
    ``[D, H, W]`` source in the scalars' dtype; ``density`` and
    ``temperature`` what a step injects where the mask is 1 (dt times the
    rate); ``alpha`` and ``beta`` the buoyancy's lift and weight."""

    mask: torch.Tensor
    density: float
    temperature: float
    alpha: float
    beta: float


def apply_source(vel, rho, temp, source: Source, dt):
    """The plume's source and buoyancy over ``dt`` in eager ops: the
    scalars round in their storage dtype after every op; the force is
    computed in the velocity dtype and subtracted from axis 0 of ``vel`` in
    place.  Returns ``(vel, rho, temp)``."""
    rho = torch.clamp(rho + source.density * source.mask, max=1.0)
    temp = temp + source.temperature * source.mask
    buoy = (source.alpha * temp.to(vel.dtype)
            - source.beta * rho.to(vel.dtype)) * dt
    vel[0] -= buoy
    return vel, rho, temp


def _clamped_source(x, raw, max_disp, n):
    s = torch.minimum(torch.maximum(raw, x - max_disp), x + max_disp)
    return torch.clamp(s, 0.0, n - 1.0)


def advect3d_reference(field, vel, dt, no_slip, max_disp=4, block=None):
    """Plain PyTorch version of the kernel (same arithmetic, same order);
    ``block`` (a ``modes.Block``) is block mode: ``field`` haloed on the
    trailing two axes, ``vel`` and the result the owned block.  ``vel=None``
    is the self-advect: the velocity is ``field`` (its owned interior in
    block mode)."""
    squeeze = field.dim() == 3
    f = (field[None] if squeeze else field).to(torch.float32)
    if vel is None:
        g = 0 if block is None else block.halo
        vel = field[:, :, g:field.shape[-2] - g, g:field.shape[-1] - g]
    d, h, w = vel.shape[-3:]
    dev = field.device
    # the owned cells' global origin, the domain, and the shift from a
    # global row (column) to the field's
    ox, oy, gh, gw, ti, tj = (
        (0, 0, h, w, 0, 0) if block is None else
        (block.ox, block.oy, block.gh, block.gw, block.halo - block.ox,
         block.halo - block.oy))
    grid = torch.meshgrid(
        torch.arange(d, dtype=torch.float32, device=dev),
        torch.arange(h, device=dev).add(ox).to(torch.float32),
        torch.arange(w, device=dev).add(oy).to(torch.float32),
        indexing="ij")
    v = vel.to(torch.float32)
    raw = [grid[k] - v[k] * dt for k in range(3)]
    src = [_clamped_source(grid[k], raw[k], max_disp, n)
           for k, n in enumerate((d, gh, gw))]
    lo = [torch.clamp(torch.floor(s), 0.0, n - 2.0)
          for s, n in zip(src, (d, gh, gw))]
    dz, di, dj = (s - l for s, l in zip(src, lo))
    one_m_dj = 1.0 - dj
    z0, i0, j0 = lo[0].long(), lo[1].long() + ti, lo[2].long() + tj

    def colv(a, b):
        return (f[:, z0 + a, i0 + b, j0] * one_m_dj
                + f[:, z0 + a, i0 + b, j0 + 1] * dj)

    acc = colv(0, 0) * ((1.0 - dz) * (1.0 - di))
    acc = acc + colv(0, 1) * ((1.0 - dz) * di)
    acc = acc + colv(1, 0) * (dz * (1.0 - di))
    acc = acc + colv(1, 1) * (dz * di)
    if no_slip:
        acc = acc * (noslip_axis_factor(raw[0], d)
                     * noslip_axis_factor(raw[1], gh)
                     * noslip_axis_factor(raw[2], gw))
    out = acc.to(field.dtype)
    return out[0] if squeeze else out


def advect3d_source_reference(rho, temp, vel, dt, no_slip, source: Source,
                              max_disp=4):
    """Plain PyTorch version of the launch with the source: the 2-channel
    advection of ``(rho, temp)``, then ``apply_source`` (``vel`` written in
    place); returns the ``[2, D, H, W]`` scalars."""
    out = advect3d_reference(torch.stack([rho, temp]), vel, dt, no_slip,
                             max_disp)
    _, rho, temp = apply_source(vel, out[0], out[1], source, dt)
    return torch.stack([rho, temp])


def _check_launch_grid(name, shape, c, d, h, w, max_disp):
    """The launch's limits: planes on grid.z, rows on grid.y, 8 a block."""
    if not 1 <= c <= 4 or min(d, h, w) < 2 or d > 65535 or h > 8 * 65535:
        raise ValueError(f"{name}: field shape {tuple(shape)} not supported "
                         "(C <= 4, 2 <= D <= 65535, 2 <= H <= 524280, "
                         "W >= 2)")
    if not 0 <= max_disp < 2 ** 24:
        raise ValueError(f"{name}: max_disp={max_disp} out of range")


def advect3d_kernel(field: torch.Tensor, vel: torch.Tensor, dt: float,
                    no_slip: bool, max_disp: int = 4, global_offset=None,
                    global_shape=None, halo: int = 0):
    """Advect ``field`` (``[C, D, H, W]`` or ``[D, H, W]``, float32 or
    bfloat16, C <= 4) through ``vel`` (``[3, D, H, W]``, float32 or
    bfloat16) into a fresh tensor.  ``field`` may be ``vel`` itself, or
    ``vel`` None (the velocity self-advect; in block mode it reads the
    velocity from the haloed field).  ``global_offset``, ``global_shape``
    and ``halo`` are block mode (module docstring): ``field`` haloed,
    ``vel`` and the result the owned block."""
    with span("fluid.k7.advect3d"):
        f4 = field[None] if field.dim() == 3 else field
        if f4.dim() != 4:
            raise ValueError(f"advect3d_kernel: field shape "
                             f"{tuple(field.shape)} is not [C, D, H, W]")
        blk = check_block3d("advect3d_kernel", global_offset, global_shape,
                            halo, f4.shape, max_disp + 1, "max_disp+1")
        c, d, h, w = f4.shape
        if blk is not None:
            h, w = blk.bh, blk.bw
        if vel is None:
            if c != 3:
                raise ValueError(f"advect3d_kernel: vel=None (self-advect) "
                                 f"needs the [3, D, H, W] velocity as field, "
                                 f"got {tuple(field.shape)}")
            if blk is None:
                vel = field
        elif tuple(vel.shape) != (3, d, h, w):
            raise ValueError(f"advect3d_kernel: vel must be [3, {d}, {h}, "
                             f"{w}]" + (" (the owned block)" if blk is not None
                                        else ""))
        if field.device.type == "cpu":
            return advect3d_reference(field, vel, dt, no_slip, max_disp, blk)
        _check_launch_grid("advect3d_kernel", field.shape, c, d, h, w,
                           max_disp)
        check_launch("advect3d_kernel", field=(f4, FLOATS), vel=(vel, FLOATS))

        ox, oy, g, gh, gw = ((0, 0, 0, h, w) if blk is None else
                             (blk.ox, blk.oy, blk.halo, blk.gh, blk.gw))
        # the self-advect in block mode reads the velocity from the field
        v = f4 if vel is None else vel
        out = f4.new_empty((c, d, h, w))
        launch("fluid_advect3d", f4, f4, vel, out, c, d, h, w,
               int(f4.dtype == torch.bfloat16), int(v.dtype == torch.bfloat16),
               float(dt), int(max_disp), int(no_slip), ox, oy, g, gh, gw)
        advect3d_kernel.launches += 1
        advect3d_kernel.block_launches += blk is not None
        return out[0] if field.dim() == 3 else out


def advect3d_source_kernel(rho: torch.Tensor, temp: torch.Tensor,
                           vel: torch.Tensor, dt: float, no_slip: bool,
                           source: Source, max_disp: int = 4):
    """Advect the density and temperature (``[D, H, W]`` each) through
    ``vel`` (``[3, D, H, W]``) in one launch that injects ``source`` and
    subtracts the buoyancy from ``vel[0]`` in place (module docstring);
    returns the ``[2, D, H, W]`` scalars, a fresh tensor."""
    with span("fluid.k7.advect3d"):
        shape = tuple(rho.shape)
        if (len(shape) != 3 or tuple(temp.shape) != shape
                or tuple(vel.shape) != (3,) + shape
                or tuple(source.mask.shape) != shape):
            raise ValueError("advect3d_source_kernel: needs [D, H, W] "
                             "density, temperature and mask and the [3, D, "
                             "H, W] velocity")
        if rho.device.type == "cpu":
            out = advect3d_source_reference(rho, temp, vel, dt, no_slip,
                                            source, max_disp)
            advect3d_kernel.source_launches += 1
            return out
        _check_launch_grid("advect3d_source_kernel", shape, 2, *shape,
                           max_disp)
        bf16 = (torch.bfloat16,)
        check_launch("advect3d_source_kernel", density=(rho, bf16),
                     temperature=(temp, bf16), vel=(vel, F32),
                     mask=(source.mask, bf16))
        d, h, w = shape
        out = rho.new_empty((2,) + shape)
        launch("fluid_advect3d_source", rho, rho, temp, vel, out, source.mask,
               d, h, w, float(dt), int(max_disp), int(no_slip),
               float(source.density), float(source.temperature),
               float(source.alpha), float(source.beta))
        advect3d_kernel.launches += 1
        advect3d_kernel.source_launches += 1
        return out


advect3d_kernel.launches = 0
advect3d_kernel.block_launches = 0
advect3d_kernel.source_launches = 0

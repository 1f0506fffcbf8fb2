"""K2: 2D semi-Lagrangian advection, and K5: MacCormack advection, on the
GPU (``csrc/advect.cu``).

K2 replaces ``esp32_fluid_simulation_tpu/ops/pallas/advect.py:
advect_pallas`` (the "sloop" kernel), K5 ``advect.py:
advect_maccormack_pallas``.  ``advect_kernel`` and
``advect_maccormack_kernel`` launch the CUDA kernels for CUDA tensors and
run ``advect_reference`` / ``advect_maccormack_reference``, their plain
PyTorch versions, for CPU tensors — only because they lie on the CPU.  Any
other device raises.

K2 semantics (both versions): backtrace ``x - dt*v``; the displacement is
clamped to ``max_disp`` cells per axis (a CFL clamp that the unclamped
``ops.advect.advect`` does not apply); bilinear sample at the domain-clamped
coordinate, computed in float32; the no-slip factor from the unclamped
coordinate; the optional [0, 1] clip; the store in the field dtype; with
``rgb565`` also the ``[H-1, W-1]`` RGB565 frame of the *stored* dye; with
``return_minmax`` also the min and max of the four undiscounted taps.

K5 (both versions): ``phi_hat, cmin, cmax = K2(field, vel, return_minmax)``,
``phi_back = K2(phi_hat, -vel)``, then ``phi_hat + 0.5*(field - phi_back)``
clamped to ``[min(cmin, phi_hat), max(cmax, phi_hat)]``, each op rounding
to the field dtype.  The kernel is one launch per call (the window route,
``csrc/advect.cu`` ``maccormack_tile_kernel``): each block of 32 x 32
cells computes ``phi_hat`` over its tile +- its reach (``maccormack_reach``)
in shared memory and applies the backward pass and the limiter there.
Where the worst-case window (reach ``max_disp + 1``) does not fit a block's
shared memory, the launch reports so and the call takes the two-launch
route (K2 with the raw extrema, then the backward pass and the limiter): a
route chosen by shape, counted by
``advect_maccormack_kernel.two_launch_calls``.

K6, the tiled-domain modes (``advect.py:112-165, 601-607``):

* ``member=(mh, mw)``: the grid is a supergrid of independent member tiles;
  after the CFL clamp the sample is clamped to its tile ``[lo, lo+mh-1]``
  (``lo = (i // mh) * mh``, exact), the base tap to ``[lo, lo+mh-2]``, and
  the no-slip factor is taken from ``si_raw - lo`` against ``mh``.  It
  combines with every other flag, and K5 passes it to both passes.
* ``overlay=``: a dense ``[C+1, H, W]`` float32 array; where channel ``C``
  is > 0, channel ``ch`` replaces the value after the no-slip factor and the
  clip, before the store (the drag queue's drain riding the store).  Not
  with ``rgb565`` or ``return_minmax``, as in the JAX package.
* the member stack: a ``[n, C, mh, mw]`` field (with ``member=(mh, mw)``,
  its own; a ``[n, 2, mh, mw]`` velocity, or the field under
  ``self_advect``) is the ensemble's state as it lies, the members
  row-major over the ``modes.member_grid(n)`` tiling of an ``[C, gh*mh,
  gw*mw]`` supergrid.  The kernel computes on that supergrid's coordinates
  and reads and writes the stack in place (``csrc/stack.cuh``), so the
  result is the supergrid member mode's laid out as a stack, bit for bit.
  It takes ``overlay=`` (on the supergrid) and ``clip01``, not
  ``rgb565``, ``return_minmax`` or block mode; its plain version is the
  supergrid's between ``modes._from_members`` and ``_to_members``.

K11, block mode (``global_offset=``/``global_shape=``/``halo=``,
``advect.py:741-747, 786-795``, the sharded step's kernel advection):
``field`` is one shard's block with ``halo >= max_disp + 1`` exchanged
cells per side, ``vel`` the owned block without a halo, ``global_offset``
the owned block's global origin ``(ox, oy)`` (two ints or a 2-element
integer tensor, read once on the host) and ``global_shape`` the domain.
The backtrace, the clamps and the no-slip factor are those of the whole
grid, in global float coordinates; only the taps' rows and columns shift
into the haloed block, so the owned cells equal the whole grid's to the
bit.  It takes 1-3 channels, float32 and bfloat16 fields, ``no_slip``,
``clip01`` and ``return_minmax``; ``self_advect`` and ``overlay`` raise
``ValueError`` as in JAX, ``member`` and ``rgb565`` (no caller in the JAX
package) raise ``NotImplementedError``.  K5 refuses block mode with
``ValueError``, as in JAX: the sharded MacCormack composes K2.

K2's member overlay (``member_overlay``): an ensemble's ``[n, K]`` member
impulses as the dense ``[3, gh*mh, gw*mw]`` overlay that ``overlay=``
reads, built in one set and one launch (a thread a member's slot, which
writes unless a later active slot of its member hits its clamped cell)
in place of ~25 eager ops; its plain version is ``ops.impulses``'
``member_cells`` and ``overlay_from_targets``, and
``member_overlay.launches`` counts its launches.

Each mode has its own launch counter beside ``launches``:
``advect_kernel.member_launches`` (the member stack's too),
``.overlay_launches``, ``.block_launches`` and ``.stack_launches``;
``advect_maccormack_kernel.launches``
counts the window route's launches, ``.member_launches`` those with
``member=``, and ``.two_launch_calls`` the calls of the two-launch route.
"""

from __future__ import annotations

import torch

from ...render.upscale import pack_rgb565
from ...spans import span
from ...state import Impulses
from ..advect import noslip_axis_factor
from ..impulses import member_cells, overlay_from_targets
from .build import launch
from .modes import (BLOCK_MODE, F32, FLOATS, _from_members, _to_members,
                    check_block, check_launch, check_member, check_stack,
                    refuse_unported)

_NONE, _RAW = 0, 1   # enum MinMax in csrc/advect.cu
_WINDOW_TOO_LARGE = -1   # kWindowTooLarge in csrc/advect.cu


def _origin(n, m, device):
    """Member-tile origin ``(k // m) * m`` of each index ``k < n``, exact in
    float32."""
    return (torch.arange(n, device=device) // m * m).to(torch.float32)


def advect_reference(field, vel, dt, no_slip, max_disp=12, clip01=False,
                     rgb565=False, bswap=True, return_minmax=False,
                     member=None, overlay=None, block=None):
    """Plain PyTorch version of the kernel (same arithmetic, same order);
    ``block`` (a ``modes.Block``) is block mode: ``field`` haloed, ``vel``
    and the result the owned block."""
    squeeze = field.dim() == 2
    f = (field[None] if squeeze else field).to(torch.float32)
    h, w = vel.shape[-2:]
    dev = field.device
    # the owned cells' global origin, the domain, and the shift from a
    # global row (column) to the field's
    ox, oy, gh, gw, ti, tj = (
        (0, 0, h, w, 0, 0) if block is None else
        (block.ox, block.oy, block.gh, block.gw, block.halo - block.ox,
         block.halo - block.oy))
    fi = (torch.arange(h, device=dev)[:, None] + ox).to(
        torch.float32).expand(h, w)
    fj = (torch.arange(w, device=dev)[None, :] + oy).to(
        torch.float32).expand(h, w)
    v = vel.to(torch.float32)
    si_raw = fi - v[0] * dt
    sj_raw = fj - v[1] * dt
    si = torch.minimum(torch.maximum(si_raw, fi - max_disp), fi + max_disp)
    sj = torch.minimum(torch.maximum(sj_raw, fj - max_disp), fj + max_disp)
    if member is None:
        si = torch.clamp(si, 0.0, gh - 1.0)
        sj = torch.clamp(sj, 0.0, gw - 1.0)
        i0 = torch.clamp(torch.floor(si), 0.0, gh - 2.0)
        j0 = torch.clamp(torch.floor(sj), 0.0, gw - 2.0)
    else:
        mh, mw = member
        lo_i = _origin(h, mh, dev)[:, None].expand(h, w)
        lo_j = _origin(w, mw, dev)[None, :].expand(h, w)
        si = torch.minimum(torch.maximum(si, lo_i), lo_i + (mh - 1))
        sj = torch.minimum(torch.maximum(sj, lo_j), lo_j + (mw - 1))
        i0 = torch.minimum(torch.maximum(torch.floor(si), lo_i),
                           lo_i + (mh - 2))
        j0 = torch.minimum(torch.maximum(torch.floor(sj), lo_j),
                           lo_j + (mw - 2))
    di = si - i0
    dj = sj - j0
    one_m_dj = 1.0 - dj
    ii = i0.long() + ti
    jj = j0.long() + tj
    t00, t01 = f[:, ii, jj], f[:, ii, jj + 1]
    t10, t11 = f[:, ii + 1, jj], f[:, ii + 1, jj + 1]
    colv0 = t00 * one_m_dj + t01 * dj
    colv1 = t10 * one_m_dj + t11 * dj
    acc = colv0 * (1.0 - di) + colv1 * di
    if no_slip:
        if member is None:
            acc = acc * (noslip_axis_factor(si_raw, gh)
                         * noslip_axis_factor(sj_raw, gw))
        else:
            acc = acc * (noslip_axis_factor(si_raw - lo_i, mh)
                         * noslip_axis_factor(sj_raw - lo_j, mw))
    if clip01:
        acc = torch.clamp(acc, 0.0, 1.0)
    if overlay is not None:
        c = f.shape[0]
        acc = torch.where(overlay[c] > 0, overlay[:c], acc)
    out = acc.to(field.dtype)
    if rgb565:
        # the frame packs the stored values: clip01 keeps them in [0, 1]
        return out, pack_rgb565(out[:, :-1, :-1], bswap=bswap)
    if return_minmax:
        # extrema of the undiscounted taps, exact in the field dtype
        cmin = torch.minimum(torch.minimum(t00, t01),
                             torch.minimum(t10, t11)).to(field.dtype)
        cmax = torch.maximum(torch.maximum(t00, t01),
                             torch.maximum(t10, t11)).to(field.dtype)
        if squeeze:
            return out[0], cmin[0], cmax[0]
        return out, cmin, cmax
    return out[0] if squeeze else out


def advect_maccormack_reference(field, vel, dt, no_slip, max_disp=12,
                                member=None):
    """Plain PyTorch version of K5 (``advect.py:965-987``): two plain K2
    passes and the limiter, each op in the field dtype."""
    phi_hat, cmin, cmax = advect_reference(field, vel, dt, no_slip,
                                           max_disp=max_disp,
                                           return_minmax=True, member=member)
    phi_back = advect_reference(phi_hat, -vel, dt, no_slip,
                                max_disp=max_disp, member=member)
    corrected = phi_hat + 0.5 * (field - phi_back)
    lo = torch.minimum(cmin, phi_hat)
    hi = torch.maximum(cmax, phi_hat)
    return torch.clamp(corrected, lo, hi)


def _checked_3d(name, field, vel, max_disp, block=None):
    """Validate a CUDA launch's inputs; the field as ``[C, H, W]``."""
    f3 = field[None] if field.dim() == 2 else field
    c, h, w = f3.shape
    # the launch puts rows on grid.y, 8 a block, at most 65535 blocks
    if c not in (1, 2, 3) or h < 2 or w < 2 or h > 8 * 65535:
        raise ValueError(f"{name}: field shape {tuple(field.shape)} not "
                         "supported (C <= 3, 2 <= H <= 524280, W >= 2)")
    vshape = (2, h, w) if block is None else (2, block.bh, block.bw)
    if vel.shape != vshape:
        raise ValueError(f"{name}: vel must be float32 {list(vshape)}")
    check_launch(name, field=(f3, FLOATS), vel=(vel, F32))
    if not 0 <= max_disp < 2 ** 24:
        raise ValueError(f"{name}: max_disp={max_disp} out of range")
    return f3


def _checked_overlay(overlay, f3, squeeze, grid=None):
    """The overlay as a float32 ``[C+1, H, W]`` tensor beside ``f3``, on
    the supergrid ``grid`` ``(H, W)`` of a member stack where given."""
    c, h, w = f3.shape[-3:] if grid is None else (f3.shape[1], *grid)
    if tuple(overlay.shape) != (c + 1, h, w):
        shape = tuple(f3.shape[1:] if squeeze else f3.shape)
        raise ValueError(f"overlay must be [{c + 1}, H, W] (values + write "
                         f"flag) for a field {shape}, got "
                         f"{tuple(overlay.shape)}")
    if overlay.device != f3.device:
        raise ValueError("overlay and field on different devices")
    return overlay.to(torch.float32).contiguous()


def _launch_advect(f3, vel, dt, no_slip, max_disp, clip01=False,
                   rgb565=False, bswap=True, minmax=_NONE, member=None,
                   overlay=None, block=None):
    """One launch of the advect kernel: ``out``, plus the frame or the
    bounds as asked."""
    c = f3.shape[0]
    h, w = vel.shape[-2:]
    mh, mw = member or (0, 0)
    ox, oy, gh, gw, g = ((0, 0, h, w, 0) if block is None else
                         (block.ox, block.oy, block.gh, block.gw,
                          block.halo))
    out = f3.new_empty((c, h, w))
    frame = (torch.empty((h - 1, w - 1), dtype=torch.uint16,
                         device=f3.device) if rgb565 else None)
    lo = torch.empty_like(out) if minmax else None
    hi = torch.empty_like(out) if minmax else None
    launch("fluid_advect", f3, f3, vel, overlay, out, frame, lo, hi, c, h, w,
           int(f3.dtype == torch.bfloat16), float(dt), int(max_disp), mh, mw,
           ox, oy, g, gh, gw, int(no_slip), int(clip01), int(bswap),
           int(minmax), 0)
    return out, frame, lo, hi


def _advect_stack(field, vel, dt, no_slip, max_disp, clip01, member,
                  overlay):
    """K2's member mode on a member stack (module docstring)."""
    n, c, mh, mw = field.shape
    gh, gw = check_stack("advect_kernel", field, member, (1, 2, 3))
    h, w = gh * mh, gw * mw
    if tuple(vel.shape) != (n, 2, mh, mw):
        raise ValueError(f"advect_kernel: a member stack takes the velocity "
                         f"[{n}, 2, {mh}, {mw}], got {list(vel.shape)}")
    if overlay is not None:
        overlay = _checked_overlay(overlay, field, False, (h, w))
    if field.device.type == "cpu":
        out = advect_reference(_from_members(field, h, w),
                               _from_members(vel, h, w), dt, no_slip,
                               max_disp=max_disp, clip01=clip01,
                               member=(mh, mw), overlay=overlay)
        return _to_members(out, mh, mw)
    check_launch("advect_kernel", field=(field, FLOATS), vel=(vel, F32))
    # the launch puts the members on grid.z, at most 65535
    if n > 65535 or not 0 <= max_disp < 2 ** 24:
        raise ValueError(f"advect_kernel: {n} members or max_disp="
                         f"{max_disp} out of range")
    out = torch.empty_like(field)
    launch("fluid_advect", field, field, vel, overlay, out, None, None, None,
           c, h, w, int(field.dtype == torch.bfloat16), float(dt),
           int(max_disp), mh, mw, 0, 0, 0, h, w, int(no_slip), int(clip01),
           1, _NONE, 1)
    advect_kernel.launches += 1
    advect_kernel.member_launches += 1
    advect_kernel.overlay_launches += overlay is not None
    advect_kernel.stack_launches += 1
    return out


def advect_kernel(field: torch.Tensor, vel: torch.Tensor, dt: float,
                  no_slip: bool, max_disp: int = 12, clip01: bool = False,
                  rgb565: bool = False, bswap: bool = True,
                  self_advect: bool = False, return_minmax: bool = False,
                  member=None, overlay: torch.Tensor | None = None,
                  global_offset=None, global_shape=None, halo: int = 0,
                  **unported):
    """Advect ``field`` (``[C, H, W]`` or ``[H, W]``, float32 or bfloat16)
    through ``vel`` (``[2, H, W]`` float32).  Returns the new field,
    ``(field, frame)`` with ``rgb565=True`` (a 3-channel field with
    ``clip01``), or ``(field, cmin, cmax)`` with ``return_minmax=True``.
    ``self_advect=True`` advects the velocity by itself (``field`` is the
    velocity; ``vel`` is ignored) into a fresh tensor.  ``member`` and
    ``overlay`` are the tiled-domain modes, on a supergrid or on a
    ``[n, C, mh, mw]`` member stack, ``global_offset``, ``global_shape``
    and ``halo`` block mode (module docstring)."""
    with span("fluid.k2.advect"):
        refuse_unported("advect_kernel", unported, also=("sample_bf16",))
        if rgb565 and (not clip01 or field.dim() != 3 or field.shape[0] != 3
                       or return_minmax):
            raise ValueError("rgb565 needs clip01 on a 3-channel field (and "
                             "no return_minmax)")
        if overlay is not None and (rgb565 or return_minmax):
            raise ValueError("overlay needs the plain store (no return_minmax "
                             "or rgb565)")
        stack = field.dim() == 4
        if self_advect:
            if field.dim() not in (3, 4) or field.shape[-3] != 2:
                raise ValueError("self_advect needs the [2, H, W] velocity "
                                 "(or its member stack) as field")
            vel = field
        if stack:
            if (rgb565 or return_minmax or halo
                    or global_offset is not None
                    or global_shape is not None):
                raise ValueError("advect_kernel: a member stack takes no "
                                 "rgb565, return_minmax or block mode")
            return _advect_stack(field, vel, dt, no_slip, max_disp, clip01,
                                 member, overlay)
        squeeze = field.dim() == 2
        f3 = field[None] if squeeze else field
        blk = check_block("advect_kernel", global_offset, global_shape, halo,
                          f3.shape[-2:], max_disp + 1, "max_disp+1")
        if blk is not None:
            if self_advect or overlay is not None:
                raise ValueError("advect_kernel: self_advect and overlay take "
                                 "no block mode (single device)")
            if member is not None or rgb565:
                raise NotImplementedError(
                    "advect_kernel: member= and rgb565= with block mode have "
                    "no caller and are not ported (ROADMAP.md queue 1, 'Not "
                    "to port')")
            if tuple(vel.shape) != (2, blk.bh, blk.bw):
                raise ValueError(f"advect_kernel: block mode takes the owned "
                                 f"velocity [2, {blk.bh}, {blk.bw}], got "
                                 f"{list(vel.shape)}")
        member = check_member("advect_kernel", member, *f3.shape[-2:])
        if overlay is not None:
            overlay = _checked_overlay(overlay, f3, squeeze)
        if field.device.type == "cpu":
            return advect_reference(field, vel, dt, no_slip, max_disp=max_disp,
                                    clip01=clip01, rgb565=rgb565, bswap=bswap,
                                    return_minmax=return_minmax, member=member,
                                    overlay=overlay, block=blk)

        f3 = _checked_3d("advect_kernel", field, vel, max_disp, blk)
        out, frame, lo, hi = _launch_advect(
            f3, vel, dt, no_slip, max_disp, clip01=clip01, rgb565=rgb565,
            bswap=bswap, minmax=_RAW if return_minmax else _NONE,
            member=member, overlay=overlay, block=blk)
        advect_kernel.launches += 1
        advect_kernel.member_launches += member is not None
        advect_kernel.overlay_launches += overlay is not None
        advect_kernel.block_launches += blk is not None
        if rgb565:
            return out, frame
        if squeeze:
            return (out[0], lo[0], hi[0]) if return_minmax else out[0]
        return (out, lo, hi) if return_minmax else out


advect_kernel.launches = 0
advect_kernel.member_launches = 0
advect_kernel.overlay_launches = 0
advect_kernel.block_launches = 0
advect_kernel.stack_launches = 0


def maccormack_reach(vel, dt, max_disp):
    """Plain version of the window route's reach over a tile's velocities
    ``vel`` (``[2, h, w]``): per axis, ``min(ceil(max |v*dt|), max_disp) +
    1``, a NaN or inf displacement counting as ``max_disp``.  The backward
    taps of the tile's cells lie within it."""
    d = torch.abs(vel.to(torch.float32) * dt)
    r = torch.where(d <= max_disp, torch.ceil(d),
                    torch.full_like(d, float(max_disp)))
    return tuple(int(x) + 1 for x in r.amax(dim=(1, 2)))


def _maccormack_args(f3, dt, no_slip, max_disp, member):
    """The launch arguments K5's two entries share after their buffers."""
    c, h, w = f3.shape
    mh, mw = member or (0, 0)
    return (c, h, w, int(f3.dtype == torch.bfloat16), float(dt),
            int(max_disp), mh, mw, int(no_slip))


def _launch_two(f3, vel, dt, no_slip, max_disp, member):
    """The two-launch route: K2 with the raw extrema, then the backward
    pass and the limiter."""
    phi_hat, _, cmin, cmax = _launch_advect(f3, vel, dt, no_slip, max_disp,
                                            minmax=_RAW, member=member)
    out = torch.empty_like(f3)
    launch("fluid_maccormack_correct", f3, f3, phi_hat, cmin, cmax, vel, out,
           *_maccormack_args(f3, dt, no_slip, max_disp, member))
    return out


def advect_maccormack_kernel(field: torch.Tensor, vel: torch.Tensor,
                             dt: float, no_slip: bool, max_disp: int = 12,
                             member=None, **unported):
    """MacCormack advection of ``field`` (``[C, H, W]`` or ``[H, W]``,
    float32 or bfloat16) through ``vel`` (``[2, H, W]`` float32), with the
    CFL clamp of K2 (and its ``member`` mode in both passes).  The velocity
    advects as ``field = vel`` with ``no_slip=True``; the dye with
    ``no_slip=False``.  Block mode raises ``ValueError``, as in JAX: the
    backward pass would read ``phi_hat`` without its halo."""
    if any(key in unported for key in BLOCK_MODE):
        raise ValueError("advect_maccormack_kernel is single-device only; "
                         "block-mode arguments are not taken (the sharded "
                         "MacCormack composes K2)")
    refuse_unported("advect_maccormack_kernel", unported,
                    also=("sample_bf16",))
    member = check_member("advect_maccormack_kernel", member,
                          *field.shape[-2:])
    if field.device.type == "cpu":
        return advect_maccormack_reference(field, vel, dt, no_slip,
                                           max_disp=max_disp, member=member)
    f3 = _checked_3d("advect_maccormack_kernel", field, vel, max_disp)
    out = torch.empty_like(f3)
    # the window route, unless its window does not fit a block
    if launch("fluid_maccormack", f3, f3, vel, out,
              *_maccormack_args(f3, dt, no_slip, max_disp, member),
              refused=_WINDOW_TOO_LARGE):
        advect_maccormack_kernel.launches += 1
        advect_maccormack_kernel.member_launches += member is not None
    else:
        out = _launch_two(f3, vel, dt, no_slip, max_disp, member)
        advect_maccormack_kernel.two_launch_calls += 1
    return out[0] if field.dim() == 2 else out


advect_maccormack_kernel.launches = 0
advect_maccormack_kernel.member_launches = 0
advect_maccormack_kernel.two_launch_calls = 0


_I32, _BOOL = (torch.int32,), (torch.bool,)


def member_overlay_reference(imp: Impulses, gh: int, gw: int, mh: int,
                             mw: int) -> torch.Tensor:
    """Plain PyTorch version of ``member_overlay``: the winning slots'
    cells and values scattered into a zeroed overlay."""
    return overlay_from_targets(*member_cells(imp, gh, gw, mh, mw),
                                (gh * mh, gw * mw))


def member_overlay(imp: Impulses, gh: int, gw: int, mh: int,
                   mw: int) -> torch.Tensor:
    """An ensemble's member impulses (``pos`` ``[n, K, 2]`` member-local,
    ``velocity``, ``active`` ``[n, K]``; members row-major over a ``gh x
    gw`` tiling of ``mh x mw`` tiles) as K2's ``[3, gh*mh, gw*mw]``
    float32 store-time overlay, bit-equal to its plain version; on CPU
    tensors the plain version."""
    n, k, nd = imp.pos.shape
    plane = gh * mh * gw * mw
    if nd != 2 or n != gh * gw or imp.active.shape != (n, k):
        raise ValueError("member_overlay: needs pos [gh*gw, K, 2] and "
                         "active [gh*gw, K]")
    if imp.pos.device.type == "cpu":
        return member_overlay_reference(imp, gh, gw, mh, mw)
    vel = imp.velocity.to(torch.float32).contiguous()
    pos, active = imp.pos.contiguous(), imp.active.contiguous()
    check_launch("member_overlay", pos=(pos, _I32), vel=(vel, F32),
                 active=(active, _BOOL))
    if plane >= 2 ** 31:
        raise ValueError("member_overlay: the supergrid has 2^31 cells or "
                         "more")
    out = torch.empty((nd + 1, gh * mh, gw * mw), dtype=torch.float32,
                      device=pos.device)
    launch("fluid_member_overlay", pos, pos, vel, active, out, n, k, gw, mh,
           mw, plane)
    member_overlay.launches += 1
    return out


member_overlay.launches = 0

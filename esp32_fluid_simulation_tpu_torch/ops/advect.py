"""Semi-Lagrangian advection as a vectorized backtrace + multilinear gather
(counterpart of ``esp32_fluid_simulation_tpu/ops/advect.py``).

For every node, backtrace ``source = (i, j) - vel * dt`` (``advect.h:81``)
and sample the old field there with the reference sampler's semantics
(``advect.h:24-72``): multilinear interpolation at the *clamped* coordinate
(the edge lerp), and the optional no-slip discount computed from the
*unclamped* coordinate.  Rank-polymorphic (2D and 3D grids, any number of
leading channel axes).  This path does not clamp the displacement; the
kernel path (``ops/cuda/advect.py``) does.
"""

from __future__ import annotations

from typing import Sequence

import torch


def _lerp(t, a, b):
    """Reference lerp form ``p1*(1-t) + p2*t`` (``advect.h:14-16``)."""
    return a * (1 - t) + b * t


def noslip_axis_factor(raw_coord: torch.Tensor, n: int) -> torch.Tensor:
    """The per-axis no-slip overshoot discount (``advect.h:62-70``), from the
    *unclamped* backtrace coordinate against a domain of ``n`` nodes."""
    under = raw_coord < 0
    over = raw_coord >= n - 1
    overshoot = torch.where(under, -raw_coord, raw_coord - (n - 1))
    one = torch.ones_like(raw_coord)
    return torch.where(
        under | over,
        torch.where(overshoot < 0.5, 1.0 - 2.0 * overshoot,
                    torch.zeros_like(raw_coord)),
        one,
    )


def sample_linear(field: torch.Tensor, coords: Sequence[torch.Tensor],
                  no_slip: bool = False) -> torch.Tensor:
    """Multilinear sample of ``field`` at fractional ``coords`` with the
    reference's edge-collapse + no-slip-discount semantics.

    field:  ``[*channels, *shape]``; coords: one float tensor per spatial
    axis, each of shape ``shape``.
    """
    nd = len(coords)
    shape = field.shape[field.dim() - nd:]
    dtype = field.dtype

    i0s, fracs, factors = [], [], []
    for k in range(nd):
        n = shape[k]
        c = coords[k]
        cc = torch.clamp(c, 0.0, n - 1.0)
        i0 = torch.clamp(torch.floor(cc), 0, n - 2)
        fracs.append((cc - i0).to(dtype))
        i0s.append(i0.long())
        if no_slip:
            factors.append(noslip_axis_factor(c, n).to(dtype))

    def gather(offsets):
        idx = tuple(i0s[k] + offsets[k] for k in range(nd))
        return field[(Ellipsis,) + idx]

    def reduce_lerp(axis, offsets):
        # the first axis nests outermost (advect.h:19-22)
        if axis == nd:
            return gather(offsets)
        lo = reduce_lerp(axis + 1, offsets + (0,))
        hi = reduce_lerp(axis + 1, offsets + (1,))
        return _lerp(fracs[axis], lo, hi)

    val = reduce_lerp(0, ())
    if no_slip:
        total = factors[0]
        for f in factors[1:]:
            total = total * f
        val = val * total
    return val


def _backtrace_coords(vel: torch.Tensor, dt, sign=1.0):
    """source_k = idx_k - sign * vel_k * dt  (advect.h:81)."""
    nd = vel.shape[0]
    shape = tuple(vel.shape[1:])
    coords = []
    for k in range(nd):
        view = [1] * nd
        view[k] = shape[k]
        idx = torch.arange(shape[k], dtype=vel.dtype,
                           device=vel.device).view(view).expand(shape)
        coords.append(idx - sign * vel[k] * dt)
    return coords


def advect(field: torch.Tensor, vel: torch.Tensor, dt: float,
           no_slip: bool) -> torch.Tensor:
    """Advect ``field`` through ``vel`` for one step of ``dt``
    (``advect.h:74-85``): velocity self-advects with ``no_slip=True``, dye
    with ``no_slip=False``."""
    coords = _backtrace_coords(vel, dt)
    return sample_linear(field, coords, no_slip=no_slip)

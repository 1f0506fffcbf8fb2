"""Semi-Lagrangian advection as a vectorized backtrace + multilinear gather
(counterpart of ``esp32_fluid_simulation_tpu/ops/advect.py``).

For every node, backtrace ``source = (i, j) - vel * dt`` (``advect.h:81``)
and sample the old field there with the reference sampler's semantics
(``advect.h:24-72``): multilinear interpolation at the *clamped* coordinate
(the edge lerp), and the optional no-slip discount computed from the
*unclamped* coordinate.  Rank-polymorphic (2D and 3D grids, any number of
leading channel axes).  This path does not clamp the displacement; the
kernel path (``ops/cuda/advect.py``) does.

Also the midpoint (RK2) backtrace and MacCormack advection with its
monotonic limiter (``ops/advect.py:166-206``), built from the same gather.
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
                  no_slip: bool = False, return_minmax: bool = False):
    """Multilinear sample of ``field`` at fractional ``coords`` with the
    reference's edge-collapse + no-slip-discount semantics
    (``ops/advect.py:61-127``).

    field:  ``[*channels, *shape]``; coords: one float tensor per spatial
    axis, each of shape ``shape``.  With ``return_minmax`` also the min and
    max of the 2^nd corner values, taken from the undiscounted taps:
    ``(val, cmin, cmax)``.
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
        # a NaN coordinate casts to an out-of-range index: clamp it as
        # JAX's gather does, so the sample is NaN instead of an IndexError
        i0s.append(torch.clamp(i0.long(), 0, n - 2))
        if no_slip:
            factors.append(noslip_axis_factor(c, n).to(dtype))

    corners = []

    def gather(offsets):
        idx = tuple(i0s[k] + offsets[k] for k in range(nd))
        corners.append(field[(Ellipsis,) + idx])
        return corners[-1]

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
    if not return_minmax:
        return val
    cmin = cmax = corners[0]
    for corner in corners[1:]:
        cmin = torch.minimum(cmin, corner)
        cmax = torch.maximum(cmax, corner)
    return val, cmin, cmax


def _index(vel: torch.Tensor, k: int) -> torch.Tensor:
    """The node index along spatial axis ``k``, broadcast over the grid."""
    nd = vel.shape[0]
    shape = tuple(vel.shape[1:])
    view = [1] * nd
    view[k] = shape[k]
    return torch.arange(shape[k], dtype=vel.dtype,
                        device=vel.device).view(view).expand(shape)


def _backtrace_coords(vel: torch.Tensor, dt, sign=1.0):
    """source_k = idx_k - sign * vel_k * dt  (advect.h:81)."""
    return [_index(vel, k) - sign * vel[k] * dt
            for k in range(vel.shape[0])]


def advect(field: torch.Tensor, vel: torch.Tensor, dt: float,
           no_slip: bool) -> torch.Tensor:
    """Advect ``field`` through ``vel`` for one step of ``dt``
    (``advect.h:74-85``): velocity self-advects with ``no_slip=True``, dye
    with ``no_slip=False``."""
    coords = _backtrace_coords(vel, dt)
    return sample_linear(field, coords, no_slip=no_slip)


def advect_rk2(field: torch.Tensor, vel: torch.Tensor, dt: float,
               no_slip: bool) -> torch.Tensor:
    """Second-order (midpoint) backtrace (``ops/advect.py:166-181``):
    sample the velocity at ``x - dt/2 * v(x)`` and trace the full step
    through it.  Sampling semantics are those of ``advect``."""
    v_mid = sample_linear(vel, _backtrace_coords(vel, dt * 0.5),
                          no_slip=False)
    coords = [_index(vel, k) - v_mid[k] * dt for k in range(vel.shape[0])]
    return sample_linear(field, coords, no_slip=no_slip)


def advect_maccormack(field: torch.Tensor, vel: torch.Tensor, dt: float,
                      no_slip: bool) -> torch.Tensor:
    """MacCormack advection with the monotonic clamp
    (``ops/advect.py:184-206``): forward predictor, backward corrector,
    error-compensated result clamped to the stencil extrema at the
    backtraced point.  The bounds include the predictor, so the clamp
    keeps the no-slip wall discount baked into ``phi_hat``."""
    phi_hat, cmin, cmax = sample_linear(field, _backtrace_coords(vel, dt),
                                        no_slip=no_slip, return_minmax=True)
    phi_back = sample_linear(phi_hat, _backtrace_coords(vel, dt, sign=-1.0),
                             no_slip=no_slip)
    corrected = phi_hat + 0.5 * (field - phi_back)
    cmin = torch.minimum(cmin, phi_hat)
    cmax = torch.maximum(cmax, phi_hat)
    return torch.clamp(corrected, cmin, cmax)

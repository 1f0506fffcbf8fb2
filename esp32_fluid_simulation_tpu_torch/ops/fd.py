"""Finite-difference operators: divergence and gradient subtract
(counterpart of ``esp32_fluid_simulation_tpu/ops/fd.py:25-66``).

* ``divergence`` — central differences with the reflected ghost velocity at
  the walls: an out-of-bounds neighbour contributes ``-v`` of the center
  cell (``finitediff.cpp:9-31``).
* ``subtract_gradient`` — ``v <- v - grad(p)`` with the Neumann pressure BC:
  the out-of-bounds pressure neighbour is clamped to the center value
  (``finitediff.cpp:41-73``).

Both are rank-polymorphic (2D/3D).
"""

from __future__ import annotations

import torch


def _shift_reflect_neg(v: torch.Tensor, axis: int) -> torch.Tensor:
    """(v[+1] - v[-1]) along ``axis`` where the ghost outside each wall is the
    negated center value (finitediff.cpp:17-20)."""
    n = v.shape[axis]
    lo = -v.narrow(axis, 0, 1)
    hi = -v.narrow(axis, n - 1, 1)
    ext = torch.cat([lo, v, hi], dim=axis)
    return ext.narrow(axis, 2, n) - ext.narrow(axis, 0, n)


def _shift_edge_clamp(p: torch.Tensor, axis: int) -> torch.Tensor:
    """(p[+1] - p[-1]) along ``axis`` with edge-clamped ghosts
    (finitediff.cpp:51-54): Neumann BC, zero normal gradient at the wall."""
    n = p.shape[axis]
    ext = torch.cat([p.narrow(axis, 0, 1), p, p.narrow(axis, n - 1, 1)],
                    dim=axis)
    return ext.narrow(axis, 2, n) - ext.narrow(axis, 0, n)


def divergence(vel: torch.Tensor, dx: float = 1.0) -> torch.Tensor:
    """div(v) with reflected-ghost walls (``finitediff.cpp:33-39``).
    vel: ``[nd, *shape]`` -> ``[*shape]``."""
    nd = vel.shape[0]
    flow = _shift_reflect_neg(vel[0], axis=0)
    for k in range(1, nd):
        flow = flow + _shift_reflect_neg(vel[k], axis=k)
    return flow * (1.0 / (2.0 * dx))


def subtract_gradient(vel: torch.Tensor, p: torch.Tensor,
                      dx: float = 1.0) -> torch.Tensor:
    """v <- v - grad(p), Neumann BC (``finitediff.cpp:75-82``)."""
    nd = vel.shape[0]
    two_dx_inv = 1.0 / (2.0 * dx)
    grads = [_shift_edge_clamp(p, axis=k) * two_dx_inv for k in range(nd)]
    return vel - torch.stack(grads, dim=0)

"""Finite-difference operators: divergence, gradient subtract, curl and
vorticity confinement (counterpart of
``esp32_fluid_simulation_tpu/ops/fd.py``).

* ``divergence`` — central differences with the reflected ghost velocity at
  the walls: an out-of-bounds neighbour contributes ``-v`` of the center
  cell (``finitediff.cpp:9-31``).
* ``subtract_gradient`` — ``v <- v - grad(p)`` with the Neumann pressure BC:
  the out-of-bounds pressure neighbour is clamped to the center value
  (``finitediff.cpp:41-73``).

* ``curl2d`` / ``curl3d`` / ``vorticity_confinement`` — edge-clamped
  central differences and the Fedkiw confinement force
  (``ops/fd.py:69-125``).

Divergence, gradient subtract and confinement are rank-polymorphic (2D/3D).
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


def curl2d(vel: torch.Tensor, dx: float = 1.0) -> torch.Tensor:
    """Scalar vorticity ``w = d(v1)/dx0 - d(v0)/dx1`` (edge-clamped central
    differences).  vel: ``[2, H, W]`` -> ``[H, W]``."""
    two_dx_inv = 1.0 / (2.0 * dx)
    return (_shift_edge_clamp(vel[1], axis=0)
            - _shift_edge_clamp(vel[0], axis=1)) * two_dx_inv


def curl3d(vel: torch.Tensor, dx: float = 1.0) -> torch.Tensor:
    """Vector vorticity ``w = curl(v)`` (edge-clamped central differences).
    vel: ``[3, D, H, W]`` -> ``[3, D, H, W]``."""
    inv = 1.0 / (2.0 * dx)

    def d(comp, axis):
        return _shift_edge_clamp(vel[comp], axis=axis) * inv

    return torch.stack([
        d(2, 1) - d(1, 2),   # w0 = dv2/dx1 - dv1/dx2
        d(0, 2) - d(2, 0),   # w1 = dv0/dx2 - dv2/dx0
        d(1, 0) - d(0, 1),   # w2 = dv1/dx0 - dv0/dx1
    ], dim=0)


def vorticity_confinement(vel: torch.Tensor, eps: float, dt: float,
                          dx: float = 1.0) -> torch.Tensor:
    """Add the Fedkiw-style vorticity-confinement force (2D or 3D):
    ``f = eps * dx * (N x w)``, ``N = grad|w| / (|grad|w|| + tiny)``, with
    ``tiny = 1e-6`` in the velocity dtype."""
    nd = vel.shape[0]
    two_dx_inv = 1.0 / (2.0 * dx)
    tiny = torch.tensor(1e-6, dtype=vel.dtype, device=vel.device)
    if nd == 2:
        w = curl2d(vel, dx)
        aw = torch.abs(w)
        g0 = _shift_edge_clamp(aw, axis=0) * two_dx_inv
        g1 = _shift_edge_clamp(aw, axis=1) * two_dx_inv
        mag = torch.sqrt(g0 * g0 + g1 * g1) + tiny
        n0, n1 = g0 / mag, g1 / mag
        # in 2D: N x (w z-hat) = (N1*w, -N0*w)
        f = torch.stack([n1 * w, -n0 * w], dim=0)
    else:
        w = curl3d(vel, dx)
        aw = torch.sqrt(w[0] * w[0] + w[1] * w[1] + w[2] * w[2])
        g = torch.stack([_shift_edge_clamp(aw, axis=k) * two_dx_inv
                         for k in range(3)], dim=0)
        mag = torch.sqrt(g[0] * g[0] + g[1] * g[1] + g[2] * g[2]) + tiny
        n = g / mag
        f = torch.stack([
            n[1] * w[2] - n[2] * w[1],
            n[2] * w[0] - n[0] * w[2],
            n[0] * w[1] - n[1] * w[0],
        ], dim=0)
    return vel + (eps * dx * dt) * f

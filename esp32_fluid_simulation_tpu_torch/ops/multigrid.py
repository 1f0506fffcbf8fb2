"""Geometric multigrid for the pressure Poisson equation (counterpart of
``esp32_fluid_simulation_tpu/ops/multigrid.py``).

Every level solves the reference's unit-stencil system
``nbr_sum(p) - a_ii*p = b`` (``poisson.cpp:63-90``; on the finest level
``b = dx*d``) with the red-black SOR sweep of ``ops.poisson`` as smoother.
The unit stencil at spacing 2h is 4x the one at h, so the restricted
residual is scaled by 4 when descending.  Coarsening averages 2^nd blocks
(edge-padded to even sizes); prolongation is cell-centred linear
interpolation.  Rank-polymorphic (2D and 3D): it serves the 2D
``poisson_solve(solver="multigrid")`` and ``SmokeConfig(solver=
"multigrid")``.
"""

from __future__ import annotations

import torch

from .poisson import sor_sweep, neighbor_sum, neighbor_count, _neg_inv_diag, \
    _parity


def _restrict(x: torch.Tensor) -> torch.Tensor:
    """Average non-overlapping 2^nd blocks (edge-padded to even sizes)."""
    for axis in range(x.dim()):
        n = x.shape[axis]
        if n % 2:
            x = torch.cat([x, x.narrow(axis, n - 1, 1)], dim=axis)
    for axis in range(x.dim()):
        n = x.shape[axis]
        shape = x.shape[:axis] + (n // 2, 2) + x.shape[axis + 1:]
        x = x.reshape(shape).mean(dim=axis + 1)
    return x


def _prolong(x: torch.Tensor, fine_shape) -> torch.Tensor:
    """Cell-centred linear prolongation back to ``fine_shape``: fine node
    2c blends (3/4)x[c] + (1/4)x[c-1], node 2c+1 blends (3/4)x[c] +
    (1/4)x[c+1] (edge-clamped), axis by axis."""
    for axis in range(x.dim()):
        n = x.shape[axis]
        lo = torch.cat([x.narrow(axis, 0, 1), x.narrow(axis, 0, n - 1)],
                       dim=axis)
        hi = torch.cat([x.narrow(axis, 1, n - 1), x.narrow(axis, n - 1, 1)],
                       dim=axis)
        even = 0.75 * x + 0.25 * lo
        odd = 0.75 * x + 0.25 * hi
        inter = torch.stack([even, odd], dim=axis + 1)
        x = inter.reshape(x.shape[:axis] + (2 * n,) + x.shape[axis + 1:])
    return x[tuple(slice(0, s) for s in fine_shape)]


def _residual_unit(p, b):
    a = neighbor_count(p.shape, p.dtype, device=p.device)
    return neighbor_sum(p) - a * p - b


def _coarse_shapes(shape, levels):
    shapes = [tuple(shape)]
    while len(shapes) < levels and min(shapes[-1]) > 3:
        shapes.append(tuple(-(-s // 2) for s in shapes[-1]))
    return shapes


def _vcycle(p, b, shapes, level, omega, n_pre, n_post, n_coarse):
    shape = shapes[level]
    neg_inv = _neg_inv_diag(shape, p.dtype, device=p.device)
    parity = _parity(shape, device=p.device)
    for _ in range(n_pre):
        p = sor_sweep(p, b, omega, 1.0, neg_inv, parity)
    if level + 1 < len(shapes):
        # error equation L(e) = -r (r = L(p) - b); the unit stencil at 2h
        # is 4x the one at h, hence the factor
        r = _residual_unit(p, b)
        b_c = -4.0 * _restrict(r)
        e_c = torch.zeros(shapes[level + 1], dtype=p.dtype, device=p.device)
        e_c = _vcycle(e_c, b_c, shapes, level + 1, omega, n_pre, n_post,
                      n_coarse)
        p = p + _prolong(e_c, shape)
        for _ in range(n_post):
            p = sor_sweep(p, b, omega, 1.0, neg_inv, parity)
    else:
        for _ in range(n_coarse):
            p = sor_sweep(p, b, omega, 1.0, neg_inv, parity)
    return p


def multigrid_solve(d: torch.Tensor, dx: float = 1.0, cycles: int = 2,
                    levels: int = 0, omega: float = 1.3, n_pre: int = 2,
                    n_post: int = 2, n_coarse: int = 16,
                    p0: torch.Tensor | None = None) -> torch.Tensor:
    """Solve the reference system (zero init) with V-cycles.  ``levels=0``
    coarsens until min(shape) <= 3.  ``omega`` is the smoother's
    relaxation, capped at 1.3."""
    omega = min(omega, 1.3)
    if levels <= 0:
        levels = 32
    shapes = _coarse_shapes(d.shape, levels)
    b = dx * d
    p = torch.zeros_like(d) if p0 is None else p0
    for _ in range(cycles):
        p = _vcycle(p, b, shapes, 0, omega, n_pre, n_post, n_coarse)
    return p

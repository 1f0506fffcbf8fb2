"""Poisson pressure solvers: checkerboard red-black SOR, Jacobi, the
residual-targeted adaptive SOR, residuals, and the solver dispatch
(counterpart of ``esp32_fluid_simulation_tpu/ops/poisson.py``).

Semantics reproduced exactly:

* pressure zero-initialized every solve (``poisson.cpp:117-119``);
* sweep = even-parity pass then odd-parity pass (``poisson.cpp:10-27``);
* Gauss-Seidel update with the variable diagonal ``a_ii`` = number of
  in-bounds neighbours, through a ``-1/a_ii`` LUT of double divisions
  rounded to float (``poisson.cpp:63-90``);
* SOR blend ``p <- (1-w)p + w*p_gs`` (``poisson.cpp:92-112``);
* neighbour sums accumulated as ``((up + dn) + lf) + rt`` (axis-0 low,
  axis-0 high, axis-1 low, axis-1 high, ...).

Each half-sweep is one masked whole-grid update; the black half reads the
freshly updated red cells, which is exact red-black Gauss-Seidel.
"""

from __future__ import annotations

import torch


def _shift_zero(p: torch.Tensor, axis: int, direction: int) -> torch.Tensor:
    """Neighbour value along ``axis`` with zero ghosts outside the domain."""
    n = p.shape[axis]
    zeros = torch.zeros_like(p.narrow(axis, 0, 1))
    if direction < 0:
        return torch.cat([zeros, p.narrow(axis, 0, n - 1)], dim=axis)
    return torch.cat([p.narrow(axis, 1, n - 1), zeros], dim=axis)


def neighbor_sum(p: torch.Tensor) -> torch.Tensor:
    """Sum of the 2*nd face neighbours, zero outside the domain, in the
    reference's order (``poisson.cpp:70-86, 107``)."""
    total = None
    for axis in range(p.dim()):
        for direction in (-1, 1):
            nb = _shift_zero(p, axis, direction)
            total = nb if total is None else total + nb
    return total


def _axis_index(shape, axis, device):
    view = [1] * len(shape)
    view[axis] = shape[axis]
    return torch.arange(shape[axis], device=device).view(view)


def neighbor_count(shape, dtype=torch.float32, *, device) -> torch.Tensor:
    """a_ii: number of in-bounds face neighbours per node
    (``poisson.cpp:71-86``)."""
    a = torch.zeros(tuple(shape), dtype=torch.int64, device=device)
    for axis in range(len(shape)):
        idx = _axis_index(shape, axis, device)
        a = a + 2 - (idx == 0).long() - (idx == shape[axis] - 1).long()
    return a.to(dtype)


def neg_inv_of(a_ii: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """-1/a_ii of an integer neighbour count ``a_ii`` (1 to 6), matching
    ``neg_a_ii_inv`` (``poisson.cpp:67``): the LUT entries are double
    divisions rounded to float."""
    lut = torch.tensor([-1.0 / k for k in range(1, 7)],
                       dtype=torch.float64).to(torch.float32)
    return lut.to(device=a_ii.device)[a_ii - 1].to(dtype)


def _neg_inv_diag(shape, dtype=torch.float32, *, device) -> torch.Tensor:
    """-1/a_ii of the grid ``shape`` as a tensor (``neg_inv_of``)."""
    return neg_inv_of(neighbor_count(shape, torch.int64, device=device),
                      dtype)


def _parity(shape, *, device) -> torch.Tensor:
    """(i + j + ...) % 2 checkerboard parity (``poisson.cpp:10-12``)."""
    par = torch.zeros(tuple(shape), dtype=torch.int64, device=device)
    for axis in range(len(shape)):
        par = par + _axis_index(shape, axis, device)
    return par % 2


def sor_sweep(p: torch.Tensor, d: torch.Tensor, omega: float,
              dx: float = 1.0, neg_inv: torch.Tensor | None = None,
              parity: torch.Tensor | None = None) -> torch.Tensor:
    """One full red-black SOR sweep (even half then odd half)."""
    if neg_inv is None:
        neg_inv = _neg_inv_diag(p.shape, p.dtype, device=p.device)
    if parity is None:
        parity = _parity(p.shape, device=p.device)
    for color in (0, 1):
        gs = neg_inv * (dx * d - neighbor_sum(p))
        p_new = (1.0 - omega) * p + omega * gs
        p = torch.where(parity == color, p_new, p)
    return p


def sor_solve(d: torch.Tensor, dx: float = 1.0, iters: int = 10,
              omega: float = 1.96, p0: torch.Tensor | None = None):
    """Solve lap(p) = d (``poisson.cpp:114-125``), zero-initialized."""
    p = torch.zeros_like(d) if p0 is None else p0
    neg_inv = _neg_inv_diag(d.shape, d.dtype, device=d.device)
    parity = _parity(d.shape, device=d.device)
    for _ in range(iters):
        p = sor_sweep(p, d, omega, dx, neg_inv, parity)
    return p


def jacobi_solve(d: torch.Tensor, dx: float = 1.0, iters: int = 20,
                 omega: float = 1.0, p0: torch.Tensor | None = None):
    """Order-free (damped) Jacobi (``poisson.py:132-142``): every cell
    updates from the previous iterate, ``p <- (1-w)p + w*p_gs``."""
    p = torch.zeros_like(d) if p0 is None else p0
    neg_inv = _neg_inv_diag(d.shape, d.dtype, device=d.device)
    for _ in range(iters):
        gs = neg_inv * (dx * d - neighbor_sum(p))
        p = (1.0 - omega) * p + omega * gs
    return p


def sor_solve_adaptive(d: torch.Tensor, dx: float = 1.0, max_iters: int = 50,
                       omega: float = 1.96, tol: float = 1e-3,
                       check_every: int = 2,
                       p0: torch.Tensor | None = None):
    """Residual-targeted RB-SOR (``poisson.py:145-189``): sweep in chunks of
    ``check_every`` (clamped to at least 1, as the JAX contract does) and
    stop once the residual L2 norm drops below ``tol`` or ``max_iters``
    sweeps ran.  Returns ``(p, iters_done, residual_l2)``: ``iters_done`` a
    Python int, ``residual_l2`` a 0-dim float32 tensor on ``d``'s device.

    The JAX version is one ``lax.while_loop`` on the device.  This eager
    loop reads the residual on the host once per chunk (one device sync per
    ``check_every`` sweeps), which the JAX version does not."""
    check_every = max(1, int(check_every))
    p = torch.zeros_like(d) if p0 is None else p0
    neg_inv = _neg_inv_diag(d.shape, d.dtype, device=d.device)
    parity = _parity(d.shape, device=d.device)
    tol2 = torch.tensor(tol, dtype=torch.float32, device=d.device) ** 2

    def res2(p):
        r = poisson_residual(p, d, dx).to(torch.float32)
        return torch.mean(r * r)

    it = 0
    r2 = res2(p)
    while it < max_iters and bool(r2 > tol2):
        n = min(check_every, max_iters - it)
        for _ in range(n):
            p = sor_sweep(p, d, omega, dx, neg_inv, parity)
        it += n
        r2 = res2(p)
    return p, it, torch.sqrt(r2)


def poisson_residual(p: torch.Tensor, d: torch.Tensor,
                     dx: float = 1.0) -> torch.Tensor:
    """Pointwise residual: nbr_sum - a_ii*p - dx*d."""
    a = neighbor_count(p.shape, p.dtype, device=p.device)
    return neighbor_sum(p) - a * p - dx * d


def poisson_solve(d: torch.Tensor, cfg) -> torch.Tensor:
    """Solver dispatch by ``cfg.solver`` (``poisson.py:199-219``)."""
    if cfg.solver == "sor":
        return sor_solve(d, cfg.dx, cfg.sor_iters, cfg.omega)
    if cfg.solver == "sor_adaptive":
        p, _, _ = sor_solve_adaptive(d, cfg.dx, cfg.sor_iters, cfg.omega,
                                     tol=cfg.sor_tol,
                                     check_every=cfg.sor_check_every)
        return p
    if cfg.solver == "jacobi":
        # Jacobi diverges for omega > 1 (no Gauss-Seidel coupling to damp
        # the over-relaxation), so the SOR omega is capped at 1 here
        return jacobi_solve(d, cfg.dx, cfg.sor_iters, min(cfg.omega, 1.0))
    if cfg.solver == "sor_pallas":
        from .cuda.sor import sor_solve_kernel
        return sor_solve_kernel(d, cfg.dx, cfg.sor_iters, cfg.omega)
    if cfg.solver == "multigrid":
        from .multigrid import multigrid_solve
        return multigrid_solve(d, cfg.dx, cycles=cfg.mg_cycles,
                               levels=cfg.mg_levels, omega=cfg.omega)
    raise ValueError(f"unknown solver {cfg.solver!r}")

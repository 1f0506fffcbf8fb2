"""K4: the whole 2D red-black SOR pressure solve on the GPU
(``csrc/sor.cu``).

Replaces ``esp32_fluid_simulation_tpu/ops/pallas/sor.py:sor_solve_pallas``
(single device; its block mode is K11).  ``sor_solve_kernel`` launches the
CUDA kernels for CUDA tensors and runs ``sor_solve_reference``, its plain
PyTorch version (``ops.poisson.sor_solve``: zero init, even parity first,
the same neighbour order and ``-1/a_ii`` LUT), for CPU tensors — only
because they lie on the CPU.  Any other device raises.  The half-sweep is
K1's (``csrc/rb2d.cuh``).

``member=(mh, mw)`` (K6, ``sor.py:83``, ``rb_common.py:145-176``): every
member tile of the grid is solved on its own — neighbour sums read 0 across
member walls and ``a_ii`` counts member-local neighbours — while the colour
stays the parity of the whole grid, as in the TPU kernel.  Its plain
version is therefore a masked solve over the whole grid, not the solve of
each member alone; ``sor_solve_kernel.member_launches`` counts its
launches.
"""

from __future__ import annotations

import numpy as np
import torch

from ..poisson import _parity, _shift_zero, sor_solve
from .build import load, stream_of
from .modes import check_member, refuse_unported


def member_walls(shape, member, device):
    """``(i_lo, i_hi, j_lo, j_hi)``: boolean masks (broadcasting to
    ``shape``) of the cells on each wall of their ``(mh, mw)`` member
    tile."""
    mh, mw = member
    i = torch.arange(shape[0], device=device)[:, None] % mh
    j = torch.arange(shape[1], device=device)[None, :] % mw
    return i == 0, i == mh - 1, j == 0, j == mw - 1


def member_sor_solve(d, dx, iters, omega, walls):
    """``sor_solve`` with zero ghosts and ``a_ii`` at the member ``walls``
    and the whole grid's parity (``ops.poisson.sor_sweep``'s arithmetic)."""
    i_lo, i_hi, j_lo, j_hi = walls
    aii = 4 - (i_lo.long() + i_hi.long() + j_lo.long() + j_hi.long())
    lut = torch.tensor([-1.0 / k for k in range(1, 5)],
                       dtype=torch.float64).to(torch.float32)
    neg_inv = lut.to(d.device)[aii - 1].to(d.dtype)
    parity = _parity(d.shape, device=d.device)
    p = torch.zeros_like(d)
    for _ in range(iters):
        for color in (0, 1):
            nb = (((torch.where(i_lo, 0.0, _shift_zero(p, 0, -1))
                    + torch.where(i_hi, 0.0, _shift_zero(p, 0, 1)))
                   + torch.where(j_lo, 0.0, _shift_zero(p, 1, -1)))
                  + torch.where(j_hi, 0.0, _shift_zero(p, 1, 1)))
            gs = neg_inv * (dx * d - nb)
            p_new = (1.0 - omega) * p + omega * gs
            p = torch.where(parity == color, p_new, p)
    return p


def sor_solve_reference(d, dx=1.0, iters=10, omega=1.96, member=None):
    """Plain PyTorch version: ``ops.poisson.sor_solve`` in 2D, or its
    member-masked form."""
    if member is None:
        return sor_solve(d, dx, iters, omega)
    return member_sor_solve(d, dx, iters, omega,
                            member_walls(d.shape, member, d.device))


def sor_solve_kernel(d: torch.Tensor, dx: float = 1.0, iters: int = 10,
                     omega: float = 1.96, member=None,
                     **unported) -> torch.Tensor:
    """Pressure ``p`` with ``lap(p) = d`` after ``iters`` red-black SOR
    sweeps from zero, for an ``[H, W]`` float32 ``d`` (per member tile with
    ``member``)."""
    refuse_unported("sor_solve_kernel", unported)
    if d.dim() != 2:
        raise ValueError("sor_solve_kernel: d must be [H, W]")
    member = check_member("sor_solve_kernel", member, *d.shape)
    if d.device.type == "cpu":
        return sor_solve_reference(d, dx, iters, omega, member)
    if not d.is_cuda:
        raise ValueError(f"sor_solve_kernel: unsupported device {d.device}")
    if d.dtype != torch.float32:
        raise ValueError("sor_solve_kernel: d must be float32 [H, W]")
    if not d.is_contiguous():
        raise ValueError("sor_solve_kernel: d must be contiguous")
    h, w = d.shape
    # the half-sweeps put rows on grid.y, 8 a block, at most 65535 blocks
    if h < 2 or w < 2 or h > 8 * 65535 or iters < 0:
        raise ValueError(f"sor_solve_kernel: shape {tuple(d.shape)} / iters "
                         f"{iters} not supported (2 <= H <= 524280, W >= 2, "
                         "iters >= 0)")
    mh, mw = member or (0, 0)
    p = torch.empty_like(d)
    dxd = torch.empty_like(d)
    lib = load()
    with torch.cuda.device(d.device):
        lib.call("fluid_sor", d.data_ptr(), p.data_ptr(), dxd.data_ptr(), h,
                 w, mh, mw, float(dx), int(iters), float(omega),
                 float(np.float32(1.0 - omega)), stream_of(d))
    sor_solve_kernel.launches += 1
    sor_solve_kernel.member_launches += member is not None
    return p


sor_solve_kernel.launches = 0
sor_solve_kernel.member_launches = 0

"""K9: the 3D red-black SOR pressure solve on the GPU (``csrc/sor3d.cu``).

Replaces ``esp32_fluid_simulation_tpu/ops/pallas/sor3d.py:
sor3d_packed_pallas`` (single device) and its block mode ``_sor3d_chunk``
(K11).  ``sor3d_solve`` and ``sor3d_chunk`` launch the CUDA kernels for
CUDA tensors and run their plain PyTorch versions, ``sor3d_reference``
(``ops.poisson.sor_solve``: zero init, even parity first, the same
neighbour order and ``-1/a_ii`` LUT) and ``sor3d_chunk_reference``, for
CPU tensors — only because they lie on the CPU.  Any other device raises.

The kernel runs the half-sweeps in passes, one launch each
(``csrc/sor3d.cu``): a block marches z through its tile's window, a thread
a quad of four cells of a window row with the quad's last planes in its
registers, and fuses ``depth`` half-sweeps, a trapezoid of ``depth`` cells
a side, with one barrier a plane.  ``pass_plan`` picks the passes, the tile
and the planes a block marches from the shape, the number of half-sweeps
and the card's streaming multiprocessors: the fewest passes of at most
``SOR3D_MAX_DEPTH`` (``ceil(2*iters / 6)``, 4 passes of 5 at the plume's 10
iters), and of the tiles whose block fits ``SOR3D_MAX_THREADS`` the one
whose waves of blocks march the fewest warp-planes; the result does not
depend on any of them.  ``chunk`` (sweeps per TPU launch) does not change
the result there either and has no counterpart here; it is validated as
the JAX contract validates it.

``sor3d_chunk`` is one chunk of the sharded steps' solve
(``parallel/sharded3d.py``): ``sweeps`` sweeps on a whole haloed block
from the ``p`` it is given, with the walls, ``a_ii``, the parity ``(gz +
gi + gj) & 1`` and the domain of ``global_shape``; ``global_offset`` is
the **haloed** array's global origin ``(oz, oi, oj)``.  Cells outside the
domain hold 0 and neighbours there or beyond the array read 0.  The
outer ``2*sweeps`` rings of the result are not the whole grid's (in the
TPU kernel they also depend on its padding); the cells inside them are.
It runs the same passes from the given ``p`` (one launch at the sharded
chain's 3 sweeps).  The TPU kernel's ``chunk <= 64`` lane limit and its
tile sizes have no counterpart here.  ``sor3d_chunk.launches`` and
``sor3d_solve.launches`` count their calls.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..poisson import _shift_zero, neg_inv_of, sor_solve
from ...spans import span
from .build import launch
from .modes import F32, check_launch, chunk_geometry

_LANE = 128  # the TPU kernel's fixed column halo, which bounds ``chunk``
# The deepest pass (half-sweeps fused in one launch): the sharded chain's
# chunk of 3 sweeps is one pass
SOR3D_MAX_DEPTH = 6
# A block's most threads (``csrc/sor3d.cu`` ``kMaxThreads``): a thread
# keeps its quad's last planes of p and d in registers, at most 128 of
# them, so one block fills an SM's registers
SOR3D_MAX_THREADS = 512
# The tiles a pass may take: (rows, columns) of the array's (i, j) a block
# owns, the columns a multiple of 4 (a window row is whole quads)
SOR3D_TILES = tuple((th, tw) for th in range(8, 65, 4)
                    for tw in range(16, 65, 4))
# A block of fewer warps marches a plane no faster than one of this many:
# each level of a plane waits on the one before it in the same thread
SOR3D_MIN_WARPS = 12


def margin(depth):
    """A window's columns on either side of the tile: ``depth`` rounded up
    to a multiple of 4, so a window row starts on a 16-byte boundary."""
    return -(-depth // 4) * 4


def pass_threads(tile, depth):
    """A block's threads for a pass of ``depth`` on ``tile`` (``csrc/
    sor3d.cu`` ``pass_threads``): one a quad of the window (the tile +-
    ``depth`` rows, +- ``margin(depth)`` columns), the even rows' padded to
    whole warps."""
    th, tw = tile
    rows = th + 2 * depth
    quads = -(-(tw + 2 * margin(depth)) // 4)
    even = -(-((rows + 1) // 2 * quads) // 32) * 32
    return -(-(even + rows // 2 * quads) // 32) * 32


def pass_depths(levels, deepest):
    """``levels`` half-sweeps as the fewest passes of at most ``deepest``,
    their depths as even as they come (one pass of depth 0 for none)."""
    n = max(1, -(-levels // deepest))
    return [levels // n + (k < levels % n) for k in range(n)]


@functools.lru_cache(maxsize=64)
def pass_plan(shape, levels, sms):
    """``(tile, zchunk, depths)`` for ``levels`` half-sweeps on a ``[D, H,
    W]`` array on a card of ``sms`` streaming multiprocessors (a block
    each): the fewest passes of at most ``SOR3D_MAX_DEPTH``, and of
    ``SOR3D_TILES`` and the chunks of planes the pair whose waves of blocks
    march the fewest warp-planes (a block marches its chunk + 2 * depth
    planes); of equal ones, the fewest window cells to load."""
    depths = pass_depths(levels, SOR3D_MAX_DEPTH)
    s = max(depths)
    d, h, w = shape
    best = None
    for tile in SOR3D_TILES:
        threads = pass_threads(tile, s)
        if threads > SOR3D_MAX_THREADS:
            continue
        tiles = -(-h // tile[0]) * -(-w // tile[1])
        window = tiles * (tile[0] + 2 * s) * (tile[1] + 2 * margin(s))
        warps = max(threads // 32, SOR3D_MIN_WARPS)
        for n in range(1, min(d, -(-4 * sms // tiles)) + 1):
            zc = -(-d // n)
            cost = -(-tiles * -(-d // zc) // sms) * (zc + 2 * s) * warps
            key = (cost, window, tile, zc)
            if best is None or key < best:
                best = key
    return best[2], best[3], depths


@functools.lru_cache(maxsize=None)
def sm_count(index):
    """Streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def sor3d_reference(d, dx=1.0, iters=10, omega=1.5):
    """Plain PyTorch version: ``ops.poisson.sor_solve`` in 3D."""
    return sor_solve(d, dx, iters, omega)


def walls3(g, shape):
    """``((z_lo, z_hi), (i_lo, i_hi), (j_lo, j_hi))`` masks of the cells at
    global indices ``g`` (three broadcasting index tensors) on each wall of
    the domain ``shape``."""
    return [(x == 0, x == n - 1) for x, n in zip(g, shape)]


def aii3(g, shape):
    """The Neumann diagonal (in-domain neighbour count, int64) at ``g``."""
    return 6 - sum(lo.long() + hi.long() for lo, hi in walls3(g, shape))


def sor3d_chunk_reference(d, p, dx, sweeps, omega, origin, domain):
    """Plain PyTorch version of ``sor3d_chunk`` (``ops.poisson.sor_sweep``'s
    arithmetic with the domain's walls, parity and mask)."""
    dev = d.device
    g = [torch.arange(n, device=dev).view([-1 if a == k else 1
                                           for a in range(3)]) + o
         for k, (n, o) in enumerate(zip(d.shape, origin))]
    in_dom = ((g[0] >= 0) & (g[0] < domain[0]) & (g[1] >= 0)
              & (g[1] < domain[1]) & (g[2] >= 0) & (g[2] < domain[2]))
    walls = walls3(g, domain)
    neg_inv = neg_inv_of(aii3(g, domain), d.dtype)
    parity = (g[0] + g[1] + g[2]) & 1
    p = torch.where(in_dom, p, 0.0)
    for _ in range(sweeps):
        for color in (0, 1):
            nb = None
            for axis, (lo, hi) in enumerate(walls):
                for wall, direction in ((lo, -1), (hi, 1)):
                    x = torch.where(wall, 0.0, _shift_zero(p, axis,
                                                           direction))
                    nb = x if nb is None else nb + x
            p_new = (1.0 - omega) * p + omega * (neg_inv * (dx * d - nb))
            p = torch.where((parity == color) & in_dom, p_new, p)
    return p


def _passes(name, d, p, dx, levels, omega, origin, domain):
    """``levels`` half-sweeps from ``p`` (None: from zero) on a CUDA ``d``,
    one launch per pass, into a fresh tensor."""
    check_launch(name, d=(d, F32), p=(p, F32))
    dd, h, w = d.shape
    if min(dd, h, w) < 2 or dd * h * w >= 1 << 31:
        raise ValueError(f"{name}: shape {tuple(d.shape)} not supported "
                         "(each extent >= 2, D * H * W < 2^31)")
    (th, tw), zc, depths = pass_plan(tuple(d.shape), levels,
                                     sm_count(d.device.index))
    if -(-h // th) > 65535:
        raise ValueError(f"{name}: H = {h} > {65535 * th}")
    out = torch.empty_like(d)
    # ping-pong: the last pass writes out
    scratch = torch.empty_like(d) if len(depths) > 1 else None
    # 16-byte loads and stores: rows start aligned in every array
    vec = int(w % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in
                                 (d, out, p, scratch) if t is not None))
    src, h0 = p, 0
    for k, depth in enumerate(depths):
        dst = out if (len(depths) - 1 - k) % 2 == 0 else scratch
        launch("fluid_sor3d_pass", d, d, src, dst, dd, h, w, *origin, *domain,
               float(dx), h0, depth, float(omega),
               float(np.float32(1.0 - omega)), th, tw, zc, vec)
        src, h0 = dst, h0 + depth
    return out


def sor3d_chunk(d: torch.Tensor, p: torch.Tensor, dx: float, sweeps: int,
                omega: float, global_offset=None,
                global_shape=None) -> torch.Tensor:
    """``sweeps`` red-black SOR sweeps of ``lap(p) = d`` on a ``[D, H, W]``
    float32 block from ``p``, as a fresh tensor (module docstring)."""
    if d.dim() != 3 or tuple(p.shape) != tuple(d.shape):
        raise ValueError("sor3d_chunk: d and p must be [D, H, W] of one "
                         "shape")
    origin, domain = chunk_geometry("sor3d_chunk", global_offset,
                                    global_shape, d.shape)
    if sweeps < 0:
        raise ValueError(f"sor3d_chunk: sweeps={sweeps} must be >= 0")
    if d.device.type == "cpu":
        return sor3d_chunk_reference(d, p, dx, sweeps, omega, origin, domain)
    out = _passes("sor3d_chunk", d, p, dx, 2 * sweeps, omega, origin, domain)
    sor3d_chunk.launches += 1
    return out


sor3d_chunk.launches = 0


def sor3d_solve(d: torch.Tensor, dx: float = 1.0, iters: int = 10,
                omega: float = 1.5, chunk: int = 3) -> torch.Tensor:
    """Pressure ``p`` with ``lap(p) = d`` after ``iters`` red-black SOR
    sweeps from zero, for a ``[D, H, W]`` float32 ``d``.  ``chunk`` is the
    TPU kernel's sweeps per launch: validated, and without effect here (the
    kernel picks its own pass depth, module docstring)."""
    with span("fluid.k9.sor3d"):
        if chunk < 1:
            raise ValueError(f"chunk={chunk} must be >= 1")
        need = 2 * min(chunk, iters)
        if need > _LANE:
            raise ValueError(
                f"chunk={chunk} needs a {need}-lane column halo > the fixed "
                f"{_LANE}-lane panel; use chunk <= {_LANE // 2}")
        if d.device.type == "cpu":
            return sor3d_reference(d, dx, iters, omega)
        if d.dim() != 3:
            raise ValueError("sor3d_solve: d must be float32 [D, H, W]")
        if iters < 0:
            raise ValueError(f"sor3d_solve: iters={iters} must be >= 0")
        p = _passes("sor3d_solve", d, None, dx, 2 * iters, omega, (0, 0, 0),
                    tuple(d.shape))
        sor3d_solve.launches += 1
        return p


sor3d_solve.launches = 0

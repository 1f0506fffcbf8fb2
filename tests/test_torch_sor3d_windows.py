"""The schedule of K9's z-marching pass, on the CPU.

``csrc/sor3d.cu`` runs the 3D red-black SOR in passes of ``depth``
half-sweeps, one launch each.  A block owns a ``th x tw`` tile of the
array's (i, j) cells and a chunk of planes, holds the tile +- ``depth``
cells of one plane at a time in a ring of ``depth + 3`` planes of p (and
of d), and marches z: at step t, level k updates plane ``zlo + 2 + t - k``
in place, the levels of a step in order, level k only on the window's
``[k, rows - k) x [k, cols - k)`` and the planes ``[z0 - depth + k, z1 +
depth - k)``.  The step first stores the plane the last level finished,
then fills the ring slot of the plane level 1 reads next.

This test runs that schedule with plain tensor ops on the same ring (a
slot overwritten too early shows as a wrong value), stitches the tiles and
chunks, chains the passes through a fresh array each, and holds the result
bit for bit to ``sor3d_reference`` (whole grid from zero) and to
``sor3d_chunk_reference`` (a haloed block of a larger domain from a given
p, every cell compared): the schedule computes exactly the sequential
half-sweeps, whatever the depth, the tile and the chunk of planes.
"""

import numpy as np
import pytest
import torch

from esp32_fluid_simulation_tpu_torch.ops.cuda.sor3d import (
    pass_depths, sor3d_chunk_reference, sor3d_reference)
from esp32_fluid_simulation_tpu_torch.ops.poisson import neg_inv_of

torch.set_num_threads(1)

OMEGA = 1.5
DX = 0.7


def _axis(n, o, gn, x0, size):
    """Window indices ``x0 + [0, size)`` of an axis of ``n`` cells whose
    cell 0 sits at global ``o`` of ``gn``: the indices clamped into the
    array, the inside mask and the wall count."""
    x = torch.arange(size) + x0
    gx = x + o
    inside = (x >= 0) & (x < n) & (gx >= 0) & (gx < gn)
    return x.clamp(0, n - 1), inside, (gx == 0).long() + (gx == gn - 1).long()


def _shifted(x, axis, direction):
    """x's neighbour along ``axis`` (0 beyond the window: never used)."""
    return torch.roll(x, -direction, axis)


def _pass(d, p_in, origin, domain, h0, depth, tile, zc):
    """One pass of ``depth`` half-sweeps (the first of global index h0)
    as the kernel schedules it; p_in None: from zero."""
    n_z, n_i, n_j = d.shape
    (oz, oi, oj), (gd, gh, gw) = origin, domain
    s, ring_n = depth, depth + 3
    out = torch.full_like(d, float("nan"))
    for z0 in range(0, n_z, zc):
        z1 = min(z0 + zc, n_z)
        zlo, zhi = max(z0 - s, -1), min(z1 + s, n_z + 1)
        for t0 in range(0, n_i, tile[0]):
            for u0 in range(0, n_j, tile[1]):
                th, tw = min(tile[0], n_i - t0), min(tile[1], n_j - u0)
                rows, cols = th + 2 * s, tw + 2 * s
                ic, i_in, i_walls = _axis(n_i, oi, gh, t0 - s, rows)
                jc, j_in, j_walls = _axis(n_j, oj, gw, u0 - s, cols)
                cell_in = i_in[:, None] & j_in[None, :]
                gij = (torch.arange(rows)[:, None] + t0 - s + oi
                       + torch.arange(cols)[None, :] + u0 - s + oj)
                ring_p = torch.zeros(ring_n, rows, cols)
                ring_d = torch.zeros(ring_n, rows, cols)

                def slot(z):
                    return (z - zlo) % ring_n

                def plane(z):
                    gz = z + oz
                    inside = 0 <= z < n_z and 0 <= gz < gd
                    return inside, int(gz == 0) + int(gz == gd - 1)

                def load(z):
                    inside, _ = plane(z)
                    ring_p[slot(z)] = 0.0
                    ring_d[slot(z)] = 0.0
                    if inside:
                        ring_d[slot(z)] = torch.where(
                            cell_in, d[z][ic][:, jc], 0.0)
                        if p_in is not None:
                            ring_p[slot(z)] = torch.where(
                                cell_in, p_in[z][ic][:, jc], 0.0)

                def level(k, z):
                    inside, z_walls = plane(z)
                    if not inside:
                        return
                    pc = ring_p[slot(z)]
                    nb = ((((ring_p[slot(z - 1)] + ring_p[slot(z + 1)])
                            + _shifted(pc, 0, -1)) + _shifted(pc, 0, 1))
                          + _shifted(pc, 1, -1)) + _shifted(pc, 1, 1)
                    neg_inv = neg_inv_of(6 - z_walls - i_walls[:, None]
                                         - j_walls[None, :])
                    p_new = (1.0 - OMEGA) * pc + OMEGA * (
                        neg_inv * (DX * ring_d[slot(z)] - nb))
                    region = torch.zeros(rows, cols, dtype=torch.bool)
                    region[k:rows - k, k:cols - k] = True
                    colour = (z + oz + gij) & 1 == (h0 + k - 1) & 1
                    ring_p[slot(z)] = torch.where(region & colour & cell_in,
                                                  p_new, pc)

                load(zlo)
                load(zlo + 1)
                for t in range(-1, z1 - 1 - zlo + s):
                    z_done = zlo + 1 + t - s
                    if z0 <= z_done < z1:
                        out[z_done, t0:t0 + th, u0:u0 + tw] = ring_p[
                            slot(z_done)][s:s + th, s:s + tw]
                    if zlo + t + 3 < zhi:
                        load(zlo + t + 3)
                    for k in range(1, s + 1):
                        z = zlo + 2 + t - k
                        if max(z0 - s + k, 0) <= z < min(z1 + s - k, n_z):
                            level(k, z)
    return out


def _scheduled(d, p, levels, deepest, tile, zc, origin=(0, 0, 0),
               domain=None):
    """``levels`` half-sweeps as passes of at most ``deepest``."""
    domain = tuple(d.shape) if domain is None else domain
    h0 = 0
    for depth in pass_depths(levels, deepest):
        p = _pass(d, p, origin, domain, h0, depth, tile, zc)
        h0 += depth
    return p


def _field(shape, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


# (grid, iters, deepest pass, tile, planes per chunk)
WHOLE = {
    "10x20x28-iters10-depth6": ((10, 20, 28), 10, 6, (7, 12), 10),
    "10x20x28-iters10-depth6-zchunk4": ((10, 20, 28), 10, 6, (7, 12), 4),
    "10x20x28-iters4-depth2": ((10, 20, 28), 4, 2, (16, 10), 3),
    "10x20x28-iters3-depth1": ((10, 20, 28), 3, 1, (7, 12), 10),
    "9x33x41-iters5-depth6": ((9, 33, 41), 5, 6, (13, 17), 9),
    "9x33x41-iters7-depth6-zchunk2": ((9, 33, 41), 7, 6, (8, 32), 2),
    "9x33x41-iters1-depth2": ((9, 33, 41), 1, 2, (33, 41), 9),
    "9x33x41-iters0": ((9, 33, 41), 0, 6, (13, 17), 4),
}


@pytest.mark.parametrize("case", list(WHOLE))
def test_whole_grid_passes_equal_the_sequential_solve(case):
    shape, iters, deepest, tile, zc = WHOLE[case]
    d = _field(shape, sum(shape) + iters)
    want = sor3d_reference(d, DX, iters, OMEGA)
    got = _scheduled(d, None, 2 * iters, deepest, tile, zc)
    assert torch.equal(got, want)


# (block, origin, domain, sweeps, deepest pass, tile, planes per chunk):
# an edge shard's haloed block (negative origin), a far shard's, and one
# that starts off the vertical origin
BLOCKS = {
    "edge-sweeps3-depth6": ((10, 32, 37), (0, -6, -6), (10, 40, 50), 3, 6,
                            (9, 16), 10),
    "edge-sweeps4-depth3-zchunk4": ((10, 32, 37), (0, -8, -8), (10, 40, 50),
                                    4, 3, (12, 12), 4),
    "far-sweeps3-depth6": ((10, 32, 37), (0, 14, 19), (10, 40, 50), 3, 6,
                           (16, 16), 5),
    "shifted-z-sweeps2-depth1": ((9, 20, 24), (2, 5, -3), (14, 40, 50), 2,
                                 1, (7, 12), 9),
    "edge-sweeps0": ((10, 32, 37), (0, -6, -6), (10, 40, 50), 0, 6,
                     (9, 16), 4),
}


@pytest.mark.parametrize("case", list(BLOCKS))
def test_block_passes_equal_the_chunk_reference(case):
    shape, origin, domain, sweeps, deepest, tile, zc = BLOCKS[case]
    d = _field(shape, 11 + sweeps)
    p = _field(shape, 12 + sweeps)
    want = sor3d_chunk_reference(d, p, DX, sweeps, OMEGA, origin, domain)
    got = _scheduled(d, p, 2 * sweeps, deepest, tile, zc, origin, domain)
    assert torch.equal(got, want)


@pytest.mark.parametrize("levels, deepest, want", [
    (20, 6, [5, 5, 5, 5]), (6, 6, [6]), (7, 3, [3, 2, 2]), (0, 6, [0]),
    (20, 20, [20]), (2, 6, [2])])
def test_pass_depths_are_even_and_few(levels, deepest, want):
    assert pass_depths(levels, deepest) == want

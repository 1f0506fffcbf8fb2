"""The schedule of K9's z-marching pass, on the CPU.

``csrc/sor3d.cu`` runs the 3D red-black SOR in passes of ``depth``
half-sweeps, one launch each.  A block owns a ``th x tw`` tile of the
array's (i, j) cells and a chunk of planes; its window is the tile +-
``depth`` rows and +- ``margin(depth)`` columns, cut into quads of four
cells of a row, a quad a thread.  A thread marches z with its quad's last
planes of p and dx * d in a ring of registers (slot ``x % R`` holds plane
``zlo + x``); at step t plane ``zlo + t + 2`` enters from the staging slot
the copy engine filled three steps before, and level k updates plane ``zlo + 2 +
t - k`` in place, the quad's two cells of the step's colour, only on the
window's rows and columns within ``depth - k`` of the tile and the planes
``[z0 - depth + k, z1 + depth - k)``.  Its z-neighbours and the quad's
other cells are its own registers; the cells of the quads above, below,
left and right come from the buffer level k - 1 published in the previous
step (the pass's input for level 1), which holds that level's cells of
its colour.  The plane the last level finished is stored in the same step.

This test runs that schedule with plain tensor ops, the whole window of
quads at once: the ring's slots start as NaN and a buffer holds NaN but
in the cells of the colour it was published for, so a read of a slot or a
buffer before it is written, or of the wrong one, shows as a wrong value.
It stitches the tiles and chunks, chains the passes through a fresh array
each, and holds the result bit for bit to ``sor3d_reference`` (whole grid
from zero) and to ``sor3d_chunk_reference`` (a haloed block of a larger
domain from a given p, every cell compared): the schedule computes exactly
the sequential half-sweeps, whatever the depth, the tile and the chunk of
planes.  It also pins ``pass_plan`` for the plume and the sharded chain.
"""

import numpy as np
import pytest
import torch

from esp32_fluid_simulation_tpu_torch.ops.cuda.sor3d import (
    margin, pass_depths, pass_plan, pass_threads, sor3d_chunk_reference,
    sor3d_reference, SOR3D_MAX_THREADS)
from esp32_fluid_simulation_tpu_torch.ops.poisson import neg_inv_of

torch.set_num_threads(1)

OMEGA = 1.5
DX = 0.7
NAN = float("nan")
LEAD, STAGES = 3, 4  # csrc/sor3d.cu kLead, kStage


def _axis(n, o, gn, x0, size):
    """Window indices ``x0 + [0, size)`` of an axis of ``n`` cells whose
    cell 0 sits at global ``o`` of ``gn``: the indices clamped into the
    array, the inside mask and the wall count."""
    x = torch.arange(size) + x0
    gx = x + o
    inside = (x >= 0) & (x < n) & (gx >= 0) & (gx < gn)
    return x.clamp(0, n - 1), inside, (gx == 0).long() + (gx == gn - 1).long()


def _block(d, p_in, origin, domain, h0, s, t0, u0, th, tw, z0, z1, out):
    """One block of a pass: the tile ``[t0, t0 + th) x [u0, u0 + tw)`` and
    the planes ``[z0, z1)`` of ``out``."""
    n_z, n_i, n_j = d.shape
    (oz, oi, oj), (gd, gh, gw) = origin, domain
    a = margin(s)
    ring_n = (s + 5) // 4 * 4  # at least s + 2, a multiple of the stages
    rows, cols = th + 2 * s, tw + 2 * s
    width = 4 * (-(-(tw + 2 * a) // 4))  # whole quads
    ai0, aj0 = t0 - s, u0 - a
    zlo, zhi = max(z0 - s, -1), min(z1 + s, n_z + 1)
    ic, i_in, i_walls = _axis(n_i, oi, gh, ai0, rows)
    jc, j_in, j_walls = _axis(n_j, oj, gw, aj0, width)
    cell_in = i_in[:, None] & j_in[None, :]
    r = torch.arange(rows)[:, None]
    c = torch.arange(width)[None, :]
    cw = c - (a - s)  # the trapezoid's column
    last = torch.minimum(torch.minimum(r, rows - 1 - r),
                         torch.minimum(cw, cols - 1 - cw))
    last = torch.where(cell_in & (cw >= 0) & (cw < cols), last, 0)
    walls = i_walls[:, None] + j_walls[None, :]
    # the cells a step updates: (e + t + i) even, e of the row, i in the quad
    parity = oz + oi + oj + zlo + ai0 + aj0 + h0 + 1 + r + c
    ring_p = torch.full((ring_n, rows, width), NAN)
    ring_d = torch.full((ring_n, rows, width), NAN)
    bufs = torch.full((max(s, 1), 2, rows, width), NAN)

    def inside(z):
        return 0 <= z < min(zhi, n_z) and 0 <= z + oz < gd

    def fetch(z):
        if not inside(z):
            return torch.zeros(rows, width), torch.zeros(rows, width)
        dz = torch.where(cell_in, d[z][ic][:, jc], 0.0)
        pz = (torch.zeros(rows, width) if p_in is None else
              torch.where(cell_in, p_in[z][ic][:, jc], 0.0))
        return dz, pz

    def from_buf(b, dr, dc):
        """``b``'s cell (r + dr, c + dc), NaN beyond the window."""
        x = torch.full((rows, width), NAN)
        x[max(0, -dr):rows - max(0, dr), max(0, -dc):width - max(0, dc)] = \
            b[max(0, dr):rows + min(0, dr), max(0, dc):width + min(0, dc)]
        return x

    def own(x, dc):
        """The quad's own cell (r, c + dc) of ``x``, NaN in another quad:
        a thread has only its own quad in registers."""
        return torch.where((c + dc) // 4 == c // 4, from_buf(x, 0, dc), NAN)

    # staging slots: plane zlo + x in slot x % STAGES, fetched LEAD planes
    # before it enters
    stage = [None] * STAGES
    for x in range(LEAD):
        stage[x % STAGES] = (zlo + x, *fetch(zlo + x))
    for t in range(-2, z1 - 2 - zlo + s):
        step_cells = (parity + t) % 2 == 0
        sn = (t + 2) % ring_n
        z_in, d_in, p_in_z = stage[(t + 2) % STAGES]
        assert z_in == zlo + t + 2
        ring_d[sn] = DX * d_in
        ring_p[sn] = p_in_z
        bufs[0, t % 2] = torch.where(step_cells, ring_p[sn], NAN)
        x = t + 2 + LEAD
        stage[x % STAGES] = (zlo + x, *fetch(zlo + x))
        for k in range(1, s + 1):
            z = zlo + 2 + t - k
            # every plane of the array in the domain, the trapezoid's and
            # the rest
            if not (0 <= z < n_z and 0 <= z + oz < gd):
                continue
            cur = ring_p[(t + 2 - k) % ring_n]
            below = ring_p[(t + 1 - k) % ring_n]
            above = ring_p[(t + 3 - k) % ring_n]
            pub = bufs[k - 1, (t - 1) % 2]
            # j-neighbours in the quad are the thread's own registers
            jm = torch.where(c % 4 == 0, from_buf(pub, 0, -1), own(cur, -1))
            jp = torch.where(c % 4 == 3, from_buf(pub, 0, 1), own(cur, 1))
            nb = ((((below + above) + from_buf(pub, -1, 0))
                   + from_buf(pub, 1, 0)) + jm) + jp
            z_walls = int(z + oz == 0) + int(z + oz == gd - 1)
            neg_inv = neg_inv_of(6 - z_walls - walls)
            new = (1.0 - OMEGA) * cur + OMEGA * (
                neg_inv * (ring_d[(t + 2 - k) % ring_n] - nb))
            cur[...] = torch.where(step_cells & (k <= last), new, cur)
            if k < s:
                bufs[k, t % 2] = torch.where(step_cells, cur, NAN)
        z = zlo + 2 + t - s
        if z0 <= z < z1:
            out[z, t0:t0 + th, u0:u0 + tw] = ring_p[(t + 2 - s) % ring_n][
                s:s + th, a:a + tw]


def _pass(d, p_in, origin, domain, h0, depth, tile, zc):
    """One pass of ``depth`` half-sweeps (the first of global index h0)
    as the kernel schedules it; p_in None: from zero."""
    n_z, n_i, n_j = d.shape
    out = torch.full_like(d, NAN)
    for z0 in range(0, n_z, zc):
        for t0 in range(0, n_i, tile[0]):
            for u0 in range(0, n_j, tile[1]):
                _block(d, p_in, origin, domain, h0, depth, t0, u0,
                       min(tile[0], n_i - t0), min(tile[1], n_j - u0), z0,
                       min(z0 + zc, n_z), out)
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


# (grid, iters, deepest pass, tile (columns a multiple of 4), planes per
# chunk)
WHOLE = {
    "10x20x28-iters10-depth6": ((10, 20, 28), 10, 6, (7, 12), 10),
    "10x20x28-iters10-depth6-zchunk4": ((10, 20, 28), 10, 6, (7, 12), 4),
    "10x20x28-iters4-depth2": ((10, 20, 28), 4, 2, (16, 8), 3),
    "10x20x28-iters3-depth1": ((10, 20, 28), 3, 1, (7, 12), 10),
    "9x33x41-iters5-depth6": ((9, 33, 41), 5, 6, (13, 16), 9),
    "9x33x41-iters7-depth6-zchunk2": ((9, 33, 41), 7, 6, (8, 32), 2),
    "9x33x41-iters1-depth2": ((9, 33, 41), 1, 2, (33, 44), 9),
    "9x33x41-iters0": ((9, 33, 41), 0, 6, (13, 16), 4),
    # the plume's plan (tile, depth 5) on a reduced grid, ragged both ways
    "14x45x110-iters10-plume-plan": ((14, 45, 110), 10, 6, (20, 52), 6),
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
    # the sharded chain's plan (tile, one pass of 6) on a reduced block
    "edge-sweeps3-chain-plan": ((10, 44, 60), (0, -6, -6), (10, 64, 100), 3,
                                6, (20, 48), 5),
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


@pytest.mark.parametrize("shape, levels, want", [
    # the plume: 10 iters at 256^3, 128 blocks of 32x32 and 128 planes
    ((256, 256, 256), 20, ((32, 32), 128, [5, 5, 5, 5])),
    # one chunk of the sharded 256^3 smoke's chain: a shard's block of
    # 128x128 haloed by 6, 3 sweeps, 126 blocks
    ((256, 140, 140), 6, ((20, 48), 43, [6])),
])
def test_pass_plan_pins_the_plume_and_the_sharded_chain(shape, levels, want):
    assert pass_plan(shape, levels, 132) == want


@pytest.mark.parametrize("shape, levels", [
    ((256, 256, 256), 20), ((256, 140, 140), 6), ((256, 140, 140), 8),
    ((9, 33, 130), 20), ((2, 2, 2), 6), ((64, 1024, 1024), 6),
    ((37, 83, 150), 14)])
def test_pass_plan_fits_a_block_and_fills_the_card(shape, levels):
    """Every plan's block fits ``SOR3D_MAX_THREADS``, its tile columns are
    whole quads, and its blocks make at most one more wave than the card's
    multiprocessors need."""
    (th, tw), zc, depths = pass_plan(shape, levels, 132)
    assert sum(depths) == levels and max(depths) <= 6
    assert tw % 4 == 0 and 1 <= zc <= shape[0]
    assert pass_threads((th, tw), max(depths)) <= SOR3D_MAX_THREADS
    blocks = -(-shape[0] // zc) * -(-shape[1] // th) * -(-shape[2] // tw)
    assert blocks <= 132 or -(-shape[1] // th) * -(-shape[2] // tw) > 132


@pytest.mark.parametrize("tile, depth, want", [
    ((32, 32), 5, 512), ((20, 48), 6, 512), ((32, 32), 6, 576),
    ((8, 16), 0, 64), ((8, 16), 1, 64)])
def test_pass_threads_counts_the_windows_quads(tile, depth, want):
    """A thread a quad of the window (the tile +- depth rows, +- depth
    rounded up to 4 columns), the even rows' threads padded to whole
    warps: 32x32 at depth 5 is 21 + 21 rows of 12 quads, 252 + 4 + 252 and
    the block's last 4 idle."""
    assert margin(depth) % 4 == 0 and margin(depth) >= depth
    assert pass_threads(tile, depth) == want

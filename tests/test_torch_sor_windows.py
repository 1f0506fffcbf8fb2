"""The window geometry of K4's one-launch route, on the CPU.

``csrc/sor.cu``'s window route gives each thread block a ``TH x TW`` tile
of the output and solves it inside its window: the tile plus ``2*iters``
cells a side (the halo of K4's block mode; no gradient follows, so one
cell less than K1's), with the global red-black parity (``& 1``, the
origin negative on edge tiles) and the domain's walls (or its members').
This test cuts a zero-padded field into such windows, solves each one
through ``sor_solve_reference`` in block mode (``modes.Block``), stitches
the tiles and holds the result to the plain solve of the whole field bit
for bit: the tile's cells never depend on anything beyond the window, so
the kernel's tiles can be computed independently.  Member tiles cross the
seams; a block of a larger domain is tiled as the sharded step's haloed
block is.
"""

import numpy as np
import pytest
import torch

from esp32_fluid_simulation_tpu_torch.ops.cuda.modes import Block
from esp32_fluid_simulation_tpu_torch.ops.cuda.sor import sor_solve_reference

torch.set_num_threads(1)

DX, OMEGA = 0.7, 1.96

# (grid, iters, member tile, output tile)
CASES = {
    "61x81-iters1": ((61, 81), 1, None, (16, 32)),
    "61x81-iters10": ((61, 81), 10, None, (16, 32)),
    "61x81-iters10-ragged": ((61, 81), 10, None, (13, 27)),
    "64x96-iters1-members24": ((64, 96), 1, (32, 24), (16, 32)),
    "64x96-iters10-members24": ((64, 96), 10, (16, 24), (20, 40)),
    "64x96-iters10-members24-ragged": ((64, 96), 10, (32, 24), (13, 27)),
}


def _stitched(d, iters, member, tile, blk=None):
    """Each tile of the owned cells solved alone in its window (block mode
    with halo ``2*iters``), stitched.  ``blk``: ``d`` is that haloed block
    of a larger domain, else the whole grid."""
    r = 2 * iters
    if blk is None:
        (bh, bw), (ox, oy), domain = d.shape, (0, 0), d.shape
        field = torch.nn.functional.pad(d, (r, r, r, r))
    else:
        (bh, bw), (ox, oy), domain = (blk.bh, blk.bw), (blk.ox, blk.oy), (
            blk.gh, blk.gw)
        g = blk.halo - r  # the window of the owned cell 0 starts here
        field = d[g:d.shape[0] - g, g:d.shape[1] - g]
    p = torch.full((bh, bw), float("nan"))
    for t0 in range(0, bh, tile[0]):
        for u0 in range(0, bw, tile[1]):
            th, tw = min(tile[0], bh - t0), min(tile[1], bw - u0)
            window = field[t0:t0 + th + 2 * r, u0:u0 + tw + 2 * r]
            p[t0:t0 + th, u0:u0 + tw] = sor_solve_reference(
                window.contiguous(), DX, iters, OMEGA, member,
                block=Block(ox + t0, oy + u0, *domain, r, th, tw))
    return p


def _field(shape, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize("case", list(CASES))
def test_windows_stitch_to_the_whole_grid(case):
    shape, iters, member, tile = CASES[case]
    d = _field(shape, sum(shape) + iters)
    want = sor_solve_reference(d, DX, iters, OMEGA, member)
    assert torch.equal(_stitched(d, iters, member, tile), want)


# (domain, owned block origin, owned block, halo, iters, member, tile): an
# edge shard (its window reaches beyond the domain) and a far one
BLOCKS = {
    "edge-iters10": ((80, 96), (0, 0), (40, 48), 20, 10, None, (13, 27)),
    "far-iters10-members": ((80, 96), (40, 48), (40, 48), 22, 10, (16, 24),
                            (16, 32)),
    "edge-iters1": ((80, 96), (0, 48), (40, 48), 2, 1, None, (16, 20)),
}


@pytest.mark.parametrize("case", list(BLOCKS))
def test_windows_stitch_to_the_block_solve(case):
    domain, (ox, oy), (bh, bw), halo, iters, member, tile = BLOCKS[case]
    blk = Block(ox, oy, *domain, halo, bh, bw)
    d = _field((bh + 2 * halo, bw + 2 * halo), ox + oy + iters)
    want = sor_solve_reference(d, DX, iters, OMEGA, member, block=blk)
    assert torch.equal(_stitched(d, iters, member, tile, blk), want)

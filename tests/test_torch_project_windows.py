"""The window geometry of K1's one-launch route, on the CPU.

``csrc/project.cu``'s window route gives each thread block a ``TH x TW``
tile of the output and projects it inside its window: the tile plus
``2*iters + 2`` cells a side (the halo of K1's block mode), with the
impulses that fall anywhere in the window, the global red-black parity
(``& 1``, the origin negative on edge tiles) and the domain's walls (or its
members').  This test cuts a zero-padded grid into such windows, projects
each one through ``project_fused_reference`` in block mode
(``global_offset``, ``global_shape``, ``halo``), stitches the tiles and
holds the result to the whole-grid ``project_fused_reference`` bit for bit:
the tile's cells never depend on anything beyond the window, so the
kernel's tiles can be computed independently.  Impulses sit on the tile
seams and in a neighbour tile's ring; member tiles cross the seams.
"""

import numpy as np
import pytest
import torch

from esp32_fluid_simulation_tpu_torch import SimConfig, Impulses
from esp32_fluid_simulation_tpu_torch.ops.cuda.modes import Block
from esp32_fluid_simulation_tpu_torch.ops.cuda.project import (
    project_fused_reference)

torch.set_num_threads(1)

# (grid, iters, member tile, output tile)
CASES = {
    "61x81-iters1": ((61, 81), 1, None, (16, 32)),
    "61x81-iters10": ((61, 81), 10, None, (16, 32)),
    "61x81-iters10-ragged": ((61, 81), 10, None, (13, 27)),
    "64x96-iters1": ((64, 96), 1, None, (16, 32)),
    "64x96-iters10": ((64, 96), 10, None, (20, 40)),
    "64x96-iters10-members24": ((64, 96), 10, (32, 24), (16, 32)),
    "64x96-iters10-members24-tile20x40": ((64, 96), 10, (16, 24), (20, 40)),
    "64x96-iters1-members24": ((64, 96), 1, (32, 24), (16, 32)),
}


def _impulses(shape, tile, iters):
    """Slots on the first tile seams, in the next tile's ring (within
    2*iters + 2 of the seam), a duplicate (the last active slot wins) and
    one out of range (clamped)."""
    (th, tw), r = tile, 2 * iters + 2
    cells = [(th, tw), (th - 1, 3), (th, tw), (2 * th + r // 2, tw - 1),
             (th // 2, tw + r - 1), (shape[0] + 5, -3)]
    vels = [(90.0, -45.0), (33.0, 44.0), (-60.0, 120.0), (7.0, 8.0),
            (-25.0, 15.0), (5.0, 5.0)]
    return Impulses.from_lists(SimConfig(shape=shape, max_impulses=8), cells,
                               vels, device="cpu")


def _stitched(vel, iters, impulses, member, tile):
    """Each tile projected in its own window (block mode), stitched."""
    _, h, w = vel.shape
    g = 2 * iters + 2
    pad = torch.nn.functional.pad(vel, (g, g, g, g))
    out = torch.full_like(vel, float("nan"))
    p = torch.full_like(vel[0], float("nan"))
    for t0 in range(0, h, tile[0]):
        for u0 in range(0, w, tile[1]):
            th, tw = min(tile[0], h - t0), min(tile[1], w - u0)
            window = pad[:, t0:t0 + th + 2 * g, u0:u0 + tw + 2 * g]
            v_t, p_t = project_fused_reference(
                window.contiguous(), 1.0, iters, 1.96, impulses, member,
                block=Block(t0, u0, h, w, g, th, tw))
            out[:, t0:t0 + th, u0:u0 + tw] = v_t
            p[t0:t0 + th, u0:u0 + tw] = p_t
    return out, p


@pytest.mark.parametrize("with_impulses", [True, False],
                         ids=["impulses", "no-impulses"])
@pytest.mark.parametrize("case", list(CASES))
def test_windows_stitch_to_the_whole_grid(case, with_impulses):
    shape, iters, member, tile = CASES[case]
    rng = np.random.default_rng(sum(shape) + iters)
    vel = torch.from_numpy(rng.normal(0, 40, (2,) + shape).astype(np.float32))
    impulses = _impulses(shape, tile, iters) if with_impulses else None
    want_v, want_p = project_fused_reference(vel, 1.0, iters, 1.96,
                                             impulses, member)
    got_v, got_p = _stitched(vel, iters, impulses, member, tile)
    assert torch.equal(got_v, want_v)
    assert torch.equal(got_p, want_p)

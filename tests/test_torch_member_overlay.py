"""K2's member overlay (``ops/cuda/advect.py`` ``member_overlay``): an
ensemble's ``[n, K]`` impulses as the dense overlay ``overlay=`` reads.

On the CPU the wrapper runs its plain version, which equals, member by
member, config 0's own overlay build (``stable_fluids.impulse_overlay``)
placed in the member's tile: positions clamped to the member, the last
active slot winning at a repeated cell, inactive slots writing nothing.
The ``gpu`` case holds the kernel to the plain version bit for bit, at
odd and even member tiles and at config 4's 256 members of 256^2, one
launch a call.  Imports no JAX.
"""

import numpy as np
import pytest
import torch

from esp32_fluid_simulation_tpu_torch import Impulses
from esp32_fluid_simulation_tpu_torch.models.stable_fluids import (
    impulse_overlay)
from esp32_fluid_simulation_tpu_torch.ops.cuda.advect import (
    member_overlay, member_overlay_reference)

# (tiles down, tiles across, member height, member width)
TILINGS = [(2, 3, 17, 21), (2, 2, 32, 48), (16, 16, 256, 256)]


def _impulses(gh, gw, mh, mw, seed=3, k=16):
    """Seeded member impulses: cells in and out of the member, a repeated
    cell in every member, a third of the slots inactive."""
    rng = np.random.default_rng(seed)
    n = gh * gw
    pos = rng.integers(-3, max(mh, mw) + 3, (n, k, 2)).astype(np.int32)
    pos[:, 5] = pos[:, 2]
    vel = (300 * rng.standard_normal((n, k, 2))).astype(np.float32)
    active = rng.random((n, k)) > 0.33
    return Impulses(torch.from_numpy(pos), torch.from_numpy(vel),
                    torch.from_numpy(active))


def _per_member(imp, gh, gw, mh, mw):
    """Each member's ``impulse_overlay`` in its tile of a zero overlay."""
    out = torch.zeros((3, gh * mh, gw * mw))
    for m in range(gh * gw):
        i, j = (m // gw) * mh, (m % gw) * mw
        out[:, i:i + mh, j:j + mw] = impulse_overlay(
            Impulses(*(x[m] for x in imp)), (mh, mw))
    return out


@pytest.mark.parametrize("tiling", TILINGS[:2])
@pytest.mark.parametrize("seed", [3, 4])
def test_plain_overlay_is_each_members_own(tiling, seed):
    imp = _impulses(*tiling, seed=seed)
    before = member_overlay.launches
    got = member_overlay(imp, *tiling)
    assert member_overlay.launches == before
    assert torch.equal(got, member_overlay_reference(imp, *tiling))
    assert torch.equal(got, _per_member(imp, *tiling))


def test_malformed_batch_is_refused():
    imp = _impulses(2, 2, 8, 8)
    with pytest.raises(ValueError):
        member_overlay(imp, 2, 3, 8, 8)
    with pytest.raises(ValueError):
        member_overlay(Impulses(imp.pos[..., :1], imp.velocity[..., :1],
                                imp.active), 2, 2, 8, 8)


@pytest.mark.gpu
@pytest.mark.parametrize("tiling", TILINGS)
def test_card_overlay_is_the_plain_version(tiling):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    imp = _impulses(*tiling)
    want = member_overlay_reference(imp, *tiling)
    on_card = Impulses(*(x.cuda() for x in imp))
    before = member_overlay.launches
    got = member_overlay(on_card, *tiling)
    assert member_overlay.launches == before + 1
    assert torch.equal(got.cpu(), want)

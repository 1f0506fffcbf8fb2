"""Impulse lists and the parent's construction of a padded batch, shared by
the feed's CPU tests (``test_torch_feed.py``) and card tests
(``test_torch_cuda.py``).  Imports no JAX."""

import numpy as np
import torch

from esp32_fluid_simulation_tpu_torch import Impulses

DTYPES = ["float32", "bfloat16", "float64"]
SHAPES = {2: (40, 56), 3: (12, 20, 28)}
COUNTS = [0, 8, 16, 20]          # 20 is more than the 16 slots
_BITS = {2: torch.int16, 4: torch.int32, 8: torch.int64}


def lists(nd, count, seed=7):
    """``count`` (pos, velocity) tuples of Python numbers: positions in and
    out of the grid, velocities that float32 and bfloat16 must round."""
    rng = np.random.default_rng(seed + 100 * nd + count)
    pos = [tuple(int(x) for x in rng.integers(-3, 64, nd))
           for _ in range(count)]
    vel = [tuple(float(x) for x in 300.0 * rng.standard_normal(nd))
           for _ in range(count)]
    if count:
        vel[0] = (1.0 + 2.0 ** -8,) * nd   # a bfloat16 tie: rounds to even
    return pos, vel


def padded(cfg, pos, vel):
    """The padded host arrays, velocity still float32."""
    k, nd = cfg.max_impulses, cfg.ndim
    n = min(len(pos), k)
    p = np.zeros((k, nd), np.int32)
    v = np.zeros((k, nd), np.float32)
    a = np.zeros((k,), np.bool_)
    if n:
        p[:n] = np.asarray(pos[:n], np.int32)
        v[:n] = np.asarray(vel[:n])
        a[:n] = True
    return p, v, a


def parent_batch(cfg, pos, vel, device):
    """The batch as the construction before pinned staging built it: three
    pageable copies, each ending in a synchronise on a card."""
    p, v, a = padded(cfg, pos, vel)
    return Impulses(pos=torch.from_numpy(p).to(device),
                    velocity=torch.from_numpy(v).to(
                        device=device, dtype=cfg.torch_dtype),
                    active=torch.from_numpy(a).to(device))


def bits(t):
    """``t``'s bits as an integer (or bool) tensor."""
    return t if t.dtype in (torch.bool, torch.int32) else t.view(
        _BITS[t.element_size()])


def assert_bit_equal(got, want):
    for name, g, w in zip(Impulses._fields, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert g.device == w.device, name
        assert torch.equal(bits(g), bits(w)), name

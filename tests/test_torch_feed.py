"""The port's feed, ``Impulses.from_lists``, on the CPU.

The CPU path builds the very batch the parent construction built (three
arrays padded in numpy, the velocity cast by torch's CPU cast) and the JAX
package's ``Impulses.from_lists`` builds, bit for bit, for every dtype
``config._DTYPES`` holds, 2D and 3D positions, and 0 to more than
``max_impulses`` lists; ``Impulses.staged_uploads`` stays put there.  The
card's route (``state._staged``: one pinned buffer, one copy) is laid out
and cast here with the pinning left out, since this machine has no pinned
allocator; ``tests/test_torch_cuda.py`` runs it on the card.
"""

import jax
import numpy as np
import pytest
import torch

import esp32_fluid_simulation_tpu as J
from esp32_fluid_simulation_tpu_torch import Impulses, SimConfig, state
from feed_cases import (COUNTS, DTYPES, SHAPES, assert_bit_equal, bits,
                        lists, padded, parent_batch)


@pytest.mark.parametrize("count", COUNTS)
@pytest.mark.parametrize("nd", [2, 3])
@pytest.mark.parametrize("dtype", DTYPES)
def test_cpu_feed_is_the_parent_batch(dtype, nd, count):
    cfg = SimConfig(shape=SHAPES[nd], dtype=dtype)
    pos, vel = lists(nd, count)
    before = Impulses.staged_uploads
    got = Impulses.from_lists(cfg, pos, vel, device="cpu")
    assert Impulses.staged_uploads == before
    assert_bit_equal(got, parent_batch(cfg, pos, vel, "cpu"))
    assert not any(t.is_pinned() for t in got)
    assert int(got.active.sum()) == min(count, cfg.max_impulses)


@pytest.mark.parametrize("count", COUNTS)
@pytest.mark.parametrize("nd", [2, 3])
@pytest.mark.parametrize("dtype", DTYPES)
def test_cpu_feed_equals_the_jax_packages(dtype, nd, count):
    cfg = SimConfig(shape=SHAPES[nd], dtype=dtype)
    pos, vel = lists(nd, count)
    got = Impulses.from_lists(cfg, pos, vel, device="cpu")
    with jax.enable_x64(dtype == "float64"):
        want = J.Impulses.from_lists(J.SimConfig(shape=SHAPES[nd],
                                                 dtype=dtype), pos, vel)
        want = [np.asarray(x) for x in want]
    for name, g, w in zip(Impulses._fields, got, want):
        assert str(g.dtype)[6:] == str(w.dtype), name
        assert np.array_equal(bits(g).numpy(),
                              w.view(bits(g).numpy().dtype)), name


@pytest.mark.parametrize("count", [0, 20])
@pytest.mark.parametrize("nd", [2, 3])
@pytest.mark.parametrize("dtype", DTYPES)
def test_staged_layout_and_cast_are_the_parent_batch(monkeypatch, dtype,
                                                      nd, count):
    """The card's route with the pinning left out: every field a view of
    one buffer, its start aligned, its bits the parent batch's."""
    empty = torch.empty
    monkeypatch.setattr(torch, "empty",
                        lambda *a, pin_memory=False, **kw: empty(*a, **kw))
    cfg = SimConfig(shape=SHAPES[nd], dtype=dtype)
    pos, vel = lists(nd, count)
    p, v, a = padded(cfg, pos, vel)
    host = (torch.from_numpy(p), torch.from_numpy(v).to(cfg.torch_dtype),
            torch.from_numpy(a))
    got = Impulses(*state._staged(host, "cpu"))
    assert_bit_equal(got, parent_batch(cfg, pos, vel, "cpu"))
    base = got.pos.untyped_storage().data_ptr()
    for t in got:
        assert t.untyped_storage().data_ptr() == base
        assert t.is_contiguous()
        assert (t.data_ptr() - base) % state._ALIGN == 0


def test_a_feed_that_raises_is_not_counted(monkeypatch):
    def refuse(*args):
        raise RuntimeError("no staging")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(state, "_staged", refuse)
    before = Impulses.staged_uploads
    with pytest.raises(RuntimeError, match="no staging"):
        Impulses.from_lists(SimConfig(shape=SHAPES[2]), *lists(2, 8),
                            device="cuda")
    assert Impulses.staged_uploads == before

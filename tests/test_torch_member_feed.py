"""The ensemble's batched feed, ``Impulses.from_member_lists``.

One call turns a step's flat lists or numpy arrays (each poke's member,
member-local cell and velocity) into the ``[n, K, nd]`` / ``[n, K]`` batch that
``stack_impulses`` of one ``Impulses.from_lists`` a member builds, bit for
bit: each member keeps its first ``max_impulses`` pokes in list order,
whatever the order of the members in the lists, a member with none is all
inactive, and a repeated cell keeps both slots (the drain resolves them).
On the CPU nothing is staged; the card's route (one pinned block, one
copy, ``Impulses.staged_uploads`` + 1) is laid out here with the pinning
left out, and run on the card by the ``gpu`` case.  Imports no JAX.
"""

import numpy as np
import pytest
import torch

from esp32_fluid_simulation_tpu_torch import (Impulses, SimConfig,
                                              stack_impulses, state)
from feed_cases import DTYPES, assert_bit_equal

N = 5
SHAPE = (32, 48)


def member_lists(count, seed=11, n=N):
    """``count`` pokes over ``n`` members, interleaved: member 1 gets more
    than the 16 slots, member 3 none, and member 0 one cell twice."""
    rng = np.random.default_rng(seed + count)
    members = [0, 1, 2, 4] if n > 4 else list(range(n))
    member = [int(m) for m in rng.choice(members, count)]
    member += [1] * 20 + [0, 0]
    pos = [tuple(int(x) for x in rng.integers(-3, 52, 2))
           for _ in range(count + 20)] + [(7, 9), (7, 9)]
    vel = [tuple(float(x) for x in 300.0 * rng.standard_normal(2))
           for _ in range(count + 22)]
    vel[-1] = (1.0 + 2.0 ** -8, -3.0)      # a bfloat16 tie: rounds to even
    order = rng.permutation(len(member))
    return ([member[i] for i in order], [pos[i] for i in order],
            [vel[i] for i in order])


def per_member_batch(cfg, n, member, pos, vel, device):
    """The batch as one ``from_lists`` a member, stacked."""
    return stack_impulses([
        Impulses.from_lists(cfg, [p for q, p in zip(member, pos) if q == m],
                            [v for q, v in zip(member, vel) if q == m],
                            device=device)
        for m in range(n)])


@pytest.mark.parametrize("count", [0, 3, 40])
@pytest.mark.parametrize("dtype", DTYPES)
def test_batched_feed_is_the_stacked_per_member_feed(dtype, count):
    cfg = SimConfig(shape=SHAPE, dtype=dtype)
    member, pos, vel = member_lists(count)
    before = Impulses.staged_uploads
    got = Impulses.from_member_lists(cfg, N, member, pos, vel, device="cpu")
    assert Impulses.staged_uploads == before
    assert_bit_equal(got, per_member_batch(cfg, N, member, pos, vel, "cpu"))
    assert got.pos.shape == (N, cfg.max_impulses, 2)
    assert got.active[1].all() and not got.active[3].any()


@pytest.mark.parametrize("dtype", DTYPES)
def test_numpy_arrays_feed_as_the_lists_do(dtype):
    """The same pokes as arrays (member ``[P]``, cells and velocities
    ``[P, 2]``, as the benchmark's member swirl hands them over) give the
    lists' batch, bit for bit."""
    cfg = SimConfig(shape=SHAPE, dtype=dtype)
    member, pos, vel = member_lists(40)
    got = Impulses.from_member_lists(
        cfg, N, np.array(member), np.array(pos, np.int64),
        np.array(vel, np.float64), device="cpu")
    assert_bit_equal(got, per_member_batch(cfg, N, member, pos, vel, "cpu"))


def test_empty_lists_give_an_inactive_batch():
    cfg = SimConfig(shape=SHAPE)
    got = Impulses.from_member_lists(cfg, 3, [], [], [], device="cpu")
    want = stack_impulses([Impulses.none(cfg, device="cpu")] * 3)
    assert_bit_equal(got, want)


def test_each_member_keeps_its_first_pokes_in_list_order():
    cfg = SimConfig(shape=SHAPE, max_impulses=2)
    member = [1, 0, 1, 1, 0]
    pos = [(1, 1), (2, 2), (3, 3), (4, 4), (5, 5)]
    vel = [(10.0, 0.0), (20.0, 0.0), (30.0, 0.0), (40.0, 0.0), (50.0, 0.0)]
    got = Impulses.from_member_lists(cfg, 2, member, pos, vel, device="cpu")
    assert got.pos.tolist() == [[[2, 2], [5, 5]], [[1, 1], [3, 3]]]
    assert got.velocity[:, :, 0].tolist() == [[20.0, 50.0], [10.0, 30.0]]


@pytest.mark.parametrize("member,pos,vel", [
    ([0, 1], [(1, 1)], [(1.0, 1.0)]),
    ([0, 2], [(1, 1), (2, 2)], [(1.0, 1.0), (2.0, 2.0)]),
    ([-1], [(1, 1)], [(1.0, 1.0)]),
])
def test_malformed_lists_are_refused(member, pos, vel):
    with pytest.raises(ValueError):
        Impulses.from_member_lists(SimConfig(shape=SHAPE), 2, member, pos,
                                   vel, device="cpu")


@pytest.mark.parametrize("dtype", DTYPES)
def test_staged_route_is_one_block_and_one_upload(monkeypatch, dtype):
    """The card's route with the pinning left out and the copy kept on the
    CPU: the three fields views of one buffer, each start aligned, the bits
    those of the per-member feed; one batch counts one staged upload."""
    empty, staged = torch.empty, state._staged
    monkeypatch.setattr(torch, "empty",
                        lambda *a, pin_memory=False, **kw: empty(*a, **kw))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(state, "_staged",
                        lambda fields, device: staged(fields, "cpu"))
    cfg = SimConfig(shape=SHAPE, dtype=dtype)
    member, pos, vel = member_lists(40)
    before = Impulses.staged_uploads
    got = Impulses.from_member_lists(cfg, N, member, pos, vel,
                                     device="cuda")
    assert Impulses.staged_uploads == before + 1
    assert_bit_equal(got, per_member_batch(cfg, N, member, pos, vel, "cpu"))
    base = got.pos.untyped_storage().data_ptr()
    for t in got:
        assert t.untyped_storage().data_ptr() == base
        assert t.is_contiguous()
        assert (t.data_ptr() - base) % state._ALIGN == 0


@pytest.mark.gpu
def test_card_feed_is_staged_once_and_never_synchronises():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the pinned route)")
    cuda = torch.device("cuda", 0)
    cfg = SimConfig(shape=SHAPE)
    member, pos, vel = member_lists(40)
    want = per_member_batch(cfg, N, member, pos, vel, cuda)
    torch.cuda.synchronize()
    before = Impulses.staged_uploads
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = Impulses.from_member_lists(cfg, N, member, pos, vel,
                                         device=cuda)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert Impulses.staged_uploads == before + 1
    assert_bit_equal(got, want)

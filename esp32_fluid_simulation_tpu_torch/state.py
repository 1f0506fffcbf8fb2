"""Simulation state and impulse containers (counterpart of
``esp32_fluid_simulation_tpu/state.py``).

Layout is channels-first (``[C, H, W]``), as in the JAX package, so the
tests compare like with like.  Every constructor takes the ``device`` the
tensors live on, the card (``"cuda"``) unless the caller names another;
nothing here reads a global default device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .config import SimConfig
from .spans import span


class SimState(NamedTuple):
    """Persistent per-frame state.

    velocity: ``[ndim, *shape]`` — channel 0 along axis 0, channel 1 along
              axis 1.
    color:    ``[3, *shape]`` dye RGB in [0, 1].
    step:     frame counter (a Python int: it lives on the host).
    """

    velocity: torch.Tensor
    color: torch.Tensor
    step: int


class Impulses(NamedTuple):
    """A fixed-length batch of velocity impulses (the drag queue).

    ``pos`` indices are in sim frame (axis-0 index, axis-1 index); inactive
    slots are masked by ``active``.
    """

    pos: torch.Tensor       # int32 [K, ndim] cell indices
    velocity: torch.Tensor  # [K, ndim] velocity to write (cells/s)
    active: torch.Tensor    # bool  [K]

    staged_uploads = 0  # batches that crossed through pinned staging

    @classmethod
    def none(cls, cfg: SimConfig, device="cuda") -> "Impulses":
        k, nd = cfg.max_impulses, cfg.ndim
        return cls(
            pos=torch.zeros((k, nd), dtype=torch.int32, device=device),
            velocity=torch.zeros((k, nd), dtype=cfg.torch_dtype,
                                 device=device),
            active=torch.zeros((k,), dtype=torch.bool, device=device),
        )

    @classmethod
    def from_lists(cls, cfg: SimConfig, pos, vel, device="cuda") -> "Impulses":
        """Build a padded batch from Python lists of (pos, velocity) tuples.

        Padding happens host-side in numpy, the velocity cast from float32
        to ``cfg.torch_dtype`` by torch's CPU cast.  For a CUDA ``device``
        the batch is written into one pinned host buffer and crosses as
        one copy that does not block the host, ordered on the device's
        current stream; the three fields are views of the one device copy
        (``Impulses.staged_uploads`` counts these batches).  To another
        device the three fields are copied as they are; on the CPU they
        are the padded arrays, the velocity cast."""
        with span("fluid.impulses"):
            k, nd = cfg.max_impulses, cfg.ndim
            n = min(len(pos), k)
            p = np.zeros((k, nd), np.int32)
            v = np.zeros((k, nd), np.float32)  # cast to cfg.torch_dtype below
            a = np.zeros((k,), np.bool_)
            if n:
                p[:n] = np.asarray(pos[:n], np.int32)
                v[:n] = np.asarray(vel[:n])
                a[:n] = True
            fields = (torch.from_numpy(p),
                      torch.from_numpy(v).to(cfg.torch_dtype),
                      torch.from_numpy(a))
            if (torch.device(device).type == "cuda"
                    and torch.cuda.is_available()):
                imp = cls(*_staged(fields, device))
                Impulses.staged_uploads += 1
                return imp
            return cls(*(t.to(device) for t in fields))

    @classmethod
    def from_member_lists(cls, cfg: SimConfig, n: int, member, pos, vel,
                          device="cuda") -> "Impulses":
        """Build an ensemble's ``[n, K, nd]`` / ``[n, K]`` batch from flat
        sequences of a step's pokes (lists, or numpy arrays, which cross
        without a Python object a poke): poke ``i`` goes to member
        ``member[i]`` at the member-local cell ``pos[i]`` with velocity
        ``vel[i]``.

        Each member keeps its first ``K = cfg.max_impulses`` pokes in list
        order and drops the rest, as ``from_lists`` does for one grid, so
        the batch equals ``stack_impulses`` of one ``from_lists`` a member,
        field for field.  The padding is vectorised in numpy over all pokes;
        for a CUDA ``device`` the batch crosses as one pinned block and one
        non-blocking copy, as in ``from_lists``, and counts one
        ``Impulses.staged_uploads``."""
        with span("fluid.impulses"):
            k, nd, count = cfg.max_impulses, cfg.ndim, len(member)
            if not count == len(pos) == len(vel):
                raise ValueError(
                    f"{count} members, {len(pos)} positions and "
                    f"{len(vel)} velocities: one of each a poke")
            m = np.asarray(member, np.int64).reshape(count)
            p_all = np.asarray(pos, np.int32).reshape(count, nd)
            v_all = np.asarray(vel, np.float64).reshape(count, nd)
            # member-major lists, the usual order, skip the sort
            if count > 1 and not (m[1:] >= m[:-1]).all():
                order = np.argsort(m, kind="stable")
                m, p_all, v_all = m[order], p_all[order], v_all[order]
            if count and not (0 <= m[0] and m[-1] < n):
                raise ValueError(f"member indices outside [0, {n})")
            # a poke's slot: its rank among its member's pokes
            slot = np.arange(count) - np.searchsorted(m, m)
            cell = m * k + slot
            if count and slot.max() >= k:
                keep = slot < k
                cell, p_all, v_all = cell[keep], p_all[keep], v_all[keep]
            p = np.zeros((n * k, nd), np.int32)
            v = np.zeros((n * k, nd), np.float32)  # cast below, as from_lists
            a = np.zeros(n * k, np.bool_)
            p[cell] = p_all
            v[cell] = v_all
            a[cell] = True
            p, v = p.reshape(n, k, nd), v.reshape(n, k, nd)
            a = a.reshape(n, k)
            fields = (torch.from_numpy(p),
                      torch.from_numpy(v).to(cfg.torch_dtype),
                      torch.from_numpy(a))
            if (torch.device(device).type == "cuda"
                    and torch.cuda.is_available()):
                imp = cls(*_staged(fields, device))
                Impulses.staged_uploads += 1
                return imp
            return cls(*(t.to(device) for t in fields))


_ALIGN = 16  # bytes between the staged fields' starts


def _staged(fields, device):
    """The bytes of the host tensors ``fields`` laid end to end (each start
    aligned) in one pinned buffer from the caching host allocator, sent to
    ``device`` as one non-blocking copy on its current stream.  Returns
    views of the device copy, shaped and typed as ``fields``.  The
    allocator records the copy's stream on the pinned block, so the block
    is not handed out again before the copy has landed."""
    starts, nbytes = [], 0
    for t in fields:
        starts.append(nbytes)
        nbytes += -(-t.nbytes // _ALIGN) * _ALIGN
    pinned = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    host = pinned.numpy()
    for t, at in zip(fields, starts):
        host[at:at + t.nbytes] = t.view(torch.uint8).numpy().reshape(-1)
    staged = pinned.to(device, non_blocking=True)
    return [staged.view(t.dtype).as_strided(t.shape, t.stride(),
                                            at // t.itemsize)
            for t, at in zip(fields, starts)]

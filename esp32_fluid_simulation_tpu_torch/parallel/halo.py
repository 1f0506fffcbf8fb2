"""Halo exchange over a device mesh with
boundary-condition-aware edges (counterpart of
``esp32_fluid_simulation_tpu/parallel/halo.py``).

A sharded field is a grid of per-shard blocks, ``blocks[x][y]``, each on
its mesh device.  ``exchange_halo`` extends every block by ``width`` ghost
cells on both sides of one array axis with the neighbour blocks' edge
strips along one mesh axis — the counterpart of ``jax.lax.ppermute`` under
``shard_map`` — and fills the two *global* edges according to the
physical boundary condition:

* ``zero``        — zero ghosts (SOR neighbour sums, advect windows);
* ``edge``        — clamp to the edge value (Neumann pressure gradient,
                    ``finitediff.cpp:51-54``);
* ``reflect_neg`` — negated mirror (no-penetration ghost velocity,
                    ``finitediff.cpp:17-20``).

A strip that crosses devices is copied with ``.to(device)``; each block's
ghosts are assembled with its device current, so on a CUDA mesh the copies
order themselves on that device's current stream.  With a device repeated
in the mesh the exchange is a device-local copy.

Across processes (a mesh from ``topology.make_process_mesh``), ``ranks``
names the process that owns each block, and this process holds only its
own (the others are None).  The strips that cross processes travel in ONE
``torch.distributed.batch_isend_irecv`` per exchange, every send and
receive posted in one global order on every rank: nothing waits before
all are posted, and NCCL matches a group's messages between two ranks in
that order.  Gloo carries CPU tensors only (PyTorch's backend table), so
with blocks on a card a gloo strip is staged through a pinned host buffer;
NCCL sends device memory.  A strip keeps its dtype: a bf16 dye strip
travels as its 16-bit words.  ``all_reduce`` and ``all_gather_blocks``
are the two other collectives the sharded steps use (the mesh-reduced
metrics; the whole-grid gathers).
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.distributed as dist

from .topology import X_AXIS, Y_AXIS

BCS = ("zero", "edge", "reflect_neg")


def on_device(device):
    """A context that makes a CUDA ``device`` current; nothing for the
    CPU."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _take(x, dim, start, size):
    return x.narrow(dim, start if start >= 0 else x.shape[dim] + start, size)


def _fill(x, width, dim, side, bc):
    """The ghost strip beyond the global edge on ``side`` ("lo"/"hi")."""
    if bc == "zero":
        return torch.zeros_like(_take(x, dim, 0, width))
    if bc == "edge":
        edge = _take(x, dim, 0 if side == "lo" else -1, 1)
        return torch.cat([edge] * width, dim=dim)
    strip = _take(x, dim, 0 if side == "lo" else -width, width)
    return -torch.flip(strip, dims=(dim,))


def staged(device) -> bool:
    """True where the default group cannot carry tensors on ``device``
    (gloo, a CUDA device): they travel through pinned host buffers."""
    return device.type == "cuda" and dist.get_backend() == "gloo"


def _to_wire(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the default group carries it: a contiguous tensor of its
    own on ``t``'s device, or a pinned host copy where ``staged``."""
    if staged(t.device):
        return torch.empty(t.shape, dtype=t.dtype,
                           pin_memory=True).copy_(t)
    return t.contiguous().clone()


def _wire_empty(shape, dtype, device) -> torch.Tensor:
    """A receive buffer for a tensor bound for ``device``."""
    if staged(device):
        return torch.empty(shape, dtype=dtype, pin_memory=True)
    return torch.empty(shape, dtype=dtype, device=device)


def all_reduce(t: torch.Tensor, op: str) -> torch.Tensor:
    """``t`` reduced over the processes of the default group (``op``
    ``"max"`` or ``"sum"``), on ``t``'s device."""
    ops = {"max": dist.ReduceOp.MAX, "sum": dist.ReduceOp.SUM}
    w = _to_wire(t.reshape(1))
    dist.all_reduce(w, op=ops[op])
    return w.to(t.device).reshape(t.shape)


def all_gather_blocks(blocks):
    """A grid of blocks in which the blocks of other processes are None ->
    the grid with every block, each process contributing its own (one
    ``all_gather_object`` of the shapes and dtypes, one ``all_gather`` of
    the blocks' bytes, padded to the longest process's).  Every process of
    the default group calls it.  The gathered blocks are bit copies, on
    this process's first block's device."""
    if not dist.is_initialized():
        raise ValueError("a grid that holds blocks of other processes "
                         "(None) needs torch.distributed to gather")
    nx, ny = len(blocks), len(blocks[0])
    mine = [(a, b) for a in range(nx) for b in range(ny)
            if blocks[a][b] is not None]
    if not mine:
        raise ValueError("this process holds no block of the grid")
    home = blocks[mine[0][0]][mine[0][1]].device
    meta = [(a, b, tuple(blocks[a][b].shape), blocks[a][b].dtype)
            for a, b in mine]
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, meta)

    def nbytes(shape, dtype):
        return math.prod(shape) * torch.empty((), dtype=dtype).element_size()

    longest = max(sum(nbytes(s, t) for _, _, s, t in m) for m in every)
    payload = torch.zeros(longest, dtype=torch.uint8, device=home)
    words = torch.cat([blocks[a][b].contiguous().view(-1).view(torch.uint8)
                       for a, b in mine])
    payload[:words.numel()] = words
    parts = [_wire_empty((longest,), torch.uint8, home) for _ in every]
    dist.all_gather(parts, _to_wire(payload))
    out = [list(row) for row in blocks]
    for part, m in zip(parts, every):
        off = 0
        for a, b, shape, dtype in m:
            n = nbytes(shape, dtype)
            if out[a][b] is None:
                out[a][b] = part[off:off + n].clone().view(dtype).reshape(
                    shape).to(home)
            off += n
    missing = [(a, b) for a in range(nx) for b in range(ny)
               if out[a][b] is None]
    if missing:
        raise ValueError(f"blocks {missing} belong to no process")
    return out


def _neighbour(a, b, side, axis, nx, ny):
    """The grid position beside ``(a, b)`` on ``side`` (-1/+1) along mesh
    ``axis``, None past the grid's edge."""
    if axis == X_AXIS:
        return (a + side, b) if 0 <= a + side < nx else None
    return (a, b + side) if 0 <= b + side < ny else None


def _swap_strips(blocks, width, dim, axis, ranks):
    """The ghost strips this process receives from other processes'
    blocks, keyed ``(a, b, side)``: one ``batch_isend_irecv`` of every
    strip that crosses processes, posted in one global order on every
    rank, each message tagged with its place in that order."""
    me = dist.get_rank()
    nx, ny = len(blocks), len(blocks[0])
    ops, got = [], {}
    tag = 0
    for a in range(nx):
        for b in range(ny):
            for side in (-1, 1):
                src = _neighbour(a, b, side, axis, nx, ny)
                if src is None:
                    continue
                s_rank, d_rank = ranks[src[0]][src[1]], ranks[a][b]
                if s_rank != d_rank and me in (s_rank, d_rank):
                    if s_rank == me:
                        x = blocks[src[0]][src[1]]
                        d = dim % x.dim()
                        strip = _take(x, d, -width if side < 0 else 0, width)
                        ops.append(dist.P2POp(dist.isend, _to_wire(strip),
                                              d_rank, tag=tag))
                    else:
                        x = blocks[a][b]
                        d = dim % x.dim()
                        shape = list(x.shape)
                        shape[d] = width
                        got[(a, b, side)] = _wire_empty(shape, x.dtype,
                                                       x.device)
                        ops.append(dist.P2POp(dist.irecv, got[(a, b, side)],
                                              s_rank, tag=tag))
                tag += 1
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return got


def exchange_halo(blocks, width: int, dim: int, axis: str, bc: str = "zero",
                  ranks=None):
    """Return the grid ``blocks`` (``[x][y]`` lists of tensors) with each
    block extended by ``width`` ghost cells on both sides of array axis
    ``dim``, exchanged along mesh axis ``axis`` (``"x"``: the grid's first
    index, ``"y"``: its second).  On a 1-shard axis the ghosts are the pure
    boundary-condition fill.

    ``ranks``: the ``[x][y]`` owner ranks of a grid that spans processes
    (``Shards.ranks``), whose blocks of other processes are None; every
    process of the default group calls the exchange.  None: every block is
    this process's."""
    if axis not in (X_AXIS, Y_AXIS):
        raise ValueError(f"unknown mesh axis {axis!r}")
    if bc not in BCS:
        raise ValueError(f"unknown bc {bc!r}")
    if width == 0:
        return blocks
    nx, ny = len(blocks), len(blocks[0])
    for row in blocks:
        for x in row:
            if x is None:
                if ranks is None:
                    raise ValueError("a grid with blocks of other processes "
                                     "(None) needs their ranks=")
                continue
            d = dim % x.dim()
            if width > x.shape[d]:
                raise ValueError(
                    f"halo width {width} exceeds the shard extent "
                    f"{x.shape[d]} along dim {d} — use a smaller "
                    f"max_disp/sor_halo or fewer shards on this axis "
                    f"(strips would silently truncate)")
    remote = {} if ranks is None else _swap_strips(blocks, width, dim, axis,
                                                   ranks)
    out = [[None] * ny for _ in range(nx)]
    for a in range(nx):
        for b in range(ny):
            x = blocks[a][b]
            if x is None:
                continue
            d = dim % x.dim()
            with on_device(x.device):
                strips = []
                for side in (-1, 1):
                    src = _neighbour(a, b, side, axis, nx, ny)
                    if src is None:
                        strips.append(_fill(x, width, d,
                                            "lo" if side < 0 else "hi", bc))
                    elif (a, b, side) in remote:
                        strips.append(remote[(a, b, side)].to(x.device))
                    else:
                        nb = blocks[src[0]][src[1]]
                        strips.append(_take(nb, d, -width if side < 0 else 0,
                                            width).to(x.device))
                out[a][b] = torch.cat([strips[0], x, strips[1]], dim=d)
    return out

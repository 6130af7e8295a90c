"""Ranks of a multi-device run and the three collectives the dist layer
needs (counterpart of ``er3t_tpu/dist/mesh.py``).

A :class:`Mesh` lays ``n`` ranks out on two axes, as the reference's
``jax.sharding.Mesh`` does:

* ``'x'``: x-slab domain decomposition; photons migrate between
  neighbouring slabs (:mod:`.decomp`);
* ``'b'``: photon parallelism; independent photon streams, tallies summed
  (:mod:`.photon`).

Rank ``r`` sits at ``(r // nb, r % nb)``.  The collectives are
:meth:`Mesh.psum` (a sum over every rank), :meth:`Mesh.shift_x` (each rank
sends to its neighbour ``shift`` steps along the ``'x'`` ring, within its
``'b'`` column) and :meth:`Mesh.any` (a global any, read on the host).
Their values are lists with one tensor per rank held in this process
(``Mesh.local_ranks``).  Two implementations sit behind them:

* every rank in this process (:class:`LocalComm`): an exchange is a
  ``.to(device)`` copy.  This is how one card, or the CPU, hosts several
  ranks;
* one rank per process (:class:`ProcessComm`, after
  :func:`init_distributed`): ``all_reduce``, and ring exchanges posted as
  one ``batch_isend_irecv`` holding the send and the receive, so that no
  send order can deadlock.

Nothing here falls back: ``make_mesh()`` without a card raises, and a
failed process-group init is an error, never a switch to another backend.
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

__all__ = ['Mesh', 'LocalComm', 'ProcessComm', 'make_mesh',
           'init_distributed', 'rank_seed']

_M64 = (1 << 64) - 1


def _splitmix64(z: int) -> int:
    z = (z + 0x9E3779B97F4A7C15) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return z ^ (z >> 31)


def rank_seed(seed: int, rank: int) -> int:
    """The 64-bit seed of rank ``rank``'s generator in a run seeded
    ``seed``: SplitMix64 of the pair (the reference folds the rank into
    its key, ``photon.py:41-46``, ``decomp.py:126``).  Never ``seed +
    rank``: the solver seeds chunks, runs and g-points as ``seed + k``,
    and such a stream would repeat another chunk's."""
    return _splitmix64(_splitmix64(int(seed) & _M64) ^ int(rank))


class LocalComm:
    """Every rank of the mesh in this process, rank ``r`` on
    ``devices[r]``; sums land on ``devices[0]``."""

    def __init__(self, devices):
        self.devices = [torch.device(d) for d in devices]
        self.local_ranks = list(range(len(self.devices)))

    def psum(self, vals):
        dev = self.devices[0]
        out = vals[0].to(dev, copy=True)
        for v in vals[1:]:
            out += v.to(dev)
        return out

    def permute(self, vals, dst):
        out = [None] * len(vals)
        for r, v in enumerate(vals):
            out[dst[r]] = v.to(self.devices[dst[r]])
        return out

    def any(self, flags):
        dev = self.devices[0]
        return bool(torch.stack([f.to(dev) for f in flags]).any())


class ProcessComm:
    """One rank per process of the default process group, on ``device``.
    Every collective is the process group's, so it fails loudly."""

    def __init__(self, device):
        self.rank = dist.get_rank()
        self.devices = {self.rank: torch.device(device)}
        self.local_ranks = [self.rank]

    def psum(self, vals):
        (v,) = vals
        t = v.to(self.devices[self.rank], copy=True).reshape(-1)
        dist.all_reduce(t)
        return t.reshape(v.shape)

    def permute(self, vals, dst):
        (v,) = vals
        me = self.rank
        to, frm = dst[me], dst.index(me)
        if to == me:
            return [v]
        send = v.contiguous().reshape(-1)
        buf = torch.empty_like(send)
        for req in dist.batch_isend_irecv([dist.P2POp(dist.isend, send, to),
                                           dist.P2POp(dist.irecv, buf, frm)]):
            req.wait()
        return [buf.reshape(v.shape)]

    def any(self, flags):
        (f,) = flags
        t = f.to(self.devices[self.rank], torch.int32).reshape(1)
        dist.all_reduce(t)
        return bool(t.item())


class Mesh:
    """``n`` ranks on axes ``('x', 'b')``: ``shape`` (a dict) and ``size``
    as the reference's mesh has them, ``ranks`` the (x, b) array of rank
    ids, and the collectives of ``comm``."""

    def __init__(self, n: int, decomp: int, comm):
        self.ranks = np.arange(n).reshape(decomp, n // decomp)
        self.shape = {'x': decomp, 'b': n // decomp}
        self.size = n
        self.comm = comm
        self.local_ranks = comm.local_ranks

    def coords(self, rank: int):
        """(x, b) of ``rank``."""
        return divmod(rank, self.shape['b'])

    def device(self, rank: int) -> torch.device:
        """The device of a rank held in this process."""
        return self.comm.devices[rank]

    def psum(self, vals):
        """The sum over every rank of ``vals`` (one tensor per local
        rank)."""
        return self.comm.psum(vals)

    def shift_x(self, vals, shift: int):
        """What each local rank receives when every rank sends its value
        ``shift`` steps along the x ring, within its b column."""
        nx, nb = self.shape['x'], self.shape['b']
        dst = [((r // nb + shift) % nx) * nb + r % nb for r in range(self.size)]
        return self.comm.permute(vals, dst)

    def any(self, flags) -> bool:
        """True where any rank's 0-d bool is; one read on the host."""
        return self.comm.any(flags)

    def __repr__(self):
        return f'Mesh(shape={self.shape}, local_ranks={self.local_ranks})'


def init_distributed(init_method: str | None = None,
                     world_size: int | None = None, rank: int | None = None,
                     device='cuda', timeout_s: float = 300.0):
    """Start the default process group, one rank per process.

    With no arguments it is a safe no-op in one process; under
    ``torchrun`` (``RANK`` and ``WORLD_SIZE`` set, world > 1) it joins the
    group from the environment.  With explicit arguments
    (``init_method`` such as ``'tcp://localhost:29500'``, ``world_size``,
    ``rank``) it calls ``torch.distributed.init_process_group``: NCCL for
    ``device='cuda'`` (the process's card is ``LOCAL_RANK``, else ``rank``
    modulo the visible cards), gloo for ``'cpu'``, with a bounded
    ``timeout_s``.  Every failure raises (reference :29-44); a group that
    is already up is kept.  Returns the device of this process's rank."""
    explicit = init_method is not None or world_size is not None \
        or rank is not None
    if not explicit:
        if 'RANK' not in os.environ or int(os.environ.get('WORLD_SIZE',
                                                           '1')) <= 1:
            return None
        init_method = 'env://'
        world_size = int(os.environ['WORLD_SIZE'])
        rank = int(os.environ['RANK'])
    device = torch.device(device)
    if device.type == 'cuda' and device.index is None:
        local = int(os.environ.get('LOCAL_RANK', rank))
        device = torch.device('cuda', local % torch.cuda.device_count())
    if device.type == 'cuda':
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        dist.init_process_group(
            backend='nccl' if device.type == 'cuda' else 'gloo',
            init_method=init_method, world_size=int(world_size),
            rank=int(rank), timeout=datetime.timedelta(seconds=timeout_s))
    return device


def make_mesh(n_devices: int | None = None, decomp: int | None = None,
              device='cuda') -> Mesh:
    """Build a ('x', 'b') mesh of ``n_devices`` ranks, ``decomp`` of them
    on the decomposition axis 'x' (default all: pure domain
    decomposition; ``decomp=1`` is pure photon parallelism).

    Inside a process group (:func:`init_distributed`) the mesh spans the
    world, one rank per process, on this process's ``device`` (``'cuda'``:
    its card).  Otherwise every rank lives in this process: ``'cuda'``
    puts one rank on each visible card and raises without one; ``'cpu'``
    puts ``n_devices`` ranks (default 1) on the CPU; a list of devices
    puts rank ``r`` on entry ``r`` (repeats allowed, so several ranks can
    share one card)."""
    if dist.is_available() and dist.is_initialized():
        world = dist.get_world_size()
        n = n_devices or world
        if n != world:
            raise ValueError(f'requested {n} devices; a process-group mesh '
                             f'spans the world of {world} processes')
        dev = torch.device(device)
        if dev.type == 'cuda' and dev.index is None:
            dev = torch.device('cuda', torch.cuda.current_device())
        comm = ProcessComm(dev)
    else:
        if isinstance(device, (list, tuple)):
            avail = [torch.device(d) for d in device]
        elif torch.device(device).type == 'cuda':
            if not torch.cuda.is_available():
                raise RuntimeError('make_mesh: no CUDA device visible; pass '
                                   "device='cpu' for CPU ranks")
            avail = [torch.device('cuda', i)
                     for i in range(torch.cuda.device_count())]
        else:
            avail = [torch.device(device)] * (n_devices or 1)
        n = n_devices or len(avail)
        if n > len(avail):
            raise ValueError(f'requested {n} devices, only {len(avail)} '
                             f'available')
        comm = LocalComm(avail[:n])
    if decomp is None:
        decomp = n
    if n % decomp:
        raise ValueError(f'{n} devices not divisible into decomp={decomp}')
    return Mesh(n, decomp, comm)

"""Gather kernels of the TPU gather probes, and their plain versions.

Counterparts of the Pallas kernels of ``scripts/tpu_gather_probe.py``,
``tpu_gather_probe2.py``, ``tpu_gather_probe3.py`` and
``tpu_gather_probe3b.py`` (K2-K8 in PERF.md; the phase-pair prototype of
K7/K8 is :func:`er3t_tpu_torch.rtm.phase_pair.phase_pair` on bf16 or f32
tables).  On CUDA tensors each wrapper launches its hand-written kernel of
``er3t_tpu_torch/csrc/gather_probe.cu`` and adds one to its ``launches``;
on CPU tensors it runs its plain PyTorch version (``*_ref``), which the
kernel equals bit for bit: the sums run in the same order (for
``gather_row_sum``, the order of its kernel's lane groups, written down
in :func:`gather_row_sum_ref`).  Indices are
clamped into their tables (``take_reps`` wraps them, as the TPU kernel
does).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .._build import launch

__all__ = ['take_reps', 'take_reps_ref', 'gather_row_sum',
           'gather_row_sum_ref', 'row_sum_lanes', 'take2d', 'take2d_ref',
           'smem_stage', 'smem_stage_ref', 'noop', 'TAKE2D_MODES',
           'ROW_SUM_LANES']

TAKE2D_MODES = ('rows', 'axis0', 'axis1')
_MAX = 2 ** 30          # every size a kernel indexes with 32-bit ints


def _check(fn, dev, **tensors):
    """Each keyword is ``name=(tensor, dtype, ndims)``, ndims a tuple of the
    allowed dimension counts."""
    for name, (t, dt, nds) in tensors.items():
        if t.device != dev:
            raise ValueError(f'{fn}: {name} is on {t.device}, not {dev}')
        if t.dtype != dt or t.dim() not in nds:
            raise ValueError(f'{fn}: {name} must be a {dt} tensor of '
                             f'{" or ".join(map(str, nds))} dims, got '
                             f'{t.dim()}-D {t.dtype}')
        if not t.is_contiguous():
            raise ValueError(f'{fn}: {name} must be contiguous')
        if t.numel() == 0 or t.numel() >= _MAX:
            raise ValueError(f'{fn}: {name} must have 1 to 2^30 - 1 elements')
    if dev.type not in ('cpu', 'cuda'):
        raise ValueError(f'{fn}: no kernel for device {dev}')


def _launch(fn, name, dev, *args):
    launch(name, dev, *args)
    fn.launches += 1


# ---- K2: scripts/tpu_gather_probe.py:105-113 ----

def take_reps_ref(idx, tab, reps):
    """``out[b] = sum_{r<reps} tab[(idx[b] + r) mod rows, min(r, w - 1)]``,
    summed in r order (mod as jnp's %)."""
    rows, width = tab.shape
    acc = torch.zeros(idx.shape, dtype=tab.dtype, device=tab.device)
    for r in range(reps):
        row = torch.remainder(idx.long() + r, rows)
        acc = acc + tab[row, min(r, width - 1)]
    return acc


def take_reps(idx, tab, reps):
    """K2 on (B,) int32 ``idx`` and an (R, W) f32 ``tab``; (B,) f32."""
    dev = idx.device
    _check('take_reps', dev, idx=(idx, torch.int32, (1,)),
           tab=(tab, torch.float32, (2,)))
    if not 1 <= reps < _MAX:
        raise ValueError(f'take_reps: reps must be positive, got {reps}')
    if dev.type == 'cpu':
        return take_reps_ref(idx, tab, reps)
    out = torch.empty(idx.shape, dtype=torch.float32, device=dev)
    _launch(take_reps, 'take_reps', dev, idx.data_ptr(), tab.data_ptr(),
            out.data_ptr(), idx.numel(), tab.shape[0], tab.shape[1], reps)
    return out


# ---- K3: scripts/tpu_gather_probe.py:145-150; K4: :178-183 ----

ROW_SUM_LANES = (1, 2, 4, 8)    # lanes that may read one row


def row_sum_lanes(width):
    """The lanes that read one row of ``width`` floats on the card: as many
    as the row has 4-float chunks, rounded up to a power of two, at most
    8; one thread a row up to width 4 (the rule is the fastest of the lane
    counts measured at widths 1-1024: PERF.md)."""
    return min(ROW_SUM_LANES[-1], 1 << (-(-width // 4) - 1).bit_length())


def gather_row_sum_ref(idx, tab, lanes=None):
    """``out[b] = sum_c tab[clamp(idx[b]), c]`` in the kernel's order, for
    a group of ``lanes`` lanes a row (default :func:`row_sum_lanes`):

    1. the row is cut into chunks of 4 floats (the last may be short);
       chunk k belongs to lane ``k mod lanes``;
    2. each lane adds its elements to 0.0 one at a time, in index order;
    3. the lane partials ``s`` (B, lanes) are folded by halves,
       ``s = s[:, :h] + s[:, h:]`` for h = lanes/2, ..., 2, 1, which is
       what lane 0 holds after the ``__shfl_xor_sync`` butterfly of
       offsets lanes/2, ..., 1 (float addition commutes exactly).

    With one lane this is the plain column-order sum.  Padding the row
    with zeros to whole chunks adds +0.0 to partials that are never -0.0,
    which changes no bit."""
    rows, width = tab.shape
    lanes = row_sum_lanes(width) if lanes is None else lanes
    x = tab[torch.clamp(idx, 0, rows - 1).long()]
    per = -(-width // (4 * lanes))                  # chunks a lane
    x = F.pad(x, (0, per * 4 * lanes - width)).view(-1, per, lanes, 4)
    s = torch.zeros((idx.shape[0], lanes), dtype=tab.dtype, device=tab.device)
    for i in range(per):
        for k in range(4):
            s = s + x[:, i, :, k]
    while s.shape[1] > 1:
        h = s.shape[1] // 2
        s = s[:, :h] + s[:, h:]
    return s[:, 0]


def gather_row_sum(idx, tab, lanes=None):
    """K3 (the flat ``(R * W,)`` table of K3 is ``tab.view(R, W)``) and K4
    on (B,) int32 ``idx`` and an (R, W) f32 ``tab``; (B,) f32, summed in
    the order of :func:`gather_row_sum_ref` for ``lanes`` lanes a row
    (default :func:`row_sum_lanes`; another of :data:`ROW_SUM_LANES` only
    for the design sweep of ``gather_probe``)."""
    dev = idx.device
    _check('gather_row_sum', dev, idx=(idx, torch.int32, (1,)),
           tab=(tab, torch.float32, (2,)))
    lanes = row_sum_lanes(tab.shape[1]) if lanes is None else lanes
    if lanes not in ROW_SUM_LANES:
        raise ValueError(f'gather_row_sum: lanes must be one of '
                         f'{ROW_SUM_LANES}, got {lanes}')
    if dev.type == 'cpu':
        return gather_row_sum_ref(idx, tab, lanes)
    out = torch.empty(idx.shape, dtype=torch.float32, device=dev)
    _launch(gather_row_sum, 'gather_row_sum', dev, idx.data_ptr(),
            tab.data_ptr(), out.data_ptr(), idx.numel(), tab.shape[0],
            tab.shape[1], lanes)
    return out


# ---- K6: scripts/tpu_gather_probe2.py:73-102; K7/K8 mosaic_form ----

def take2d_ref(idx, tab, mode):
    """``out[i, j] = tab[r, c]``: ``rows`` r = idx[i], c = j (idx (n,) or
    (n, 1), out (n, C)); ``axis0`` r = idx[i, j], c = j; ``axis1`` r = i,
    c = idx[i, j] (out the shape of idx)."""
    rows, cols = tab.shape
    if mode == 'rows':
        return tab[torch.clamp(idx.reshape(-1), 0, rows - 1).long()]
    if mode == 'axis0':
        return torch.gather(tab, 0, torch.clamp(idx, 0, rows - 1).long())
    return torch.gather(tab, 1, torch.clamp(idx, 0, cols - 1).long())


def take2d(idx, tab, mode):
    """K6, and the take_along_axis forms of K7/K8: see :func:`take2d_ref`.
    ``tab`` is (R, C) f32, ``idx`` int32."""
    dev = idx.device
    if mode not in TAKE2D_MODES:
        raise ValueError(f'take2d: mode must be one of {TAKE2D_MODES}')
    _check('take2d', dev, idx=(idx, torch.int32, (1, 2)),
           tab=(tab, torch.float32, (2,)))
    rows, cols = tab.shape
    if mode == 'rows':
        if idx.dim() == 2 and idx.shape[1] != 1:
            raise ValueError('take2d rows: idx must be (n,) or (n, 1)')
        n_i, n_j = idx.shape[0], cols
    else:
        axis = 1 if mode == 'axis0' else 0      # the axis idx shares with tab
        if idx.dim() != 2 or idx.shape[axis] != tab.shape[axis]:
            raise ValueError(f'take2d {mode}: idx must be 2-D and match tab '
                             f'on the other axis; idx {tuple(idx.shape)}, '
                             f'tab {tuple(tab.shape)}')
        n_i, n_j = idx.shape
    if n_i * n_j >= _MAX:
        raise ValueError('take2d: output must have below 2^30 elements')
    if dev.type == 'cpu':
        return take2d_ref(idx, tab, mode)
    out = torch.empty((n_i, n_j), dtype=torch.float32, device=dev)
    _launch(take2d, 'take2d', dev, idx.data_ptr(), tab.data_ptr(),
            out.data_ptr(), TAKE2D_MODES.index(mode), n_i, n_j, rows, cols)
    return out


# ---- K5: scripts/tpu_gather_probe.py:212-213 ----

def smem_stage_ref(tab):
    """``tab[0] + tab[n - 1]`` as a (1,) tensor."""
    return (tab[0] + tab[-1]).reshape(1)


def smem_stage(tab):
    """K5 on an (n,) f32 ``tab``: one block stages the whole table in
    shared memory with bulk copies and returns ``tab[0] + tab[n - 1]`` from
    it.  The table must start at a 16-byte aligned address (the bulk copy
    needs it; a view that does not raises ``ValueError``, on any device).
    Above the card's opt-in shared memory per block the entry point is
    refused and this raises :class:`er3t_tpu_torch._build.CudaError`."""
    dev = tab.device
    _check('smem_stage', dev, tab=(tab, torch.float32, (1,)))
    if tab.numel() * 4 >= 2 ** 31:
        raise ValueError('smem_stage: table must be below 2 GiB')
    if tab.data_ptr() % 16:
        raise ValueError('smem_stage: table must start at a 16-byte aligned '
                         'address')
    if dev.type == 'cpu':
        return smem_stage_ref(tab)
    out = torch.empty(1, dtype=torch.float32, device=dev)
    _launch(smem_stage, 'smem_stage', dev, tab.data_ptr(), out.data_ptr(),
            tab.numel())
    return out


# ---- the launch floor ----

def noop(dev):
    """Launch the empty kernel (one 256-thread block) on CUDA device
    ``dev``: its time is the launch floor every kernel's time is read
    against.  Nothing to do on the CPU."""
    dev = torch.device(dev)
    if dev.type == 'cuda':
        _launch(noop, 'noop', dev)
    elif dev.type != 'cpu':
        raise ValueError(f'noop: no kernel for device {dev}')


take_reps.launches = 0
gather_row_sum.launches = 0
take2d.launches = 0
smem_stage.launches = 0
noop.launches = 0

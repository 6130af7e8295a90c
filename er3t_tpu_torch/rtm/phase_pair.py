"""Phase-function LUT pair lookup: the eval value toward the sensor and the
inverse-CDF scattering cosine, for every photon lane at once.

Counterpart of ``er3t_tpu/rtm/pallas_phase.py:phase_pair``.  On CUDA tensors
:func:`phase_pair` launches the hand-written kernel of
``er3t_tpu_torch/csrc/phase_pair.cu``; on CPU tensors it runs
:func:`phase_pair_ref`, the plain PyTorch version, which the kernel equals
bit for bit.  Both follow the reference's f32 XLA lookups
(``mc_flight.py:351-360``), not the bf16 Pallas tables.

The tables may also be bf16 (both of one dtype): that is ``make_pair`` of
``scripts/tpu_gather_probe3.py``/``tpu_gather_probe3b.py``, which looks up
``cast(pt)[row, bin]``; the values come back widened, exactly, to f32.  The
main path keeps f32 tables.
"""

from __future__ import annotations

import torch

__all__ = ['phase_pair', 'phase_pair_ref']


def phase_pair_ref(apf, row_e, mu_sc, u, pt_p, pt_mu):
    """Plain version: ``(pt_p[row_e, ib], pt_mu[apf, iu])`` as f32, with the
    bins of the reference's expression order; rows are clamped into the
    tables."""
    n_m = pt_p.shape[1]
    n_u = pt_mu.shape[1]
    ib = torch.clamp((((mu_sc + 1.0) * 0.5) * (n_m - 1) + 0.5)
                     .to(torch.int32), 0, n_m - 1)
    iu = torch.clamp((u * (n_u - 1) + 0.5).to(torch.int32), 0, n_u - 1)
    re = torch.clamp(row_e, 0, pt_p.shape[0] - 1)
    ra = torch.clamp(apf, 0, pt_mu.shape[0] - 1)
    return (pt_p[re.long(), ib.long()].float(),
            pt_mu[ra.long(), iu.long()].float())


def _check(apf, row_e, mu_sc, u, pt_p, pt_mu):
    dev = apf.device
    for name, t, dt, nd in (('apf', apf, torch.int32, 1),
                            ('row_e', row_e, torch.int32, 1),
                            ('mu_sc', mu_sc, torch.float32, 1),
                            ('u', u, torch.float32, 1),
                            ('pt_p', pt_p, pt_p.dtype, 2),
                            ('pt_mu', pt_mu, pt_p.dtype, 2)):
        if t.device != dev:
            raise ValueError(f'phase_pair: {name} is on {t.device}, apf on {dev}')
        if t.dtype != dt or t.dim() != nd:
            raise ValueError(f'phase_pair: {name} must be a {nd}-D {dt} '
                             f'tensor, got {t.dim()}-D {t.dtype}')
        if not t.is_contiguous():
            raise ValueError(f'phase_pair: {name} must be contiguous')
    if pt_p.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f'phase_pair: tables must be float32 or bfloat16, '
                         f'got {pt_p.dtype}')
    b = apf.shape[0]
    if b == 0 or any(t.shape[0] != b for t in (row_e, mu_sc, u)):
        raise ValueError('phase_pair: apf, row_e, mu_sc and u must share one '
                         'non-zero length')
    if min(pt_p.shape) == 0 or min(pt_mu.shape) == 0:
        raise ValueError('phase_pair: empty table')
    if max(b, pt_p.numel(), pt_mu.numel()) >= 2 ** 31:
        raise ValueError('phase_pair: sizes must fit a 32-bit int')


def phase_pair(apf, row_e, mu_sc, u, pt_p, pt_mu):
    """Fused ``(P_eval, mu_new)`` lookups for (B,) lanes.

    ``apf``: (B,) int32 sample-table rows; ``row_e``: (B,) int32 eval-table
    rows (``apf + Npf`` selects the TMS rows); ``mu_sc``, ``u``: (B,) f32;
    ``pt_p``: (2 Npf, Nm) and ``pt_mu``: (Npf, Nu), both f32 or both bf16;
    the results are f32.  The Rayleigh substitution for ``apf == 0`` is the
    caller's job, as in the reference.  Each kernel launch adds one to
    ``phase_pair.launches`` (f32 tables) or ``phase_pair.launches_bf16``.
    """
    _check(apf, row_e, mu_sc, u, pt_p, pt_mu)
    dev = apf.device
    if dev.type == 'cpu':
        return phase_pair_ref(apf, row_e, mu_sc, u, pt_p, pt_mu)
    if dev.type != 'cuda':
        raise ValueError(f'phase_pair: no kernel for device {dev}')
    from .._build import launch
    bf16 = pt_p.dtype == torch.bfloat16
    pe = torch.empty_like(mu_sc)
    mn = torch.empty_like(mu_sc)
    launch('phase_pair_bf16' if bf16 else 'phase_pair', dev,
           apf.data_ptr(), row_e.data_ptr(), mu_sc.data_ptr(), u.data_ptr(),
           pt_p.data_ptr(), pt_mu.data_ptr(), pe.data_ptr(), mn.data_ptr(),
           apf.shape[0], pt_p.shape[0], pt_p.shape[1], pt_mu.shape[0],
           pt_mu.shape[1])
    if bf16:
        phase_pair.launches_bf16 += 1
    else:
        phase_pair.launches += 1
    return pe, mn


phase_pair.launches = 0
phase_pair.launches_bf16 = 0

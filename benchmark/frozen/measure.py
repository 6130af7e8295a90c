"""Frozen copies of the port's measurement arithmetic; do not edit.

* ``pixel_var_per_photon``: ``bench_torch.py:119-124``
  (``_pixel_var_per_photon``);
* ``pair_cost`` and its ``_touched``: ``chip_smoke.py:994-1010``; the bytes
  and float operations that the phase-pair kernel (K1) must move;
* ``bound``: ``chip_smoke.py:1082-1087``, with the peaks of
  ``chip_smoke.py:948-949`` (H100 SXM data sheet: HBM3 3.35 TB/s, float32
  outside the tensor cores 67 TFLOP/s), returned in seconds;
* ``card_line``: ``er3t_tpu_torch/probes/gather_probe.py:80-85``.
"""

from __future__ import annotations

import subprocess

import numpy as np
import torch

__all__ = ['pixel_var_per_photon', 'pair_cost', 'bound', 'card_line',
           'HBM_BYTES_PER_S', 'F32_FLOPS']

HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet, HBM3
F32_FLOPS = 67e12                # H100 SXM data sheet, f32 outside the
                                 # tensor cores


def pixel_var_per_photon(images, n_per_run):
    """Mean-over-pixels per-photon variance from repeat images
    (bench.py:85-95): var(run mean) = var_per_photon / N."""
    imgs = np.stack(images)                    # (K, nx, ny)
    v = imgs.var(axis=0, ddof=1)               # per-pixel var of run means
    return float(v.mean()) * n_per_run


def _touched(flat):
    """Distinct table elements named by a tensor of flat offsets."""
    return int(torch.unique(flat).numel())


def pair_cost(apf, row_e, mu, u, pt_p, pt_mu):
    """16 B in and 8 B out per lane, and the table entries it reads; the
    bins as phase_pair_ref computes them."""
    n_m, n_u = pt_p.shape[1], pt_mu.shape[1]
    ib = torch.clamp((((mu + 1.0) * 0.5) * (n_m - 1) + 0.5).to(torch.int32),
                     0, n_m - 1)
    iu = torch.clamp((u * (n_u - 1) + 0.5).to(torch.int32), 0, n_u - 1)
    ev = torch.clamp(row_e, 0, pt_p.shape[0] - 1).long() * n_m + ib
    sm = torch.clamp(apf, 0, pt_mu.shape[0] - 1).long() * n_u + iu
    b = apf.numel()
    return (24 * b + pt_p.element_size() * (_touched(ev) + _touched(sm)),
            6 * b)


def bound(cost):
    """(bound_s, bound_by) of (bytes, ops): the least time the chip could
    take, and which of the two peaks sets it."""
    nbytes, ops = cost
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS
    return max(t_b, t_o), 'bytes' if t_b >= t_o else 'operations'


def card_line() -> str:
    """The card as ``nvidia-smi --query-gpu=name,power.limit`` gives it."""
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]

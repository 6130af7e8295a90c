"""Frozen copy of ``er3t_tpu_torch/pre/sfc.py:19, 54-77, 86-130``
(``SFC_COXMUNK``, the five-channel part of ``sfc_2d_gen``,
``cal_ocean_brdf``, ``sfc_ocean``, at 33c2d55), kept for the benchmark's
inputs and its plain reference; do not edit.  ``Surface`` is the frozen
copy of :mod:`.sfc`, the refractive index of water that of :mod:`.water`.
"""

from __future__ import annotations

import numpy as np

from .sfc import Surface
from .water import water_refractive_index

__all__ = ['SFC_COXMUNK', 'cal_ocean_brdf', 'sfc_ocean']

SFC_COXMUNK = 2


def cal_ocean_brdf(wvl=650.0, u10=1.0, sal=34.3, pcl=0.01, whitecaps=True):
    """Cox-Munk ocean BRDF parameter set.

    Same parameterization as the reference (sfc/util.py:14-150): Hale & Querry
    water refractive index + Friedman salinity correction; Cox & Munk (1954)
    slope variance 0.00512*u10 + 0.003; Koepke (1984) whitecap fraction
    2.95e-6 * u10^3.52 and spectral whitecap albedo.

    Returns dict of scalars or arrays matching the shape of ``u10``.
    """
    u10 = np.asarray(u10, dtype=np.float64)
    refrac_r, refrac_i = water_refractive_index(wvl)
    refrac_r = refrac_r + 0.006 * (sal / 34.3)

    slope = 0.00512 * u10 + 0.003

    if whitecaps:
        wc_wvl = np.arange(200.0, 4001.0, 100.0)
        wc_ref = np.array([
            0.220, 0.220, 0.220, 0.220, 0.220, 0.220, 0.215, 0.210, 0.200, 0.190,
            0.175, 0.155, 0.130, 0.080, 0.100, 0.105, 0.100, 0.080, 0.045, 0.055,
            0.065, 0.060, 0.055, 0.040, 0.000, 0.000, 0.000, 0.000, 0.000, 0.000,
            0.000, 0.000, 0.000, 0.000, 0.000, 0.000, 0.000, 0.000, 0.000])
        diffuse_frac = 2.95e-06 * u10 ** 3.52
        diffuse_alb = np.interp(wvl, wc_wvl, wc_ref) * np.ones_like(u10)
    else:
        diffuse_frac = np.zeros_like(u10)
        diffuse_alb = np.zeros_like(u10)

    return {
        'diffuse_alb': diffuse_alb,
        'diffuse_frac': diffuse_frac,
        'refrac_r': refrac_r * np.ones_like(u10),
        'refrac_i': refrac_i * np.ones_like(u10),
        'slope': slope,
    }


def sfc_ocean(wvl=650.0, u10=1.0, nx=1, ny=1, **kw) -> Surface:
    """Convenience: uniform Cox-Munk ocean surface."""
    p = cal_ocean_brdf(wvl=wvl, u10=u10, **kw)
    data = np.zeros((nx, ny, 5))
    for i, k in enumerate(['diffuse_alb', 'diffuse_frac', 'refrac_r', 'refrac_i', 'slope']):
        data[..., i] = p[k]
    # sfc_2d_gen of (Nx, Ny, 5) parameter maps: Cox-Munk DSM parameters
    jsfc = np.full((nx, ny), SFC_COXMUNK, dtype=np.int32)
    return Surface(jsfc=jsfc, psfc=data.copy())

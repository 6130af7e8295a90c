"""Surface characterization: Lambertian, LSRT and Cox-Munk maps (NumPy copy
of ``er3t_tpu/pre/sfc.py``: ``Surface`` and its type codes :11-55,
``sfc_lambertian``, ``sfc_2d_gen`` :47-81, ``sfc_sat`` :84-88,
``cal_ocean_brdf`` and ``sfc_ocean`` :91-135).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..physics.water import water_refractive_index

__all__ = ['Surface', 'sfc_lambertian', 'sfc_2d_gen', 'sfc_sat',
           'cal_ocean_brdf', 'sfc_ocean', 'SFC_LAMBERTIAN', 'SFC_COXMUNK', 'SFC_LSRT']

SFC_LAMBERTIAN = 1
SFC_COXMUNK = 2
SFC_LSRT = 4


@dataclasses.dataclass
class Surface:
    """2D surface map: per-pixel BRDF type and parameters.

    ``jsfc`` (Nx, Ny) int type codes; ``psfc`` (Nx, Ny, 5) parameters.
    A uniform surface is represented with Nx=Ny=1 (the scene builder
    broadcasts it).
    """
    jsfc: np.ndarray
    psfc: np.ndarray

    @property
    def nx(self) -> int:
        return self.jsfc.shape[0]

    @property
    def ny(self) -> int:
        return self.jsfc.shape[1]


def sfc_lambertian(albedo) -> Surface:
    """Uniform or 2D Lambertian surface from a scalar / (Nx, Ny) albedo."""
    alb = np.atleast_2d(np.asarray(albedo, dtype=np.float64))
    alb = np.clip(alb, 0.0, 1.0)
    nx, ny = alb.shape
    jsfc = np.full((nx, ny), SFC_LAMBERTIAN, dtype=np.int32)
    psfc = np.zeros((nx, ny, 5), dtype=np.float64)
    psfc[..., 0] = alb
    return Surface(jsfc=jsfc, psfc=psfc)


def sfc_2d_gen(data: np.ndarray) -> Surface:
    """Typed 2D surface from parameter maps (reference sfc_2d_gen semantics).

    (Nx, Ny) or (Nx, Ny, 1): Lambertian albedo.
    (Nx, Ny, 3): LSRT kernel weights (f_iso, f_geo, f_vol).
    (Nx, Ny, 5): Cox-Munk DSM parameters.
    """
    data = np.asarray(data, dtype=np.float64)
    if data.ndim == 2:
        data = data[..., None]
    nx, ny, npar = data.shape
    psfc = np.zeros((nx, ny, 5), dtype=np.float64)
    if npar == 1:
        jsfc = np.full((nx, ny), SFC_LAMBERTIAN, dtype=np.int32)
        psfc[..., 0] = np.clip(data[..., 0], 0.0, 1.0)
    elif npar == 3:
        jsfc = np.full((nx, ny), SFC_LSRT, dtype=np.int32)
        psfc[..., :3] = data
    elif npar == 5:
        jsfc = np.full((nx, ny), SFC_COXMUNK, dtype=np.int32)
        psfc[...] = data
    else:
        raise ValueError('surface parameter maps must have 1, 3 or 5 channels')
    return Surface(jsfc=jsfc, psfc=psfc)

def sfc_sat(sat_obj) -> Surface:
    """Surface from a satellite reader exposing ``data['alb_2d']``
    (reference: sfc_sat.py:95-112)."""
    alb = np.asarray(sat_obj.data['alb_2d']['data'], dtype=np.float64)
    return sfc_lambertian(alb)


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
    return sfc_2d_gen(data)

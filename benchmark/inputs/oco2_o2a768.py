"""Inputs of the configuration ``oco2_o2a768``: the OCO-2 O2 A-band scene
of projects/01 (``main_pre``'s synthetic cloud map, ``main_sim``'s
atmosphere, absorption and cloud, and the Cox-Munk ocean that the
configuration assumes in place of upstream's albedo map), made from
frozen copies.

The cloud map is ``main_pre``'s recipe with no granule, scaled by area to
the configuration's grid: ``disks`` disks of COT uniform in ``cot``, each
a radius of ``radius_px`` pixels (both ends included) around a centre at
least ``margin_px`` pixels from the edges; a later disk overwrites an
earlier one where they overlap.  The ocean goes to both sides as the
``surface`` object of ``solve``.
"""

from __future__ import annotations

import numpy as np

from ..frozen import absco, atm, cld_cop, ocean
from ..lib.inputs import Inputs

__all__ = ['make_inputs', 'cloud_map']


def cloud_map(nx, ny, seed, disks, radius_px, cot, margin_px):
    """(Nx, Ny) COT map of ``disks`` random disks, as projects/01's
    ``main_pre`` draws them."""
    rng = np.random.default_rng(seed)
    out = np.zeros((nx, ny))
    ii, jj = np.meshgrid(np.arange(nx), np.arange(ny), indexing='ij')
    for _ in range(int(disks)):
        i = rng.integers(margin_px, nx - margin_px)
        j = rng.integers(margin_px, ny - margin_px)
        r = rng.integers(radius_px[0], radius_px[1] + 1)
        out[(ii - i) ** 2 + (jj - j) ** 2 <= r ** 2] = rng.uniform(*cot)
    return out


def make_inputs(config):
    """Inputs of the configuration dict ``config``."""
    a = atm.atm_atmmod(np.asarray(config['levels_km'], dtype=np.float64))
    if config['absorption'] != 'abs_synthetic':
        raise ValueError(f"unknown absorption {config['absorption']!r}")
    ab = absco.abs_synthetic(float(config['wavelength_nm']), a,
                             ng=int(config['ng']))
    c = config['cloud']
    if c['generator'] != 'cld_gen_cop':
        raise ValueError('unknown cloud generator')
    cot = cloud_map(c['nx'], c['ny'], **c['map'])
    cloudy = cot > 0
    cth = np.where(cloudy, c['cth_km'], 0.0)
    cloud = cld_cop.cld_gen_cop(
        cot, np.where(cloudy, c['cer_um'], 0.0), cth,
        cgt_2d=np.minimum(c['cgt_km'], cth), dx=c['dx'], dy=c['dy'],
        dz=c['dz'])
    s = config['surface']
    if s['generator'] != 'sfc_ocean':
        raise ValueError('unknown surface generator')
    sfc = ocean.sfc_ocean(wvl=s['wvl'], u10=s['u10'])
    mie = config.get('mie')
    return Inputs(atm=a, abs_coef=ab, cld=cloud,
                  mie=None if mie is None else dict(mie),
                  solve_kw=dict(config['solve']),
                  solve_objects={'surface': sfc})

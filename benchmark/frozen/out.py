"""Frozen copy of ``er3t_tpu_torch/rtm/out.py:30-31, 48-76, 103-130`` (``_host``,
``spectral_factors``, ``reduce_radiance``, ``reduce_flux``), kept for the benchmark's inputs and its plain
reference; do not edit.
"""

from __future__ import annotations

import numpy as np

from .solar import sol_fac as _sol_fac


def _host(t):
    return t.detach().cpu().numpy() if hasattr(t, 'detach') else t


def spectral_factors(abs_coef, date=None, nz_out: int | None = None):
    """(Nz_out, Ng) factors + scalar TOA irradiance (reference protocol)."""
    w = abs_coef.weight
    slit = abs_coef.slit_func
    sol = abs_coef.solar
    sf = _sol_fac(date)
    nz = nz_out or slit.shape[0] + 1
    zz = np.arange(nz)
    zz = np.clip(zz, 0, slit.shape[0] - 1)
    if nz > 1:
        zz[-1] = zz[-2]
    norm = sf / (w[None, :] * slit[zz, :]).sum(axis=1)          # (Nz_out,)
    factors = norm[:, None] * sol[None, :] * w[None, :] * slit[zz, :]
    toa = float(np.sum(sf * sol * w))
    return factors, toa


def reduce_radiance(tally_rad, n_launched: int, abs_coef, mu0: float,
                    date=None, precontracted=False):
    """Physical radiance (Nx, Ny) [W/m^2/nm/sr] from a raw (Nx, Ny, Ng)
    radiance tally.

    ``precontracted``: the tally's g axis is a singleton already contracted
    with the spectral factors in the step (``rad_w``)."""
    tally_rad = _host(tally_rad)
    nx, ny, ng = tally_rad.shape
    factors, toa = spectral_factors(abs_coef, date=date, nz_out=1)
    raw = tally_rad * (mu0 * nx * ny / max(n_launched, 1))
    rad = raw[..., 0] if precontracted else raw @ factors[0]
    return {'rad': rad, 'toa': toa}



    raw = tally_rad * (mu0 * domain_area_m2 / max(n_launched, 1))
    rad = (raw[..., 0] if precontracted else raw @ factors[0]) / d_omega
    return {'rad': rad, 'toa': toa, 'solid_angle': d_omega}


def reduce_flux(tally_flux, n_launched: int, abs_coef, mu0: float, date=None,
                precontracted=False):
    """Physical fluxes from a raw (Nxf, Nyf, Nlev, 3, Ng) flux tally: a dict
    of (Nxf, Nyf, Nlev) arrays [W/m^2/nm] ``f_down_direct``,
    ``f_down_diffuse``, ``f_up``, ``f_down``, and ``toa``.

    Each of the Nxf*Nyf columns receives an equal share of the uniformly
    launched budget, so the per-area normalization is (Nxf*Nyf)/N.
    ``precontracted``: the g axis is a singleton already contracted with
    the spectral factors in the step (``flux_w``)."""
    tally_flux = _host(tally_flux)
    nlev = tally_flux.shape[2]
    factors, toa = spectral_factors(abs_coef, date=date, nz_out=nlev)
    n_col = tally_flux.shape[0] * tally_flux.shape[1]
    raw = tally_flux * (mu0 * n_col / max(n_launched, 1))
    if precontracted:
        phys = raw[..., 0]
    else:
        phys = np.einsum('xyzcg,zg->xyzc', raw, factors)
    return {'f_down_direct': phys[..., 0], 'f_down_diffuse': phys[..., 1],
            'f_up': phys[..., 2], 'f_down': phys[..., 0] + phys[..., 1],
            'toa': toa}

"""Spectral reduction of raw tallies to physical units, and the diffusion
smoothing of fields (port of ``er3t_tpu/rtm/out.py:28-177``; NumPy, as in
the reference).

    factor(iz, ig) = sol_fac * solar(ig) * weight(ig) * slit(iz, ig)
                     / sum_g[weight * slit(iz, :)]

Raw tallies are per photon of unit weight launched at TOA, normalized to
unit horizontal TOA solar flux: raw_flux = tally/N * mu0 (per column:
times Nxf * Nyf) and raw_radiance = tally/N * mu0 * nx * ny; a camera
tally is a flux at the sensor per fisheye pixel, over the pixel's solid
angle.  Heating rates come from the direct absorbed-energy tally or from
level net fluxes.  A torch tensor given as a tally is copied to the host.
"""

from __future__ import annotations

import numpy as np

from ..physics.solar import sol_fac as _sol_fac

__all__ = ['spectral_factors', 'reduce_flux', 'reduce_radiance',
           'reduce_camera_radiance', 'heating_rate',
           'heating_rate_from_absorbed', 'smooth_diffusion']

_CP = 1004.0            # specific heat of dry air [J/kg/K]
_RD = 287.0             # gas constant of dry air [J/kg/K]


def _host(t):
    return t.detach().cpu().numpy() if hasattr(t, 'detach') else t


def smooth_diffusion(field, n_iter=1, axes=(0, 1)):
    """``n_iter`` explicit diffusion steps of a noisy MC field over its
    horizontal ``axes`` (periodic), each the 5-point stencil
    f <- f/2 + (sum of the 4 neighbours)/8, in f64; the field total is
    conserved (MCARaTS ``Flx_diff0/1``, ``Rad_difr0/1``)."""
    f = np.asarray(field, dtype=np.float64).copy()
    a0, a1 = axes
    for _ in range(int(n_iter)):
        nb = (np.roll(f, 1, axis=a0) + np.roll(f, -1, axis=a0)
              + np.roll(f, 1, axis=a1) + np.roll(f, -1, axis=a1))
        f = 0.5 * f + 0.125 * nb
    return f


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


def reduce_camera_radiance(tally_rad, n_launched, abs_coef, mu0,
                           domain_area_m2, qmax_deg, date=None,
                           precontracted=False):
    """Physical fisheye radiance [W/m^2/nm/sr] from a raw (npix, npix, Ng)
    camera tally: the photon normalization E mu0 A_domain / N, then each
    pixel's solid angle under the equidistant projection; pixels outside
    the fisheye circle are NaN.  Returns ``rad``, ``toa`` and
    ``solid_angle``.  ``precontracted``: as in :func:`reduce_radiance`."""
    tally_rad = _host(tally_rad)
    nx, ny, ng = tally_rad.shape
    factors, toa = spectral_factors(abs_coef, date=date, nz_out=1)
    i, j = np.meshgrid(np.arange(nx), np.arange(ny), indexing='ij')
    px = (i + 0.5) / nx * 2 - 1
    py = (j + 0.5) / ny * 2 - 1
    pr = np.sqrt(px ** 2 + py ** 2)
    qmax = np.deg2rad(qmax_deg)
    theta = pr * qmax
    inside = pr < 1.0
    # dOmega = sin(theta) dtheta dphi, with pr = theta / qmax
    with np.errstate(invalid='ignore', divide='ignore'):
        sinc = np.where(pr > 1e-6, np.sin(theta) / np.maximum(pr, 1e-6), qmax)
    d_omega = sinc * qmax * (2.0 / nx) * (2.0 / ny)
    d_omega = np.where(inside, d_omega, np.nan)

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


def _heat_capacity(atm):
    """Per-layer air heat capacity per area rho * cp * dz [J/m^2/K]."""
    dz_m = atm.lay.thickness * 1000.0
    rho = atm.lay.pressure * 100.0 / (_RD * atm.lay.temperature)
    return rho * _CP * dz_m


def heating_rate(flux: dict, atm):
    """Heating rate [K/day] per layer from the level net fluxes of
    :func:`reduce_flux`: the net-flux convergence over the layer's air
    heat capacity."""
    f_net = flux['f_down'] - flux['f_up']                       # (..., Nlev)
    d_fnet = f_net[..., 1:] - f_net[..., :-1]
    return d_fnet / _heat_capacity(atm) * 86400.0


def heating_rate_from_absorbed(absorbed_tally, n_launched, abs_coef, mu0,
                               atm, date=None):
    """Heating rate [K/day] from the step's direct (Nz, Ng) absorbed-energy
    tally: the flux tallies' photon normalization and factor chain (the
    layer-bottom level factors), then the layer heat capacity."""
    absorbed_tally = np.asarray(_host(absorbed_tally))
    nz, ng = absorbed_tally.shape
    factors, _ = spectral_factors(abs_coef, date=date, nz_out=nz + 1)
    abs_phys = (absorbed_tally * factors[:nz]).sum(axis=1) \
        * (mu0 / max(n_launched, 1))                        # W/m^2/nm
    return abs_phys / _heat_capacity(atm) * 86400.0

"""Spectral reduction of raw radiance tallies to physical units (port of
``er3t_tpu/rtm/out.py:47-106``; NumPy, as in the reference).

    factor(iz, ig) = sol_fac * solar(ig) * weight(ig) * slit(iz, ig)
                     / sum_g[weight * slit(iz, :)]

Raw tallies are per photon of unit weight launched at TOA, normalized to
unit horizontal TOA solar flux: raw_radiance = tally/N * mu0 * nx * ny.
Flux and camera reductions are not ported yet (ROADMAP A8, A9).
"""

from __future__ import annotations

import numpy as np

from ..physics.solar import sol_fac as _sol_fac

__all__ = ['spectral_factors', 'reduce_radiance']


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
    radiance tally (NumPy array; a torch tensor is copied to the host).

    ``precontracted``: the tally's g axis is a singleton already contracted
    with the spectral factors in the step (``rad_w``)."""
    if hasattr(tally_rad, 'detach'):
        tally_rad = tally_rad.detach().cpu().numpy()
    nx, ny, ng = tally_rad.shape
    factors, toa = spectral_factors(abs_coef, date=date, nz_out=1)
    raw = tally_rad * (mu0 * nx * ny / max(n_launched, 1))
    rad = raw[..., 0] if precontracted else raw @ factors[0]
    return {'rad': rad, 'toa': toa}

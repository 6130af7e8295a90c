"""Legendre-moment (pmom) phase-function machinery (NumPy copy of
``er3t_tpu/pre/pmom.py:17-174``: ``phase2mom``, ``legendre2phase``,
``mom2phase``, ``mom2phaseint``, ``read_pmom`` and ``pha_mie_wc_pmom``).

Moments are computed from the tabulated Mie phase functions by
Gauss-Legendre projection, or read from a libRadtran ``wc.sol.mie.cdf``
moment table with :func:`read_pmom`.  ``pmom[l]`` are the unweighted
Legendre moments (pmom[0] = 1, pmom[1] = g); reconstruction multiplies by
(2l+1), and ``deltascaling`` applies the delta-M transform (Wiscombe 1977).
"""

from __future__ import annotations

import numpy as np

__all__ = ['phase2mom', 'legendre2phase', 'mom2phase', 'mom2phaseint',
           'read_pmom', 'pha_mie_wc_pmom']


def phase2mom(ang_deg: np.ndarray, pha: np.ndarray, n_mom: int) -> np.ndarray:
    """Project a tabulated phase function onto Legendre moments.

    m_l = (1/2) int_{-1}^{1} P(mu) P_l(mu) dmu, so m_0 = 1 for a phase
    function normalized to int P dmu = 2 and m_1 = asymmetry parameter.
    Uses Gauss-Legendre quadrature dense enough for the moment order.
    """
    mu = np.cos(np.deg2rad(np.asarray(ang_deg, dtype=np.float64)))
    order = np.argsort(mu)
    mu_s, p_s = mu[order], np.asarray(pha, dtype=np.float64)[order]
    nq = max(4 * n_mom, 256)
    xq, wq = np.polynomial.legendre.leggauss(nq)
    pq = np.interp(xq, mu_s, p_s)
    mom = np.empty(n_mom, dtype=np.float64)
    pl_m2 = np.ones_like(xq)       # P_0
    pl_m1 = xq                     # P_1
    for l in range(n_mom):
        if l == 0:
            pl = pl_m2
        elif l == 1:
            pl = pl_m1
        else:
            pl = ((2.0 * l - 1.0) * xq * pl_m1 - (l - 1.0) * pl_m2) / l
            pl_m2, pl_m1 = pl_m1, pl
        mom[l] = 0.5 * np.sum(wq * pq * pl)
    return mom


def legendre2phase(poly_coef, angle=None, deltascaling=True, normalize=False,
                   step=0.01):
    """Reconstruct P(angle) from unweighted Legendre moments.

    Mirrors the reference's ``legendre2phase`` (pha_mie.py:229-260):
    optional delta-M scaling by the last moment, (2l+1) weighting, then a
    Legendre series evaluation.
    """
    poly_coef = np.array(poly_coef, dtype=np.float64)
    n_poly = poly_coef.size
    if deltascaling:
        poly_coef = (poly_coef - poly_coef[-1]) / (1.0 - poly_coef[-1])
    poly_coef *= 2.0 * np.arange(n_poly) + 1.0
    if normalize:
        poly_coef *= 1.0 / poly_coef[0]
    if angle is None:
        angle = np.arange(0.0, 180.0 + step, step)
    mu = np.cos(np.deg2rad(angle))
    return np.polynomial.legendre.legval(mu, poly_coef)


def mom2phase(polys, mu):
    """Legendre series at ``mu`` via upward recurrence; ``polys`` are the
    (2l+1)-weighted coefficients (reference pha_mie.py:262-293, after
    libRadtran miecalc.c)."""
    polys = np.asarray(polys, dtype=np.float64)
    mu = np.asarray(mu, dtype=np.float64)
    plm2 = np.ones_like(mu)
    plm1 = mu.copy()
    pha = plm2 * polys[0] + plm1 * polys[1]
    for i in range(2, polys.size):
        plm0 = ((2.0 * i - 1.0) * mu * plm1 - (i - 1.0) * plm2) / i
        pha = pha + polys[i] * plm0
        plm2, plm1 = plm1, plm0
    return pha


def mom2phaseint(polys, mu):
    """Integral of the Legendre series from ``mu`` to 1 (reference
    pha_mie.py:295-331, after libRadtran phase.c)."""
    polys = np.asarray(polys, dtype=np.float64)
    mu = np.asarray(mu, dtype=np.float64)
    plm2 = np.ones_like(mu)
    plm1 = mu.copy()
    pldashm2 = np.zeros_like(mu)
    pldashm1 = np.ones_like(mu)
    pha_int = (1.0 - mu) * polys[0] + 0.5 * (1.0 - mu ** 2) * polys[1]
    for i in range(2, polys.size):
        plm0 = ((2.0 * i - 1.0) * mu * plm1 - (i - 1.0) * plm2) / i
        pldashm0 = ((2.0 * i - 1.0) * (plm1 + mu * pldashm1)
                    - (i - 1.0) * pldashm2) / i
        pha_int = pha_int + polys[i] * (1.0 - mu ** 2) / (i * (i + 1.0)) * pldashm0
        plm2, plm1 = plm1, plm0
        pldashm2, pldashm1 = pldashm1, pldashm0
    return pha_int


def read_pmom(fname):
    """Read a libRadtran moment LUT (netCDF): returns (wvl[nm], reff,
    ssa, pmom) — reference pha_mie.py:333-376."""
    from ..util.ncio import read_var
    wvl = np.asarray(read_var(fname, 'wavelen')) * 1000.0
    ref = np.asarray(read_var(fname, 'reff'))
    ssa = np.asarray(read_var(fname, 'ssa'))
    pmom = np.asarray(read_var(fname, 'pmom'))
    if pmom.ndim == 4:
        pmom = pmom[:, :, 0, :]    # first Stokes component
    return wvl, ref, ssa, pmom


class pha_mie_wc_pmom:
    """Mie water-cloud phase set represented by Legendre moments.

    The reference class (pha_mie.py:229 area) reads moments from a
    libRadtran LUT and reconstructs P(theta) with ``legendre2phase``.  Here
    the moments are computed from the in-framework Mie tables; pass
    ``fname_pmom`` to use a libRadtran LUT instead.  ``data`` carries the
    same fields as :class:`pha_mie_wc` plus ``pmom``.
    """

    ID = 'Mie-pmom'

    def __init__(self, wavelength=650.0, n_mom=512, reff_grid=None,
                 fname_pmom=None, angles=None):
        from .pha import pha_mie_wc
        if fname_pmom is not None:
            wvl_t, ref, ssa_t, pmom_t = read_pmom(fname_pmom)
            iw = int(np.argmin(np.abs(wvl_t - wavelength)))
            pmom = pmom_t[iw][:, :n_mom]
            # normalize to unweighted moments with pmom[0] = 1
            pmom = pmom / pmom[:, :1]
            ssa = ssa_t[iw]
            asy = pmom[:, 1].copy()
        else:
            base = pha_mie_wc(wavelength, reff_grid=reff_grid, angles=angles)
            ang = base.data['ang']
            pha = base.data['pha']
            ref = base.data['ref']
            ssa = base.data['ssa']
            asy = base.data['asy']
            pmom = np.stack([phase2mom(ang, pha[:, i], n_mom)
                             for i in range(pha.shape[1])], axis=0)
        if angles is None:
            angles = np.concatenate([np.arange(0.0, 2.0, 0.01),
                                     np.arange(2.0, 5.0, 0.05),
                                     np.arange(5.0, 180.0, 0.25),
                                     [180.0]])
        pha_rec = np.stack(
            [legendre2phase(pmom[i], angle=angles, deltascaling=False)
             for i in range(pmom.shape[0])], axis=1)
        self.wvl = float(wavelength)
        self.data = {
            'id': self.ID,
            'wvl0': float(wavelength),
            'wvl': float(wavelength),
            'ang': np.asarray(angles, dtype=np.float64),
            'pha': np.maximum(pha_rec, 0.0),
            'pmom': pmom,
            'ssa': np.asarray(ssa, dtype=np.float64),
            'asy': np.asarray(asy, dtype=np.float64),
            'ref': np.asarray(ref, dtype=np.float64),
        }

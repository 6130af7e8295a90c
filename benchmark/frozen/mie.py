"""Frozen copy of ``er3t_tpu_torch/physics/mie.py (whole, at bdb0f8e)``, kept for the benchmark's inputs and its
plain reference; do not edit.

Mie scattering for water-cloud droplets over a gamma size distribution
(NumPy copy of ``er3t_tpu/physics/mie.py:15-182``; Bohren & Huffman 1983,
Wiscombe 1980, Hansen & Travis 1974).
"""

from __future__ import annotations

import numpy as np

from .water import water_refractive_index

__all__ = ['mie_single', 'mie_gamma_dist', 'default_angle_grid']


def default_angle_grid() -> np.ndarray:
    """Scattering-angle grid [deg], fine near 0 (forward peak) and 180 (glory).

    Matches the resolution strategy of the reference
    (er3t/pre/pha/pha_mie.py:106-113).
    """
    return np.concatenate((
        np.arange(0.0, 2.0, 0.01),
        np.arange(2.0, 5.0, 0.05),
        np.arange(5.0, 10.0, 0.1),
        np.arange(10.0, 15.0, 0.5),
        np.arange(15.0, 176.0, 1.0),
        np.arange(176.0, 180.05, 0.25),
    ))


def _nstop(x: float) -> int:
    return int(np.ceil(x + 4.0 * x ** (1.0 / 3.0) + 2.0))


def mie_single(x: float, m: complex, mu: np.ndarray):
    """Mie solution for a single sphere.

    Parameters
    ----------
    x : size parameter 2*pi*r/lambda
    m : complex refractive index (absorbing part positive imaginary)
    mu : (Na,) cosines of scattering angles

    Returns (qext, qsca, g, i_unpol) where i_unpol = (|S1|^2 + |S2|^2)/2
    evaluated at ``mu`` (unnormalized intensity).
    """
    ns = _nstop(x)
    n = np.arange(1, ns + 1, dtype=np.float64)

    # logarithmic derivative D_n(mx) by downward recurrence
    mx = m * x
    nmx = int(max(ns, abs(mx)) + 16)
    D = np.zeros(nmx + 1, dtype=np.complex128)
    for k in range(nmx, 0, -1):
        D[k - 1] = k / mx - 1.0 / (D[k] + k / mx)
    D = D[1:ns + 1]

    # Riccati-Bessel psi, chi by upward recurrence
    psi = np.empty(ns + 1)
    chi = np.empty(ns + 1)
    psi_m1, psi[0] = np.cos(x), np.sin(x)          # psi_{-1}, psi_0
    chi_m1, chi[0] = -np.sin(x), np.cos(x)
    for k in range(1, ns + 1):
        psi[k] = (2 * k - 1) / x * psi[k - 1] - (psi_m1 if k == 1 else psi[k - 2])
        chi[k] = (2 * k - 1) / x * chi[k - 1] - (chi_m1 if k == 1 else chi[k - 2])
    xi = psi - 1j * chi

    psi_n, psi_nm1 = psi[1:], psi[:-1]
    xi_n, xi_nm1 = xi[1:], xi[:-1]

    fa = D / m + n / x
    fb = D * m + n / x
    a = (fa * psi_n - psi_nm1) / (fa * xi_n - xi_nm1)
    b = (fb * psi_n - psi_nm1) / (fb * xi_n - xi_nm1)

    qext = 2.0 / (x * x) * np.sum((2 * n + 1) * (a + b).real)
    qsca = 2.0 / (x * x) * np.sum((2 * n + 1) * (np.abs(a) ** 2 + np.abs(b) ** 2))

    gq = (np.sum(n[:-1] * (n[:-1] + 2.0) / (n[:-1] + 1.0)
                 * (a[:-1] * np.conj(a[1:]) + b[:-1] * np.conj(b[1:])).real)
          + np.sum((2 * n + 1) / (n * (n + 1)) * (a * np.conj(b)).real))
    g = 4.0 / (x * x) * gq / max(qsca, 1e-30)

    # angular functions pi_n, tau_n and amplitudes
    na = mu.size
    pi_nm1 = np.zeros(na)          # pi_0
    pi_n = np.ones(na)             # pi_1
    s1 = np.zeros(na, dtype=np.complex128)
    s2 = np.zeros(na, dtype=np.complex128)
    for k in range(1, ns + 1):
        tau_n = k * mu * pi_n - (k + 1) * pi_nm1
        f = (2 * k + 1) / (k * (k + 1))
        s1 += f * (a[k - 1] * pi_n + b[k - 1] * tau_n)
        s2 += f * (a[k - 1] * tau_n + b[k - 1] * pi_n)
        pi_next = ((2 * k + 1) * mu * pi_n - (k + 1) * pi_nm1) / k
        pi_nm1, pi_n = pi_n, pi_next

    i_unpol = 0.5 * (np.abs(s1) ** 2 + np.abs(s2) ** 2)
    return qext, qsca, g, i_unpol


def mie_gamma_dist(wvl_nm: float, reff_um, veff: float = 0.1,
                   angles_deg: np.ndarray | None = None, n_quad: int = 48):
    """Size-distribution-averaged Mie optical properties for water droplets.

    Gamma distribution n(r) ~ r^((1-3v)/v) exp(-r/(r_eff v)) (Hansen & Travis
    1974) for each effective radius in ``reff_um``.

    Returns dict with:
        'ang'  (Na,)      scattering angles [deg]
        'pha'  (Na, Nr)   phase function, normalized so that
                          integral over mu of P dmu = 2
        'ssa'  (Nr,)      single-scattering albedo
        'asy'  (Nr,)      asymmetry parameter
        'qe'   (Nr,)      mean extinction efficiency
        'ref'  (Nr,)      effective radii [um]
    """
    reff_um = np.atleast_1d(np.asarray(reff_um, dtype=np.float64))
    if angles_deg is None:
        angles_deg = default_angle_grid()
    mu = np.cos(np.deg2rad(angles_deg))

    nr_re, nr_im = water_refractive_index(wvl_nm)
    m = complex(nr_re, nr_im)
    lam_um = wvl_nm * 1e-3

    nref = reff_um.size
    na = angles_deg.size
    pha = np.zeros((na, nref))
    ssa = np.zeros(nref)
    asy = np.zeros(nref)
    qe = np.zeros(nref)

    alpha = (1.0 - 3.0 * veff) / veff  # gamma shape exponent

    for ir, reff in enumerate(reff_um):
        b = reff * veff
        # quadrature over r covering the distribution mass
        r_lo = max(reff * 0.02, 0.02)
        r_hi = reff * (1.0 + 8.0 * np.sqrt(veff))
        r = np.linspace(r_lo, r_hi, n_quad)
        w = r ** alpha * np.exp(-r / b)
        w /= w.sum()

        csca_sum = 0.0
        cext_sum = 0.0
        gsum = 0.0
        isum = np.zeros(na)
        area_sum = 0.0
        for rj, wj in zip(r, w):
            xj = 2.0 * np.pi * rj / lam_um
            qext_j, qsca_j, g_j, i_j = mie_single(xj, m, mu)
            area = np.pi * rj * rj
            csca = qsca_j * area
            cext = qext_j * area
            csca_sum += wj * csca
            cext_sum += wj * cext
            area_sum += wj * area
            gsum += wj * csca * g_j
            isum += wj * i_j * (lam_um / (2 * np.pi)) ** 2  # |S|^2 has x^2 scale

        ssa[ir] = csca_sum / cext_sum
        asy[ir] = gsum / csca_sum
        qe[ir] = cext_sum / area_sum

        # normalize the averaged intensity to a phase function with
        # integral over mu equal 2 (framework/reference convention)
        p = isum
        norm = -np.trapezoid(p, mu)  # mu decreasing with angle
        pha[:, ir] = 2.0 * p / norm

    return {'ang': angles_deg, 'pha': pha, 'ssa': ssa, 'asy': asy,
            'qe': qe, 'ref': reff_um}

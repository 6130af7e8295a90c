"""Deterministic plane-parallel multi-stream radiance/flux solver (copy of
``er3t_tpu/rtm/oned.py:1-313``, NumPy only, function for function).

Doubling-adding discrete-ordinates solver (Hansen & Travis 1974 style) with
Fourier azimuth modes, delta-M scaling and the Nakajima-Tanaka TMS
single-scatter correction.  This fills the libRadtran/DISORT role of the
reference (the 1D benchmark solver driven through
er3t/rtm/lrt/lrt_rad.py:31-541 of the upstream er3t and used as the radiance
anchor in examples/00_er3t_bmk.py): a deterministic cross-check for the MC
kernels in 1D geometries.

Conventions
-----------
* Layers ordered surface -> TOA (index 0 at the bottom), like the rest of
  the framework; internally the adding proceeds bottom-up.
* ``mu0``/``mu_v`` are positive cosines of the solar/viewing zenith angles;
  ``dphi`` is the relative azimuth between the solar and viewing directions
  (0 = forward scattering half-plane).
* The solar beam carries flux 1 on a surface normal to the beam, so the
  returned TOA radiance is in "reflectance units": multiply by the solar
  spectral irradiance to get W/m2/nm/sr; ``pi * I / mu0`` is the usual
  reflectance factor.

Operator algebra (radiance-vector form, quadrature nodes + zero-weight
"dummy" nodes at mu0 and the view angles):

* ``P = R C`` maps a downward radiance vector to the reflected upward one;
  ``W = T C + E`` is total (diffuse + direct) transmission;
* beam responses are carried as explicit vectors ``rho`` (up), ``theta``
  (down-diffuse) with the beam attenuation scalar ``e = exp(-tau/mu0)``;
* doubling:  M = (I - P^2)^-1 ;  d = M (theta + P rho e);  u = rho e + P d
      P'     = P + W M P W
      W'     = W M W
      rho'   = rho + W u
      theta' = W d + theta e
* adding layer a on top of stack b (only P_b, rho_b needed from below):
      d      = (I - P_a P_b)^-1 (theta_a + P_a rho_b e_a)
      rho_ab = rho_a + W_a (rho_b e_a + P_b d)
      P_ab   = P_a + W_a (I - P_b P_a)^-1 P_b W_a
"""

from __future__ import annotations

import numpy as np

__all__ = ['solve_plane_parallel', 'hg_moments', 'rayleigh_moments']


def hg_moments(g: float, n: int) -> np.ndarray:
    """Legendre moments chi_l = g^l of the Henyey-Greenstein phase function."""
    return np.asarray(g, dtype=np.float64) ** np.arange(n)


def rayleigh_moments(n: int) -> np.ndarray:
    """Legendre moments of the Rayleigh phase function (chi_2 = 0.1)."""
    chi = np.zeros(n)
    chi[0] = 1.0
    if n > 2:
        chi[2] = 0.1
    return chi


def _norm_assoc_legendre(m: int, lmax: int, mu: np.ndarray) -> np.ndarray:
    """lambda_l^m(mu) = sqrt((l-m)!/(l+m)!) P_l^m(mu) for l = 0..lmax.

    Stable upward recurrence in l at fixed m; rows l < m are zero.
    """
    mu = np.asarray(mu, dtype=np.float64)
    lam = np.zeros((lmax + 1, mu.size))
    if m > lmax:
        return lam
    # seed: lambda_m^m = sqrt((2m-1)!!/(2m)!!) (1-mu^2)^(m/2)
    c = 1.0
    for k in range(1, m + 1):
        c *= (2 * k - 1) / (2 * k)
    lam[m] = np.sqrt(c) * (np.maximum(1.0 - mu * mu, 0.0)) ** (m / 2.0)
    if m + 1 <= lmax:
        lam[m + 1] = mu * np.sqrt(2.0 * m + 1.0) * lam[m]
    for l in range(m + 1, lmax):
        a = np.sqrt((l + 1.0) ** 2 - m * m)
        b = np.sqrt(l * l - m * m)
        lam[l + 1] = ((2 * l + 1) * mu * lam[l] - b * lam[l - 1]) / a
    return lam


def _phase_mode(chi, lam_i, lam_j, parity):
    """p^m(+-mu_i, mu_j) = sum_l (2l+1) chi_l lam_l(mu_i) lam_l(mu_j),
    with lam(-mu) = (-1)^(l+m) lam(mu) folded in via ``parity``."""
    lmax = chi.size - 1
    coef = (2 * np.arange(lmax + 1) + 1) * chi
    if parity is not None:
        coef = coef * parity
    return np.einsum('l,li,lj->ij', coef, lam_i, lam_j)


def _thin_layer(dtau, ssa, pm_rr, pm_tt, pm_r0, pm_t0, mu, c, mu0):
    """First-order (single-scatter) operators of an optically thin layer."""
    n = mu.size
    # P(i,j) = dtau ssa p(-i,+j) c_j / (4 mu_i mu_j);  W = T C + E
    P = dtau * ssa * pm_rr * c[None, :] / (4.0 * mu[:, None] * mu[None, :])
    TC = dtau * ssa * pm_tt * c[None, :] / (4.0 * mu[:, None] * mu[None, :])
    E = np.diag(np.exp(-dtau / mu))
    W = TC + E
    rho = dtau * ssa * pm_r0 / (4.0 * np.pi * mu)
    theta = dtau * ssa * pm_t0 / (4.0 * np.pi * mu)
    e = np.exp(-dtau / mu0)
    return P, W, rho, theta, e


def _double(P, W, rho, theta, e, times):
    eye = np.eye(P.shape[0])
    for _ in range(times):
        M = np.linalg.solve(eye - P @ P, eye)
        d = M @ (theta + P @ (rho * e))
        u = rho * e + P @ d
        P, W, rho, theta, e = (
            P + W @ M @ P @ W,
            W @ M @ W,
            rho + W @ u,
            W @ d + theta * e,
            e * e,
        )
    return P, W, rho, theta, e


def _single_scatter_toa(tau, ssa, pfun_exact, mu0, mu_v):
    """Closed-form single-scattered TOA radiance of a layered atmosphere.

    I_1(mu_v) = sum_lay ssa_l p_l(Theta)/(4 pi) * mu0/(mu0+mu_v) *
                exp(-t_above(1/mu0+1/mu_v)) (1 - exp(-dtau_l(1/mu0+1/mu_v)))
    with t_above the optical depth above the layer (beam f0 = 1).
    """
    tau = np.asarray(tau, dtype=np.float64)
    nlay = tau.size
    k = 1.0 / mu0 + 1.0 / mu_v
    # cumulative optical depth above each layer (layers surface->TOA)
    t_above = np.concatenate([np.cumsum(tau[::-1])[::-1][1:], [0.0]])
    out = 0.0
    for il in range(nlay):
        out += (ssa[il] * pfun_exact[il] / (4.0 * np.pi)
                * mu0 / (mu0 + mu_v)
                * np.exp(-t_above[il] * k) * -np.expm1(-tau[il] * k)) / mu_v * mu_v
    return out


def solve_plane_parallel(tau, ssa, moments, mu0, mu_v, dphi,
                         surface_albedo=0.0, n_streams=16, n_modes=None,
                         delta_m=True, tms=True, flux=False):
    """TOA radiance (and optionally boundary fluxes) of a layered atmosphere.

    Parameters
    ----------
    tau, ssa : (Nlay,) layer scattering+absorption optical depth and
        single-scattering albedo, ordered surface -> TOA.
    moments : (Nlay, Nmom) Legendre moments chi_l of each layer's phase
        function (chi_0 = 1); e.g. :func:`hg_moments`, :func:`rayleigh_moments`
        or pre.pmom projections of Mie tables.
    mu0, mu_v : positive cosines of solar / viewing zenith.
    dphi : relative azimuth [rad] (scalar or array).
    surface_albedo : Lambertian surface albedo.
    n_streams : Gauss quadrature nodes per hemisphere.
    n_modes : Fourier azimuth modes (default 2*n_streams, capped by Nmom).
    delta_m / tms : delta-M scaling of forward peaks and the Nakajima-Tanaka
        (1988) single-scatter replacement that makes radiance accurate for
        peaked phase functions at modest stream counts.
    flux : also return (f_up_toa, f_dn_sfc_direct, f_dn_sfc_diffuse, f_up_sfc).

    Returns
    -------
    radiance : TOA upward radiance at (mu_v, dphi) for unit beam flux
        (multiply by the solar irradiance for absolute units), same shape
        as ``dphi``; with ``flux=True`` returns (radiance, flux_dict).
    """
    tau = np.asarray(tau, dtype=np.float64).copy()
    ssa = np.asarray(ssa, dtype=np.float64).copy()
    moments = np.atleast_2d(np.asarray(moments, dtype=np.float64)).copy()
    nlay = tau.size
    if moments.shape[0] == 1 and nlay > 1:
        moments = np.repeat(moments, nlay, axis=0)
    nmom = moments.shape[1]
    # the ns-point Gauss quadrature integrates polynomials to degree 2ns-1,
    # so moments are truncated at ncut = 2 ns (the DISORT NSTR convention) —
    # keeping higher moments aliases and breaks conservation
    ncut = 2 * n_streams
    n_modes = min(n_modes or ncut, ncut, nmom)
    dphi = np.atleast_1d(np.asarray(dphi, dtype=np.float64))

    # exact phase function per layer at the scattering angle (for TMS)
    cos_sca = -mu_v * mu0 + np.sqrt((1 - mu_v ** 2) * (1 - mu0 ** 2)) \
        * np.cos(dphi)                                    # (Nphi,)
    lfac = np.polynomial.legendre.legvander(cos_sca, nmom - 1)  # (Nphi, Nmom)
    p_exact = lfac @ ((2 * np.arange(nmom) + 1) * moments).T    # (Nphi, Nlay)

    # delta-M scaling: f = chi_ncut, truncated moments kept only for l < ncut
    f = np.zeros(nlay)
    tau_s, ssa_s = tau, ssa
    if delta_m and nmom > ncut:
        f = moments[:, ncut].copy()
        mom_s = (moments[:, :ncut] - f[:, None]) / (1.0 - f[:, None])
        sf = 1.0 - ssa * f
        tau_s = tau * sf
        ssa_s = ssa * (1.0 - f) / np.maximum(sf, 1e-12)
    else:
        mom_s = moments[:, :ncut]

    # quadrature nodes + dummy view/solar nodes
    xg, wg = np.polynomial.legendre.leggauss(n_streams)
    mu = 0.5 * (xg + 1.0)
    w = 0.5 * wg
    mu_all = np.concatenate([mu, [mu_v], [mu0]])
    w_all = np.concatenate([w, [0.0], [0.0]])
    c = 2.0 * mu_all * w_all
    iv = n_streams                       # view dummy index
    lmax = mom_s.shape[1] - 1

    rad_modes = np.zeros((n_modes, 1))
    flux_out = None
    for m in range(n_modes):
        lam = _norm_assoc_legendre(m, lmax, mu_all)       # (L+1, N+2)
        parity = (-1.0) ** (np.arange(lmax + 1) + m)

        # Combine all LAYERS first (bottom-up, each new layer on top of the
        # stack), tracking the stack's reflection/transmission operators
        # from BOTH sides, then add the surface last.  Adding the surface
        # first and capturing the interface field at il==0 (the old
        # scheme) freezes the surface diffuse field before any upper layer
        # exists — for a 2-layer Rayleigh atmosphere that lost ~45% of the
        # diffuse-down (energy closure mu0 = up + dir + dif failed).
        #   Rt/Rb: stack reflection for illumination from above/below;
        #   Td/Tu: diffuse transmission down/up; rho/theta: beam responses
        #   (upward at TOA / diffuse downward at stack bottom); e_b: direct
        #   beam transmission.  Individual homogeneous layers are
        #   up-down symmetric (P, W both sides); the stack is not.
        n_all = mu_all.size
        eye = np.eye(n_all)
        Rt = Rb = Td = Tu = None
        rho_b = theta_b = None
        e_b = 1.0
        for il in range(nlay):
            chi = mom_s[il, :lmax + 1]
            pm_tt = _phase_mode(chi, lam, lam, None)      # p(+i, +j)
            pm_rr = _phase_mode(chi, lam, lam, parity)    # p(-i, +j)
            pm_r0 = pm_rr[:, -1]                          # beam column (mu0)
            pm_t0 = pm_tt[:, -1]
            n_dbl = max(0, int(np.ceil(np.log2(max(tau_s[il], 1e-12) / 1e-5))))
            dtau0 = tau_s[il] / (1 << n_dbl)
            P_a, W_a, rho_a, theta_a, e_a = _thin_layer(
                dtau0, ssa_s[il], pm_rr, pm_tt, pm_r0, pm_t0,
                mu_all, c, mu0)
            P_a, W_a, rho_a, theta_a, e_a = _double(
                P_a, W_a, rho_a, theta_a, e_a, n_dbl)
            if Rt is None:
                Rt, Rb, Td, Tu = P_a, P_a, W_a, W_a
                rho_b, theta_b, e_b = rho_a, theta_a, e_a
                continue
            # layer a on top of stack b (beam enters a first)
            M1 = np.linalg.solve(eye - P_a @ Rt, eye)     # a-below vs b-top
            M2 = np.linalg.solve(eye - Rt @ P_a, eye)
            d = M1 @ (theta_a + P_a @ (rho_b * e_a))      # interface, down
            u = rho_b * e_a + Rt @ d                      # interface, up
            rho_b = rho_a + W_a @ u
            theta_b = Td @ d + theta_b * e_a
            Rt, Rb, Td, Tu = (P_a + W_a @ M2 @ Rt @ W_a,
                              Rb + Td @ P_a @ M2 @ Tu,
                              Td @ M1 @ W_a,
                              W_a @ M2 @ Tu)
            e_b = e_b * e_a
        # surface below the whole stack: the interface field here IS the
        # surface field, with every layer present
        if m == 0:
            P_s = surface_albedo * np.tile(c, (n_all, 1))
            # beam response in absolute units (beam amplitude mu0 F0/pi is
            # folded into the rho vectors throughout): alb * mu0 / pi
            rho_s = np.full(n_all, surface_albedo * mu0 / np.pi)
        else:
            P_s = np.zeros((n_all, n_all))
            rho_s = np.zeros(n_all)
        d_sfc = np.linalg.solve(eye - Rb @ P_s,
                                theta_b + Rb @ (rho_s * e_b))
        u_sfc = rho_s * e_b + P_s @ d_sfc
        rho_tot = rho_b + Tu @ u_sfc
        rad_modes[m, 0] = rho_tot[iv]
        if m == 0 and flux:
            nq = n_streams
            f_up_toa = 2 * np.pi * np.sum(w * mu * rho_tot[:nq])
            f_dn_dir = mu0 * e_b
            f_dn_dif = 2 * np.pi * np.sum(w * mu * d_sfc[:nq])
            f_up_sfc = surface_albedo * (f_dn_dir + f_dn_dif)
            flux_out = {'f_up_toa': f_up_toa, 'f_dn_sfc_direct': f_dn_dir,
                        'f_dn_sfc_diffuse': f_dn_dif, 'f_up_sfc': f_up_sfc}

    fac = np.where(np.arange(n_modes) == 0, 1.0, 2.0)
    rad = np.sum(fac[:, None] * rad_modes
                 * np.cos(np.arange(n_modes)[:, None] * dphi[None, :]),
                 axis=0)

    if tms and delta_m and np.any(f > 0):
        # Nakajima-Tanaka TMS: replace the truncated single-scatter estimate
        # with the exact one computed from the FULL phase function scaled by
        # 1/(1-ssa f) (correct single-scatter under the scaled optical depth)
        lcut = mom_s.shape[1]
        p_trunc = lfac[:, :lcut] @ ((2 * np.arange(lcut) + 1) * mom_s).T
        i1_t = np.array([_single_scatter_toa(tau_s, ssa_s, p_trunc[k], mu0, mu_v)
                         for k in range(dphi.size)])
        p_full_scaled = p_exact / (1.0 - f[None, :])
        i1_e = np.array([_single_scatter_toa(tau_s, ssa_s, p_full_scaled[k],
                                             mu0, mu_v)
                         for k in range(dphi.size)])
        rad = rad - i1_t + i1_e

    rad = rad if rad.size > 1 else float(rad[0])
    if flux:
        return rad, flux_out
    return rad

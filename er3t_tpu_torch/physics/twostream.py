"""Two-stream closed forms and a delta-Eddington multi-layer adding solver
(NumPy copy of ``er3t_tpu/physics/twostream.py:12-173``: ``r_twostream``,
``t_twostream``, ``delta_eddington_flux`` and their helpers).
"""

from __future__ import annotations

import numpy as np

__all__ = ['r_twostream', 't_twostream', 'delta_eddington_flux']


def r_twostream(tau, a=0.0, g=0.85, mu=1.0):
    """Conservative two-stream reflectance."""
    x = 2.0 * mu / (1.0 - g) / (1.0 - a)
    return (tau + a * x) / (tau + x)


def t_twostream(tau, a=0.0, g=0.85, mu=1.0):
    """Conservative two-stream transmittance."""
    x = 2.0 * mu / (1.0 - g) / (1.0 - a)
    return x * (1.0 - a) / (tau + x)


def _layer_de(tau, omega, g, mu0):
    """Delta-Eddington single-layer R/T for diffuse + direct beam.

    Returns (Rdir, Tdir_diffuse, Tdir_direct, Rdif, Tdif) for one homogeneous
    layer: reflectance / diffuse transmittance for direct-beam incidence,
    direct-beam transmittance, and diffuse-incidence reflectance/transmittance
    (Joseph, Wiscombe & Weinman 1976; Coakley & Chylek two-stream
    hemispheric-mean closure for the diffuse quantities).
    """
    # delta scaling
    f = g * g
    tau_s = (1.0 - omega * f) * tau
    omega_s = omega * (1.0 - f) / (1.0 - omega * f)
    g_s = (g - f) / (1.0 - f)

    # Eddington coefficients
    omega_s = np.clip(omega_s, 0.0, 1.0 - 1e-9)
    gamma1 = 0.25 * (7.0 - omega_s * (4.0 + 3.0 * g_s))
    gamma2 = -0.25 * (1.0 - omega_s * (4.0 - 3.0 * g_s))
    gamma2 = np.maximum(gamma2, 1e-12)
    gamma3 = 0.25 * (2.0 - 3.0 * g_s * mu0)
    gamma4 = 1.0 - gamma3

    k = np.sqrt(np.maximum((gamma1 - gamma2) * (gamma1 + gamma2), 1e-24))
    ktau = np.minimum(k * tau_s, 50.0)
    ek, emk = np.exp(ktau), np.exp(-ktau)

    # diffuse incidence
    denom_dif = k + gamma1 + (k - gamma1) * emk * emk
    Rdif = gamma2 * (1.0 - emk * emk) / denom_dif
    Tdif = 2.0 * k * emk / denom_dif

    # direct incidence (Meador & Weaver 1980 source-function solution)
    mu0 = np.maximum(mu0, 1e-6)
    Tdir_direct = np.exp(-np.minimum(tau_s / mu0, 50.0))
    Rdir, Tdir_dif = _meador_weaver_direct(tau_s, omega_s, gamma1, gamma2, gamma3, gamma4, k, mu0, Tdir_direct)
    return Rdir, Tdir_dif, Tdir_direct, Rdif, Tdif


def _meador_weaver_direct(tau, omega, g1, g2, g3, g4, k, mu0, Tdd):
    """Meador & Weaver (1980) / Toon et al. (1989) direct-beam R and diffuse T.

    Normalized by exp(+k*tau) for numerical stability: with E = exp(-k*tau)
    and Ed = exp(-tau/mu0),

        D' = (1 - k^2 mu0^2) [(k + g1) + (k - g1) E^2]
        R  = (w/D') [(1-k mu0)(a2+k g3) - (1+k mu0)(a2-k g3) E^2
                     - 2k (g3 - a2 mu0) E Ed]
        Td = (w/D') [2k (g4 + a1 mu0) E - (1+k mu0)(a1+k g4) Ed
                     + (1-k mu0)(a1-k g4) E^2 Ed]
    """
    ktau = np.minimum(k * tau, 50.0)
    E = np.exp(-ktau)
    a1 = g1 * g4 + g2 * g3
    a2 = g1 * g3 + g2 * g4
    denom = (1.0 - (k * mu0) ** 2) * (k + g1 + (k - g1) * E * E)
    denom = np.where(np.abs(denom) < 1e-12, np.sign(denom + 1e-30) * 1e-12, denom)

    R = (omega / denom) * (
        (1.0 - k * mu0) * (a2 + k * g3)
        - (1.0 + k * mu0) * (a2 - k * g3) * E * E
        - 2.0 * k * (g3 - a2 * mu0) * E * Tdd)
    T = (omega / denom) * (
        2.0 * k * (g4 + a1 * mu0) * E
        - (1.0 + k * mu0) * (a1 + k * g4) * Tdd
        + (1.0 - k * mu0) * (a1 - k * g4) * E * E * Tdd)
    return np.clip(R, 0.0, 1.0), np.clip(T, 0.0, None)


def delta_eddington_flux(tau, omega, g, mu0, albedo=0.0):
    """Multi-layer delta-Eddington fluxes by the adding method.

    Parameters
    ----------
    tau, omega, g : (Nz,) per-layer optical depth, single-scattering albedo,
        asymmetry parameter, ordered surface -> TOA (index 0 at the surface).
    mu0 : cosine of solar zenith angle.
    albedo : Lambertian surface albedo.

    Returns dict with (Nz+1,) level arrays 'f_down_direct', 'f_down_diffuse',
    'f_down', 'f_up', normalized to unit TOA *horizontal* solar flux
    (i.e. incident direct flux on a horizontal surface = mu0).

    Implementation: classic doubling/adding sweep. We first combine the
    surface with layer 0, then successively add layers upward, tracking the
    combined reflectance for direct and diffuse illumination from above; a
    second downward sweep recovers level fluxes.
    """
    tau = np.asarray(tau, dtype=np.float64)
    omega = np.clip(np.asarray(omega, dtype=np.float64), 0.0, 1.0 - 1e-9)
    g = np.asarray(g, dtype=np.float64)
    nz = tau.size

    Rdir = np.empty(nz)
    Tdir = np.empty(nz)   # diffuse transmittance under direct illumination
    Tdd = np.empty(nz)    # direct-beam transmittance
    Rdif = np.empty(nz)
    Tdif = np.empty(nz)
    for i in range(nz):
        Rdir[i], Tdir[i], Tdd[i], Rdif[i], Tdif[i] = _layer_de(tau[i], omega[i], g[i], mu0)

    # upward adding: A[k] = (surface + layers 0..k-1) seen from level k
    # A_rdir[k]: reflected diffuse per unit direct flux incident at level k
    # A_rdif[k]: reflected diffuse per unit diffuse flux incident at level k
    A_rdir = np.empty(nz + 1)
    A_rdif = np.empty(nz + 1)
    A_rdir[0] = albedo
    A_rdif[0] = albedo
    for k in range(nz):
        ra, rda = A_rdir[k], A_rdif[k]
        d = 1.0 / (1.0 - Rdif[k] * rda)
        # direct beam incident on top of layer k: transmitted direct Tdd hits
        # the lower stack as direct; transmitted diffuse Tdir hits as diffuse
        A_rdir[k + 1] = Rdir[k] + Tdif[k] * d * (Tdd[k] * ra + Tdir[k] * rda)
        A_rdif[k + 1] = Rdif[k] + Tdif[k] * d * Tdif[k] * rda

    # downward sweep from TOA: unit direct flux (on horizontal) at TOA
    f_dir = np.empty(nz + 1)   # direct down at levels (TOA index nz)
    f_dn = np.empty(nz + 1)    # diffuse down
    f_up = np.empty(nz + 1)
    f_dir[nz] = mu0
    f_dn[nz] = 0.0
    f_up[nz] = A_rdir[nz] * mu0
    for k in range(nz - 1, -1, -1):
        # illumination on top of layer k: direct f_dir[k+1], diffuse f_dn[k+1]
        ra, rda = A_rdir[k], A_rdif[k]
        d = 1.0 / (1.0 - Rdif[k] * rda)
        dir_in = f_dir[k + 1]
        dif_in = f_dn[k + 1]
        f_dir[k] = Tdd[k] * dir_in
        # downward diffuse below layer k (before interreflection), then add
        # multiple reflections between layer k bottom and the lower stack
        dn0 = Tdir[k] * dir_in + Tdif[k] * dif_in
        up_below = d * (f_dir[k] * ra + dn0 * rda)  # upward diffuse at level k
        f_dn[k] = dn0 + Rdif[k] * up_below
        f_up[k] = up_below

    return {
        'f_down_direct': f_dir,
        'f_down_diffuse': f_dn,
        'f_down': f_dir + f_dn,
        'f_up': f_up,
    }

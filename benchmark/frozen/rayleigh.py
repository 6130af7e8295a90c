"""Frozen copy of ``er3t_tpu_torch/physics/rayleigh.py (whole, at bdb0f8e)``, kept for the benchmark's inputs and its
plain reference; do not edit.

Rayleigh scattering: Bodhaine (1999) optical depth and gravity, the
phase function and its analytic scattering-cosine sampler (NumPy copy of ``er3t_tpu/physics/rayleigh.py``:
``gravity_surface`` :19-22, ``gravity_at_alt`` :25-32, ``bodhaine_factor``
:35-45, ``rayleigh_od`` :48-75, ``rayleigh_phase`` :78-80,
``sample_rayleigh_mu`` :83-99 without its ``jax.numpy`` dispatch).
"""

from __future__ import annotations

import numpy as np

from . import constants as c

__all__ = ['gravity_surface', 'gravity_at_alt', 'bodhaine_factor',
           'rayleigh_od', 'rayleigh_phase', 'sample_rayleigh_mu']


def gravity_surface(lat_deg):
    """Surface gravity [m/s^2] vs latitude (Bodhaine et al. 1999, eq. 11)."""
    phi = np.deg2rad(lat_deg)
    return 9.806160 * (1.0 - 0.0026373 * np.cos(2 * phi) + 0.0000059 * np.cos(2 * phi) ** 2)


def gravity_at_alt(g0, lat_deg, z_m):
    """Gravity [m/s^2] at altitude z [m] (Bodhaine et al. 1999, eq. 10)."""
    phi = np.deg2rad(lat_deg)
    g_cgs = (g0 * 100.0
             - (3.085462e-4 + 2.27e-7 * np.cos(2 * phi)) * z_m
             + (7.254e-11 + 1.0e-13 * np.cos(2 * phi)) * z_m ** 2
             - (1.517e-17 + 6.0e-20 * np.cos(2 * phi)) * z_m ** 3)
    return g_cgs / 100.0


def bodhaine_factor(wvl_um):
    """Wavelength-dependent factor of the Bodhaine Rayleigh parameterization.

    num/den polynomial of Bodhaine et al. (1999), eq. 30 region: the per-unit
    column scattering efficiency (dimensionless once multiplied by the column
    factor below).
    """
    w2 = wvl_um * wvl_um
    num = 1.0455996 - 341.29061 / w2 - 0.90230850 * w2
    den = 1.0 + 0.0027059889 / w2 - 85.968563 * w2
    return num / den


def rayleigh_od(wvl_nm, p_lev_hpa, lat_deg=45.0, co2_vmr=330.0e-6):
    """Per-layer Rayleigh optical depth for a level pressure grid.

    Parameters
    ----------
    wvl_nm : wavelength in nm (scalar or array)
    p_lev_hpa : (Nz+1,) level pressures, surface first (decreasing upward)
    lat_deg : latitude for the gravity correction
    co2_vmr : CO2 volume mixing ratio (mean molecular weight correction)

    Returns (Nz,) optical depth per layer.

    The column constant uses sigma = F(lambda) * N_A * dp / (g * m_air), the
    exact Bodhaine column formulation; evaluated with surface gravity, which
    for a whole-column calculation matches the reference implementation
    (er3t/util/util.py:1075-1092, the `const_sfc` branch it actually returns).
    """
    wvl_um = np.asarray(wvl_nm, dtype=np.float64) * 1e-3
    p = np.asarray(p_lev_hpa, dtype=np.float64)
    dp = p[:-1] - p[1:]  # hPa, positive for surface-first ordering

    g0 = gravity_surface(lat_deg) * 100.0  # cm/s^2
    ma = 28.9595 + 15.0556 * co2_vmr       # g/mol with CO2 correction

    # dp[hPa] -> dyn/cm^2 is *1000; sigma(lambda) carries the 1e-28 cm^2 scale
    # and the classical 0.00210966/1013.25 normalization reproduces it:
    const = dp * 1000.0 * c.N_A / (g0 * ma) * 1e-28
    return const * bodhaine_factor(wvl_um)


def rayleigh_phase(mu):
    """Rayleigh phase function P(mu), normalized to integrate to 2 over mu."""
    return 0.75 * (1.0 + mu * mu)


def sample_rayleigh_mu(u):
    """Inverse-CDF sampling of the Rayleigh scattering cosine: with
    v = 2u - 1 and q = 2v + sqrt(4v^2 + 1), mu = q^(1/3) - q^(-1/3)."""
    v = 2.0 * u - 1.0
    q = 2.0 * v + np.sqrt(4.0 * v * v + 1.0)
    qc = np.cbrt(q)
    return qc - 1.0 / qc

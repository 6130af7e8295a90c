"""Frozen copy of ``er3t_tpu_torch/pre/abs.py:27-193`` (``G16_WEIGHTS``, ``AbsCoef``,
the gray cross-sections and ``abs_synthetic``, the fallback of ``abs_16g``
where the 16-g database is absent), kept for the benchmark's inputs and its plain
reference; do not edit.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .solar import solar_irradiance

__all__ = ['AbsCoef', 'abs_synthetic', 'G16_WEIGHTS']


# (abs_crk.py:695-701; the standard RRTMG-style quadrature)
G16_WEIGHTS = np.array([
    0.1527534276, 0.1491729617, 0.1420961469, 0.1316886544,
    0.1181945205, 0.1019300893, 0.0832767040, 0.0626720116,
    0.0424925000, 0.0046269894, 0.0038279891, 0.0030260086,
    0.0022199750, 0.0014140010, 0.0005330000, 0.000075], dtype=np.float64)


@dataclasses.dataclass
class AbsCoef:
    """Correlated-k coefficients on a layer grid."""
    wvl: float                 # nm
    abso_coef: np.ndarray      # (Nz, Ng) absorption optical depth per layer
    slit_func: np.ndarray      # (Nz, Ng)
    solar: np.ndarray          # (Ng,) W/m^2/nm
    weight: np.ndarray         # (Ng,)
    synthetic: bool = False

    @property
    def ng(self) -> int:
        return self.weight.size


# ----------------------------------------------------------------------------
# published gray cross-sections
# ----------------------------------------------------------------------------

# O3 Huggins + Chappuis absorption cross-section [cm^2], smoothed band means
# (shape per Molina & Molina 1986 / Bogumil et al. 2003)
_O3_WVL = np.array([300, 305, 310, 315, 320, 325, 330, 340, 350, 360, 370,
                    400, 420, 440, 460, 480, 500, 520, 540, 550, 560, 575,
                    590, 602, 610, 625, 640, 650, 675, 700, 725, 750, 800,
                    850, 900, 1000, 2500], dtype=np.float64)
_O3_XS = np.array([3.9e-19, 1.8e-19, 9.0e-20, 4.5e-20, 2.2e-20, 1.0e-20,
                   5.0e-21, 1.0e-21, 3.0e-22, 8.0e-23, 3.0e-23, 1.5e-23,
                   2.5e-23, 1.0e-22, 2.5e-22, 6.0e-22, 1.36e-21, 2.1e-21,
                   2.9e-21, 3.30e-21, 3.8e-21, 4.6e-21, 4.9e-21, 5.23e-21,
                   5.1e-21, 4.7e-21, 3.3e-21, 2.6e-21, 1.6e-21, 9.0e-22,
                   5.5e-22, 3.5e-22, 1.4e-22, 6.0e-23, 2.5e-23, 5.0e-24,
                   1.0e-25], dtype=np.float64)

# NO2 visible cross-section [cm^2] (Burrows et al. 1998 scale)
_NO2_WVL = np.array([300, 350, 400, 430, 450, 480, 500, 550, 600, 700, 2500],
                    dtype=np.float64)
_NO2_XS = np.array([1.0e-19, 2.5e-19, 5.5e-19, 6.5e-19, 6.0e-19, 5.0e-19,
                    3.5e-19, 1.5e-19, 5.0e-20, 5.0e-21, 1.0e-22], dtype=np.float64)

# band-mean vertical optical depth of the U.S.-standard column, used to back
# out band-mean cross-sections: sigma = OD / column.  Coarse anchors from
# standard atmospheric-transmittance spectra.
_H2O_COLUMN = 4.0e22   # molecules/cm^2 (U.S. standard, ~1.2 cm PW)
_H2O_WVL = np.array([400, 500, 550, 590, 610, 650, 690, 700, 720, 750, 790,
                     820, 870, 906, 940, 980, 1020, 1130, 1240, 1380, 1500,
                     1600, 1750, 1870, 2005, 2100, 2300, 2500], dtype=np.float64)
_H2O_OD = np.array([1e-4, 5e-4, 1e-3, 1.0e-2, 5e-3, 6e-3, 2e-2, 3e-2, 1.0e-1,
                    1e-2, 5e-3, 8e-2, 1e-2, 4e-1, 2.0, 3e-1, 2e-2, 2.5, 5e-2,
                    30.0, 3e-1, 5e-2, 3e-1, 30.0, 2.0, 1.0, 5e-1, 3.0],
                   dtype=np.float64)

_O2_COLUMN = 4.5e24
_O2_WVL = np.array([400, 600, 630, 660, 687, 700, 755, 760, 765, 772, 800,
                    1230, 1270, 1310, 2500], dtype=np.float64)
_O2_OD = np.array([1e-5, 1e-4, 5e-2, 1e-3, 1.0, 1e-3, 1e-2, 5.0, 5.0, 1e-2,
                   1e-4, 1e-2, 3e-1, 1e-2, 1e-4], dtype=np.float64)

_CO2_COLUMN = 7.1e21
_CO2_WVL = np.array([400, 1190, 1240, 1280, 1370, 1440, 1500, 1540, 1600,
                     1660, 1900, 2005, 2060, 2150, 2300, 2500], dtype=np.float64)
_CO2_OD = np.array([1e-6, 1e-4, 5e-2, 1e-3, 1e-3, 3e-1, 1e-2, 5e-1, 2.0,
                    1e-2, 1e-2, 10.0, 20.0, 1e-1, 1e-2, 1e-1], dtype=np.float64)

_CH4_COLUMN = 3.7e19
_CH4_WVL = np.array([400, 1600, 1660, 1730, 1800, 2150, 2200, 2300, 2370,
                     2500], dtype=np.float64)
_CH4_OD = np.array([1e-7, 1e-2, 3e-1, 2e-1, 1e-3, 1e-1, 1.0, 1.5, 1.0, 3e-1],
                   dtype=np.float64)

# lognormal g-spread (log-std of k across the g axis) per absorber; line gases
# have strong spectral structure, continua are gray
_G_SPREAD = {'h2o': 2.6, 'o2': 3.2, 'co2': 2.6, 'ch4': 2.2}


def _probit(p):
    """Rational approximation of the standard normal quantile (Acklam)."""
    p = np.asarray(p, dtype=np.float64)
    a = [-3.969683028665376e+01, 2.209460984245205e+02, -2.759285104469687e+02,
         1.383577518672690e+02, -3.066479806614716e+01, 2.506628277459239e+00]
    b = [-5.447609879822406e+01, 1.615858368580409e+02, -1.556989798598866e+02,
         6.680131188771972e+01, -1.328068155288572e+01]
    c = [-7.784894002430293e-03, -3.223964580411365e-01, -2.400758277161838e+00,
         -2.549732539343734e+00, 4.374664141464968e+00, 2.938163982698783e+00]
    d = [7.784695709041462e-03, 3.224671290700398e-01, 2.445134137142996e+00,
         3.754408661907416e+00]
    plow, phigh = 0.02425, 1 - 0.02425
    x = np.empty_like(p)
    lo = p < plow
    hi = p > phigh
    mid = ~(lo | hi)
    if lo.any():
        q = np.sqrt(-2 * np.log(p[lo]))
        x[lo] = (((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q + c[5]) / \
                ((((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1)
    if hi.any():
        q = np.sqrt(-2 * np.log(1 - p[hi]))
        x[hi] = -(((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q + c[5]) / \
                ((((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1)
    if mid.any():
        q = p[mid] - 0.5
        r = q * q
        x[mid] = (((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4]) * r + a[5]) * q / \
                 (((((b[0] * r + b[1]) * r + b[2]) * r + b[3]) * r + b[4]) * r + 1)
    return x


def _g_shape(weight: np.ndarray, spread: float) -> np.ndarray:
    """Lognormal k-distribution shape psi_g with sum(w*psi)=1.

    g-points are ordered weak -> strong absorption like the reference
    database (largest quadrature weight first = most transparent).
    """
    gcum = np.concatenate([[0.0], np.cumsum(weight)])
    gmid = np.clip(0.5 * (gcum[:-1] + gcum[1:]), 1e-6, 1 - 1e-6)
    psi = np.exp(spread * _probit(gmid))
    return psi / np.sum(weight * psi)


def _band_sigma(wvl, wvl_tab, od_tab, column):
    od = np.exp(np.interp(wvl, wvl_tab, np.log(od_tab)))
    return od / column


def abs_synthetic(wavelength: float, atm, ng: int = 16) -> AbsCoef:
    """Synthetic correlated-k coefficients for any wavelength in 300-2500 nm.

    Per-layer absorption optical depth = sum over gases of
    sigma_band(lambda) * psi_g * n_gas(z) * dz * p-scaling, with the gray O3
    and NO2 cross sections applied identically to every g-point.
    """
    if wavelength < 300.0 or wavelength > 2500.0:
        raise ValueError('abs_synthetic supports 300-2500 nm')

    weight = G16_WEIGHTS if ng == 16 else np.full(ng, 1.0 / ng)
    nz = atm.lay.altitude.size
    dz_cm = atm.lay.thickness * 1.0e5
    k = np.zeros((nz, ng), dtype=np.float64)

    # gray absorbers: same optical depth in every g
    for gas, wtab, xtab in (('o3', _O3_WVL, _O3_XS), ('no2', _NO2_WVL, _NO2_XS)):
        sigma = np.interp(wavelength, wtab, xtab)
        k += (sigma * atm.lay.gas(gas) * dz_cm)[:, None]

    # line absorbers: lognormal g-distribution, pressure-broadening scaling
    p_scale = (atm.lay.pressure / 1013.25) ** 0.6
    for gas, wtab, odtab, column in (
            ('h2o', _H2O_WVL, _H2O_OD, _H2O_COLUMN),
            ('o2', _O2_WVL, _O2_OD, _O2_COLUMN),
            ('co2', _CO2_WVL, _CO2_OD, _CO2_COLUMN),
            ('ch4', _CH4_WVL, _CH4_OD, _CH4_COLUMN)):
        sigma = _band_sigma(wavelength, wtab, odtab, column)
        psi = _g_shape(weight, _G_SPREAD[gas])
        col = atm.lay.gas(gas) * dz_cm * p_scale
        k += sigma * col[:, None] * psi[None, :]

    solar = np.full(ng, solar_irradiance(wavelength))
    slit = np.ones((nz, ng))
    return AbsCoef(wvl=float(wavelength), abso_coef=k, slit_func=slit,
                   solar=solar, weight=weight.copy(), synthetic=True)

"""Parameterized water-cloud bulk optics against wavelength and effective
radius (NumPy copy of ``er3t_tpu/physics/cloud_optics.py:15-84``:
``water_cloud_optics`` and its table).

Given a 550 nm cloud optical thickness and an effective radius, it gives
the extinction scaling, single-scattering albedo and asymmetry parameter
at any solar wavelength by log-bilinear interpolation of a 10 wavelength x
3 radius table of gamma-averaged Mie properties (the role of libRadtran's
``wc_properties hu``).
"""

from __future__ import annotations

import numpy as np

__all__ = ['water_cloud_optics']

_WVL = np.array([350., 550., 860., 1040., 1240., 1450., 1650., 1940.,
                 2130., 2500.])
_REFF = np.array([5., 10., 20.])

# extinction efficiency Qe (gamma-averaged) from mie_gamma_dist
_QE = np.array([
    [2.1100, 2.0185, 2.0586],
    [2.2642, 2.1016, 2.0527],
    [2.2366, 2.1211, 2.0783],
    [2.2129, 2.2386, 2.1180],
    [2.2495, 2.1453, 2.0948],
    [2.2624, 2.1496, 2.1117],
    [2.3224, 2.1700, 2.1200],
    [2.3783, 2.2190, 2.1681],
    [2.3766, 2.2230, 2.1130],
    [2.6200, 2.2706, 2.1677]])

_SSA = np.array([
    [1.00000, 1.00000, 1.00000],
    [1.00000, 1.00000, 1.00000],
    [0.99996, 0.99996, 0.99991],
    [0.99976, 0.99954, 0.99908],
    [0.99825, 0.99631, 0.99356],
    [0.99511, 0.99036, 0.98012],
    [0.99663, 0.99314, 0.98760],
    [0.97634, 0.95517, 0.91888],
    [0.98472, 0.97028, 0.94403],
    [0.96137, 0.91590, 0.85335]])

_ASY = np.array([
    [0.8546, 0.8672, 0.8750],
    [0.8466, 0.8518, 0.8752],
    [0.8221, 0.8581, 0.8684],
    [0.8353, 0.8490, 0.8735],
    [0.8245, 0.8489, 0.8682],
    [0.8272, 0.8540, 0.8673],
    [0.7989, 0.8481, 0.8653],
    [0.7937, 0.8506, 0.8804],
    [0.7898, 0.8473, 0.8722],
    [0.8374, 0.8518, 0.8979]])


def _interp2(tab, wvl, reff):
    iw = np.clip(np.searchsorted(_WVL, wvl) - 1, 0, _WVL.size - 2)
    ir = np.clip(np.searchsorted(_REFF, reff) - 1, 0, _REFF.size - 2)
    fw = np.clip((wvl - _WVL[iw]) / (_WVL[iw + 1] - _WVL[iw]), 0.0, 1.0)
    fr = np.clip((np.log(reff) - np.log(_REFF[ir]))
                 / (np.log(_REFF[ir + 1]) - np.log(_REFF[ir])), 0.0, 1.0)
    c00, c01 = tab[iw, ir], tab[iw, ir + 1]
    c10, c11 = tab[iw + 1, ir], tab[iw + 1, ir + 1]
    return (1 - fw) * ((1 - fr) * c00 + fr * c01) \
        + fw * ((1 - fr) * c10 + fr * c11)


def water_cloud_optics(wvl_nm: float, reff_um: float = 10.0):
    """(ext_scale, ssa, asy) of a water cloud at ``wvl_nm``.

    ``ext_scale`` converts a 550 nm optical thickness to this wavelength
    (Qe(wvl)/Qe(550) at the same reff — the droplet geometry is fixed).
    """
    qe = _interp2(_QE, wvl_nm, reff_um)
    qe550 = _interp2(_QE, 550.0, reff_um)
    return float(qe / qe550), float(_interp2(_SSA, wvl_nm, reff_um)), \
        float(_interp2(_ASY, wvl_nm, reff_um))

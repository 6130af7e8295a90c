"""Absorption-database utilities (NumPy copy of
``er3t_tpu/pre/abs_gen.py:23-206``: ``cal_xsec_o3_molina``,
``cal_xsec_o4_greenblatt``, ``cal_xsec_no2_burrows``, ``cal_solar_kurudz``,
``_sigma_g`` and ``gen_abs_16g_h5``).

:func:`gen_abs_16g_h5` writes a database in the ``abs_16g.h5`` layout from
the synthetic spectroscopy of :mod:`er3t_tpu_torch.pre.abs` on the real
database grid, which :func:`~er3t_tpu_torch.pre.abs_16g_db.abs_16g_from_h5`
reads back through its full interpolation; ``h5py`` is imported inside it.
Each cross-section function reads a reference-format ``.dat`` table when
given one and falls back to the embedded band means otherwise.
"""

from __future__ import annotations

import numpy as np

from ..physics.solar import solar_irradiance
from .abs import (_G_SPREAD, _NO2_WVL, _NO2_XS, _O3_WVL, _O3_XS,
                  _band_sigma, _g_shape, G16_WEIGHTS,
                  _H2O_WVL, _H2O_OD, _H2O_COLUMN,
                  _O2_WVL, _O2_OD, _O2_COLUMN,
                  _CO2_WVL, _CO2_OD, _CO2_COLUMN,
                  _CH4_WVL, _CH4_OD, _CH4_COLUMN)
from .abs_16g_db import _regions, reference_atmosphere

__all__ = ['cal_xsec_o3_molina', 'cal_xsec_o4_greenblatt',
           'cal_xsec_no2_burrows', 'cal_solar_kurudz', 'gen_abs_16g_h5']


# O4 (O2-O2 collision complex) band cross-sections [cm^5/molec^2-ish scale
# folded to cm^2 per O2 at standard density]: visible band peaks near
# 477/532/577/630 nm (Greenblatt et al. 1990 shape)
_O4_WVL = np.array([400, 446, 477, 500, 532, 550, 577, 600, 630, 660, 700,
                    1140], dtype=np.float64)
_O4_XS = np.array([1e-25, 5e-24, 6.3e-23, 2e-24, 1.0e-23, 2e-24, 5.0e-23,
                   3e-24, 1.1e-23, 1e-24, 2e-25, 1e-26], dtype=np.float64)


def _maybe_load(fname):
    if fname:
        import os
        if os.path.exists(fname):
            return np.loadtxt(fname)
    return None


def cal_xsec_o3_molina(wvl0, t, t_ref=273.13, fname=None):
    """O3 cross-section [cm^2] with quadratic temperature dependence.

    Reference role: ``cal_xsec_o3_molina`` (util.py:48-66) reading the
    Molina & Molina (1986) coefficient table ``crs_o3_mol_cf.dat``
    (columns: wvl, c0, c1, c2; sigma = 1e-20 (c0 + c1 dT + c2 dT^2)).
    Without the table, the embedded Huggins/Chappuis band means are used
    (temperature-independent — the Chappuis band is nearly so).
    """
    t = np.asarray(t, dtype=np.float64)
    data = _maybe_load(fname)
    if data is not None:
        c0 = np.interp(wvl0, data[:, 0], data[:, 1])
        c1 = np.interp(wvl0, data[:, 0], data[:, 2])
        c2 = np.interp(wvl0, data[:, 0], data[:, 3])
        return 1e-20 * (c0 + c1 * (t - t_ref) + c2 * (t - t_ref) ** 2)
    sigma = np.exp(np.interp(wvl0, _O3_WVL, np.log(_O3_XS)))
    return np.broadcast_to(sigma, t.shape).copy() if t.ndim else sigma


def cal_xsec_o4_greenblatt(wvl0, fname=None):
    """O4 (O2 collision pair) cross-section (Greenblatt et al. 1990 role,
    util.py:70-82); reference table format: (wvl, 1e20 sigma)."""
    data = _maybe_load(fname)
    if data is not None:
        return 1e-20 * np.interp(wvl0, data[:, 0], data[:, 1])
    return np.exp(np.interp(wvl0, _O4_WVL, np.log(_O4_XS)))


def cal_xsec_no2_burrows(wvl0, fname=None):
    """NO2 cross-section [cm^2] (Burrows et al. 1998 GOME role,
    util.py:86-98); reference table format: (wvl, sigma)."""
    data = _maybe_load(fname)
    if data is not None:
        return np.interp(wvl0, data[:, 0], data[:, 1])
    return np.exp(np.interp(wvl0, _NO2_WVL, np.log(_NO2_XS)))


def cal_solar_kurudz(wvl0, slit_func=None, kurudz_file=None):
    """Kurucz solar irradiance [W/m^2/nm] at ``wvl0``, optionally
    slit-convolved (util.py:102-118); falls back to the framework's
    composite solar spectrum."""
    data = _maybe_load(kurudz_file)
    if data is not None:
        w, s = data[:, 0], data[:, 1] / 1000.0
        if slit_func is not None:
            wvls = wvl0 + np.asarray(slit_func['wavelength'])
            return np.average(np.interp(wvls, w, s),
                              weights=np.asarray(slit_func['weight']))
        return np.interp(wvl0, w, s)
    return solar_irradiance(wvl0)


# ---------------------------------------------------------------------------
# database generator
# ---------------------------------------------------------------------------

_GAS_TABLES = {
    'h2o': (_H2O_WVL, _H2O_OD, _H2O_COLUMN),
    'o2': (_O2_WVL, _O2_OD, _O2_COLUMN),
    'co2': (_CO2_WVL, _CO2_OD, _CO2_COLUMN),
    'ch4': (_CH4_WVL, _CH4_OD, _CH4_COLUMN),
}


def _sigma_g(gas, wvl, p_hpa, t_k, ng=16):
    """Per-g cross-section [cm^2] of ``gas`` at one (p, T) grid point.

    Same physical model as ``abs_synthetic`` (band-mean sigma, lognormal
    g-spread, (p/p0)^0.6 pressure broadening) evaluated at the DATABASE grid
    point instead of the profile layer — the loader's trilinear
    interpolation then reconstructs profile values.
    """
    weight = G16_WEIGHTS if ng == 16 else np.full(ng, 1.0 / ng)
    if gas == 'o3':
        return np.full(ng, cal_xsec_o3_molina(wvl, t_k))
    if gas == 'no2':
        return np.full(ng, cal_xsec_no2_burrows(wvl))
    wtab, odtab, column = _GAS_TABLES[gas]
    sigma = _band_sigma(wvl, wtab, odtab, column)
    psi = _g_shape(weight, _G_SPREAD[gas])
    return sigma * psi * (p_hpa / 1013.25) ** 0.6


def gen_abs_16g_h5(fname, wavelengths, compression='gzip'):
    """Generate an ``abs_16g.h5``-layout correlated-k database.

    Writes, for every wavelength, the k-tables of the absorber groups the
    reader's region map selects (``abs_16g_db._regions``) on the full
    database grid — 59 log-pressure levels x 5 temperature offsets
    (x 10 water-vapor points for the continuum gases) — plus the solar
    band groups.  Layout and units follow the reference database exactly
    (k in units of 1e20 cm^2 so that k x column[1e-20 #/cm^2] = optical
    depth; abs_crk.py:482-628), so :func:`abs_16g_from_h5` reads the
    result with zero special-casing.
    """
    import h5py

    pref, pref_log, tref, vref, vref_log = reference_atmosphere()
    ng = 16
    written = set()
    with h5py.File(fname, 'w') as f:
        for wvl in wavelengths:
            wvl_i = int(np.round(wvl))
            for gas_grp, kname, gas, sol_grp, use_vtp, _slit, _sol \
                    in _regions(float(wvl)):
                for jp in range(59):
                    for jt in range(5):
                        t_k = tref[jp] + 15.0 * (jt - 2)
                        sig = _sigma_g(gas, float(wvl), pref[jp], t_k, ng)
                        k = sig / 1e-20          # database units
                        tab = np.zeros((ng, 4))
                        tab[:, 0] = np.arange(1, ng + 1)
                        tab[:, 1] = G16_WEIGHTS
                        tab[:, 2] = k
                        tab[:, 3] = 1.0          # slit weights
                        if use_vtp:
                            for jw in range(10):
                                path = (f'/{gas_grp}/pressure.{jp + 1}/'
                                        f'temperature.{jt + 1}/wv.{jw + 1}/'
                                        f'{kname}.{wvl_i}')
                                if path not in written:
                                    f.create_dataset(path, data=tab,
                                                     compression=compression)
                                    written.add(path)
                        else:
                            path = (f'/{gas_grp}/pressure.{jp + 1}/'
                                    f'temperature.{jt + 1}/{kname}.{wvl_i}')
                            if path not in written:
                                f.create_dataset(path, data=tab,
                                                 compression=compression)
                                written.add(path)
                spath = f'{sol_grp}/solar_taug.{wvl_i}'
                if spath not in written:
                    # band [wvl - 0.5, wvl + 0.5] nm in wavenumbers; s0 such
                    # that the loader's s0 (v2 - v1)/(l2 - l1) recovers the
                    # Kurucz/composite irradiance per nm
                    l1, l2 = wvl_i - 0.5, wvl_i + 0.5
                    v1, v2 = 1.0e7 / l2, 1.0e7 / l1
                    s0 = cal_solar_kurudz(float(wvl)) * (l2 - l1) / (v2 - v1)
                    data = np.zeros((ng, 2))
                    data[:, 0] = np.arange(1, ng + 1)
                    data[:, 1] = s0
                    f.create_dataset(f'{spath}/params',
                                     data=np.array([v1, v2, (v2 - v1) / ng,
                                                    ng, s0, s0, s0]))
                    f.create_dataset(f'{spath}/data', data=data,
                                     compression=compression)
                    written.add(spath)
    return fname

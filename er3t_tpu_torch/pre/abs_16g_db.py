"""Loader of the 16-g correlated-k database (NumPy copy of
``er3t_tpu/pre/abs_16g_db.py:21-269``: ``reference_atmosphere``,
``interpolation_factors``, ``_regions``, ``_accumulate``,
``abs_16g_from_h5`` and ``abs_16g_from_txt``).

Gas columns are rescaled to the database's units, each layer is located in
the 59-level reference atmosphere (pressure, temperature and water-vapour
indices and weights), the absorbers are chosen by wavelength region, and
the k-tables gathered at ``/{gas}/pressure.{j}/temperature.{j}[/wv.{j}]/
{kg}.{wvl}`` are accumulated with their weights (reference abs_crk.py:
187-628).  ``h5py`` is imported inside :func:`abs_16g_from_h5`; the text
layout needs none.
"""

from __future__ import annotations

import numpy as np

__all__ = ['abs_16g_from_h5', 'abs_16g_from_txt', 'reference_atmosphere']

NG = 16


def reference_atmosphere():
    """59-level MLS reference atmosphere of the database grid.

    The database tabulates k at fixed log-pressure grid points (spacing 0.2
    in ln(p/hPa) from 6.96 down), five temperature offsets (+-30 K in 15 K
    steps around the level temperature), and a 10-point log-spaced
    water-vapor mixing-ratio grid — the grid the reference hardcodes at
    abs_crk.py:631-690.
    """
    pref_log = 6.96 - 0.2 * np.arange(59)
    pref = np.exp(pref_log)
    # level temperatures of the MLS reference profile (K), reconstructed on
    # the same grid (reference values to ~0.1 K)
    tref = np.array([
        294.2, 288.0, 278.9, 269.3, 259.8, 250.2, 240.8, 231.8, 223.1, 215.8,
        215.7, 215.7, 215.7, 217.1, 218.6, 220.2, 221.7, 223.3, 224.8, 226.6,
        228.3, 231.1, 234.0, 237.0, 240.2, 243.7, 247.3, 250.9, 254.6, 258.3,
        262.2, 266.1, 270.0, 273.4, 275.4, 275.7, 273.7, 271.6, 269.6, 265.9,
        262.1, 258.3, 253.6, 248.5, 243.5, 238.1, 232.1, 226.0, 220.0, 214.4,
        208.9, 203.4, 197.9, 192.9, 188.1, 183.3, 178.5, 173.9, 172.1])
    vref_log = -12.2061 + np.arange(10)
    return pref, pref_log, tref, np.exp(vref_log), vref_log


def interpolation_factors(p_lay_hpa, t_lay, h2o_mix):
    """Indices + trilinear weights of each layer on the database grid."""
    pref, pref_log, tref, vref, vref_log = reference_atmosphere()

    p_log = np.log(p_lay_hpa)
    jpd = np.clip((35.0 - 5.0 * (p_log + 0.04)).astype(np.int64), 0, 57)
    jpu = jpd + 1

    div = pref_log[jpd] - pref_log[jpu]
    fpu = np.where(div > 1e-3, (pref_log[jpd] - p_log) / np.where(div > 1e-3, div, 1.0), 0.0)
    fpu = np.clip(fpu, 0.0, 1.0)
    fpd = 1.0 - fpu

    jtd = np.clip((2.0 + (t_lay - tref[jpd]) / 15.0).astype(np.int64), 0, 3)
    jtu = np.clip((2.0 + (t_lay - tref[jpu]) / 15.0).astype(np.int64), 0, 3)
    ftd = (t_lay - tref[jpd]) / 15.0 - (jtd - 2.0)
    ftu = (t_lay - tref[jpu]) / 15.0 - (jtu - 2.0)

    v_log = np.clip(np.log(np.maximum(h2o_mix, 1e-30)), vref_log[0], vref_log[-1])
    jwd = np.clip((12.2 + v_log).astype(np.int64), 0, 8)
    jwu = jwd + 1
    fvd = v_log - vref_log[jwd]

    nz = p_log.size
    fac_tp = np.zeros((nz, 2, 2))
    fac_tp[:, 0, 0] = (1 - ftd) * fpd
    fac_tp[:, 1, 0] = ftd * fpd
    fac_tp[:, 0, 1] = (1 - ftu) * fpu
    fac_tp[:, 1, 1] = ftu * fpu

    fac_vtp = np.zeros((nz, 2, 2, 2))
    fac_vtp[:, 0, 0, 0] = fvd * (1 - ftd) * fpd
    fac_vtp[:, 1, 0, 0] = (1 - fvd) * (1 - ftd) * fpd
    fac_vtp[:, 0, 1, 0] = fvd * ftd * fpd
    fac_vtp[:, 1, 1, 0] = (1 - fvd) * ftd * fpd
    fac_vtp[:, 0, 0, 1] = fvd * (1 - ftu) * fpu
    fac_vtp[:, 1, 0, 1] = (1 - fvd) * (1 - ftu) * fpu
    fac_vtp[:, 0, 1, 1] = fvd * ftu * fpu
    fac_vtp[:, 1, 1, 1] = (1 - fvd) * ftu * fpu

    return {'jpd': jpd, 'jpu': jpu, 'jtd': jtd, 'jtu': jtu,
            'jwd': jwd, 'jwu': jwu, 'fac_tp': fac_tp, 'fac_vtp': fac_vtp}


# wavelength-region -> [(absorber group, k-name, gas, solar group, use_vtp,
#                        carries_slit, carries_solar)]
def _regions(wvl, group_s='/solar_v1.3'):
    uv, k, o2, nir = (f'{group_s}/solar_uv', f'{group_s}/solar_k',
                      f'{group_s}/solar_o2', f'{group_s}/solar_nir')
    W = wvl
    if W < 300:
        raise ValueError('abs_16g: wavelength below 300 nm')
    if W < 448:
        return [('O3', 'kgo3', 'o3', uv, False, True, True)]
    if W < 500:
        return [('H2O', 'kgh2o', 'h2o', uv, False, False, True),
                ('O3', 'kgo3', 'o3', uv, False, True, False)]
    if W < 620:
        return [('H2O', 'kgh2o', 'h2o', k, False, True, True),
                ('O3', 'kgo3', 'o3', k, False, False, False)]
    if (620 <= W < 640) or (680 <= W < 700) or (750 <= W < 760) or (770 <= W < 780):
        return [('O2_cont5', 'kgo2', 'o2', o2, True, True, True),
                ('O3', 'kgo3', 'o3', o2, False, False, False)]
    if (640 <= W < 680) or (700 <= W < 750):
        return [('H2O', 'kgh2o', 'h2o', k, False, True, True),
                ('O3', 'kgo3', 'o3', k, False, False, False),
                ('O2_cont5', 'kgo2', 'o2', k, False, False, False)]
    if 760 <= W < 770:
        return [('H2O', 'kgh2o', 'h2o', o2, False, False, True),
                ('O3', 'kgo3', 'o3', o2, False, False, False),
                ('O2_cont5', 'kgo2', 'o2', o2, False, True, False)]
    if W < 980:
        return [('H2O', 'kgh2o', 'h2o', k, False, True, True)]
    if (980 <= W < 1240) or (1630 <= W < 1940):
        return [('H2O/k_arraynir', 'kgh2o', 'h2o', nir, False, True, True)]
    if 1240 <= W < 1300:
        return [('O2_cont5/k_arraynir', 'kgo2', 'o2', nir, True, True, True),
                ('CO2', 'kgco2', 'co2', nir, False, False, False)]
    if (1300 <= W < 1420) or (1450 <= W < 1560):
        return [('H2O/k_arraynir', 'kgh2o', 'h2o', nir, False, True, True),
                ('CO2', 'kgco2', 'co2', nir, False, False, False)]
    if (1420 <= W < 1450) or (1560 <= W < 1630) or (1940 <= W < 2150):
        return [('CO2', 'kgco2', 'co2', nir, True, True, True)]
    if W <= 2500:
        return [('CH4', 'kgch4', 'ch4', nir, True, True, True)]
    raise ValueError('abs_16g: wavelength above 2500 nm')


def _accumulate(wavelength, atm, fetch_k, fetch_solar):
    """Shared per-gas / per-layer k-table accumulation (abs_crk.py:482-628).

    ``fetch_k(gas_grp, kname, jp, jt, jw_or_None, wvl_i)`` returns the
    (Ng, cols) table (col 2 = k, col -1 = slit); ``fetch_solar(sol_grp,
    wvl_i)`` returns (v1, v2, s0).  Database backends (HDF5 tree, legacy
    text tree) differ only in these two callables.
    """
    from .abs import AbsCoef, G16_WEIGHTS

    nz = atm.lay.altitude.size
    # gas columns in database units (#/cm^2 * 1e-20; abs_crk.py:187-199)
    col_factor = 1.0e-20 * 1.0e5 * atm.lay.thickness
    gas_col = {g: atm.lay.gas(g) * col_factor
               for g in ('o3', 'o2', 'h2o', 'co2', 'ch4', 'no2')}
    h2o_mix = atm.lay.h2o / atm.lay.factor
    fac = interpolation_factors(atm.lay.pressure, atm.lay.temperature, h2o_mix)

    wvl_i = int(np.round(wavelength))
    abso = np.zeros((nz, NG))
    slit = np.zeros((nz, NG))
    solar = np.zeros(NG)

    for gas_grp, kname, gas, sol_grp, use_vtp, has_slit, has_solar in \
            _regions(wavelength):
        if has_solar:
            v1, v2, s0 = fetch_solar(sol_grp, wvl_i)
            l1, l2 = 1.0e7 / v2, 1.0e7 / v1
            solar = s0 * (v2 - v1) / (l2 - l1)

        contrib = np.zeros((nz, NG))
        for iz in range(nz):
            if use_vtp:
                w8 = fac['fac_vtp'][iz]
                acc = np.zeros(NG)
                sl = None
                for a_w, jw in ((0, fac['jwd'][iz]), (1, fac['jwu'][iz])):
                    for a_t, jt in ((0, fac['jtd'][iz]), (1, fac['jtu'][iz])):
                        for a_p, jp in ((0, fac['jpd'][iz]), (1, fac['jpu'][iz])):
                            # index convention per reference: fac_vTp
                            # first axis pairs (fvd with jwd-column)
                            d = fetch_k(gas_grp, kname, jp, jt, jw, wvl_i)
                            if sl is None:
                                sl = d[:, -1]
                            acc += w8[a_w, a_t, a_p] * d[:, 2]
                contrib[iz] = gas_col[gas][iz] * acc
                if has_slit:
                    slit[iz] = sl
            else:
                w4 = fac['fac_tp'][iz]
                acc = np.zeros(NG)
                sl = None
                for a_t, jt in ((0, fac['jtd'][iz]), (1, fac['jtu'][iz])):
                    for a_p, jp in ((0, fac['jpd'][iz]), (1, fac['jpu'][iz])):
                        d = fetch_k(gas_grp, kname, jp, jt, None, wvl_i)
                        if sl is None:
                            sl = d[:, -1]
                        acc += w4[a_t, a_p] * d[:, 2]
                contrib[iz] = gas_col[gas][iz] * acc
                if has_slit:
                    slit[iz] = sl
        abso += contrib

    return AbsCoef(wvl=float(wavelength), abso_coef=abso, slit_func=slit,
                   solar=solar, weight=G16_WEIGHTS.copy(), synthetic=False)


def abs_16g_from_h5(wavelength, atm, fname_h5):
    """Correlated-k coefficients from the HDF5 database for one wavelength."""
    import h5py

    with h5py.File(fname_h5, 'r') as f:
        def fetch_k(gas_grp, kname, jp, jt, jw, wvl_i):
            wv = f'wv.{jw + 1}/' if jw is not None else ''
            path = (f'/{gas_grp}/pressure.{jp + 1}/temperature.{jt + 1}/'
                    f'{wv}{kname}.{wvl_i}')
            return f[path][...]

        def fetch_solar(sol_grp, wvl_i):
            sgrp = f'{sol_grp}/solar_taug.{wvl_i}'
            if sgrp not in f:
                raise KeyError(f'abs_16g database lacks {sgrp}')
            v1, v2, dv, npts, smn, smx, sint = f[f'{sgrp}/params'][...]
            return v1, v2, f[f'{sgrp}/data'][...][:, -1]

        return _accumulate(wavelength, atm, fetch_k, fetch_solar)


def abs_16g_from_txt(wavelength, atm, fdir_k=None, fdir_s=None):
    """Correlated-k coefficients from the legacy lab-server TEXT database
    (reference abs_16g_txt, abs_crk.py:710-1378): a directory tree
    ``{fdir_k}/{GAS}/pressure.{jp}/temperature.{jt}[/wv.{jw}]/{kg}.{wvl}``
    of ``np.loadtxt``-able (Ng, cols) tables, with solar files
    ``{fdir_s}/solar_*/solar_taug.{wvl}`` (1-2 header lines of band params
    then Ng rows whose last column is the solar weight).
    """
    import os

    fdir_k = fdir_k or os.environ.get('ER3T_ABS16G_TXT_DIR', '')
    fdir_s = fdir_s or os.environ.get('ER3T_ABS16G_TXT_SOLAR_DIR',
                                      os.path.join(fdir_k, 'solar_v1.3'))
    if not fdir_k or not os.path.isdir(fdir_k):
        raise FileNotFoundError(
            'abs_16g_txt: set ER3T_ABS16G_TXT_DIR to the legacy text '
            f'database root (got {fdir_k!r})')

    def fetch_k(gas_grp, kname, jp, jt, jw, wvl_i):
        gas_dir = gas_grp.split('/')[0]   # text tree has no k_arraynir level
        wv = f'wv.{jw + 1}/' if jw is not None else ''
        path = (f'{fdir_k}/{gas_dir}/pressure.{jp + 1}/'
                f'temperature.{jt + 1}/{wv}{kname}.{wvl_i}')
        return np.loadtxt(path, ndmin=2)

    def fetch_solar(sol_grp, wvl_i):
        sub = sol_grp.rsplit('/', 1)[-1]  # solar_uv | solar_k | ...
        path = f'{fdir_s}/{sub}/solar_taug.{wvl_i}'
        # two header layouts in the wild (abs_crk.py:1167-1176)
        with open(path) as fh:
            first = np.fromstring(fh.readline(), sep=' ', dtype=np.float64)
            if first.size == 6:
                skip = 2
            else:
                skip = 1
        v1, v2 = first[0], first[1]
        s0 = np.genfromtxt(path, skip_header=skip, ndmin=2)[:, -1]
        return v1, v2, s0

    return _accumulate(wavelength, atm, fetch_k, fetch_solar)

"""REPTRAN representative-wavelength absorption from the libRadtran database
(NumPy copy of ``er3t_tpu/pre/abs_rep_db.py:20-148``: ``_interp_xsec`` and
``abs_rep_from_cdf``).

Bands are chosen by wavelength or channel name from
``reptran_{solar,thermal}_{fine,medium,coarse}.cdf``; the band's
representative wavelengths and weights take the role of g-points, and the
cross-sections are interpolated from the per-gas lookup files
``reptran_*.lookup.{GAS}.cdf`` over (T-perturbation, [vmr,] p).
"""

from __future__ import annotations

import os

import numpy as np

from ..util.ncio import open_any

__all__ = ['abs_rep_from_cdf']


def _interp_xsec(lookup_fname, wvl0, p_pa, t_k, h2o_vmr=None):
    """Cross-section [1e-20 m^2] per layer from one species lookup file."""
    f = open_any(lookup_fname)
    try:
        xsec = np.squeeze(f.var('xsec')[0])
        t_ref = np.asarray(f.var('t_ref')[0])
        dt_ref = np.asarray(f.var('t_pert')[0])
        wvl_ref = np.asarray(f.var('wvl')[0])
        p_ref = np.asarray(f.var('pressure')[0])
        try:
            vmr_ref = np.asarray(f.var('vmrs')[0])
        except Exception:
            vmr_ref = None
    finally:
        f.close()

    order = np.argsort(p_ref)
    p_s = p_ref[order]
    dt = t_k - np.interp(p_pa, p_s, t_ref[order])
    iw = int(np.abs(wvl_ref - wvl0).argmin())

    def lin_idx(grid, vals):
        i = np.clip(np.searchsorted(grid, vals) - 1, 0, grid.size - 2)
        f = np.clip((vals - grid[i]) / np.maximum(grid[i + 1] - grid[i], 1e-30), 0, 1)
        return i, f

    ip, fp = lin_idx(p_s, p_pa)
    it, ft = lin_idx(dt_ref, np.clip(dt, dt_ref[0], dt_ref[-1]))

    if xsec.ndim == 4 and vmr_ref is not None:   # H2O: (t_pert, vmr, wvl, p)
        tab = xsec[:, :, iw, :][:, :, order]
        iv, fv = lin_idx(vmr_ref, np.clip(h2o_vmr, vmr_ref[0], vmr_ref[-1]))
        out = np.zeros_like(p_pa)
        for at, wt in ((0, 1 - ft), (1, ft)):
            for av, wv in ((0, 1 - fv), (1, fv)):
                for ap, wp in ((0, 1 - fp), (1, fp)):
                    out += wt * wv * wp * tab[it + at, iv + av, ip + ap]
        return out
    tab = xsec[:, iw, :][:, order]               # others: (t_pert, wvl, p)
    out = np.zeros_like(p_pa)
    for at, wt in ((0, 1 - ft), (1, ft)):
        for ap, wp in ((0, 1 - fp), (1, fp)):
            out += wt * wp * tab[it + at, ip + ap]
    return out


def abs_rep_from_cdf(wavelength_or_channel, atm, fname_cdf, band='solar',
                     resolution='coarse'):
    """Build an AbsCoef from a REPTRAN main file (+ sibling lookups)."""
    from .abs import AbsCoef, _NO2_WVL, _NO2_XS, _O3_WVL, _O3_XS

    f = open_any(fname_cdf)
    try:
        band_bytes = np.asarray(f.var('band_name')[0])
        bands = [b.tobytes().decode('utf-8', 'ignore').strip().replace('\x00', '')
                 for b in band_bytes]
        wvl_min = np.asarray(f.var('wvlmin')[0])
        wvl_max = np.asarray(f.var('wvlmax')[0])
        if isinstance(wavelength_or_channel, str):
            if wavelength_or_channel not in bands:
                raise KeyError(f'unknown REPTRAN band {wavelength_or_channel!r}; '
                               f'available: {bands[:20]}...')
            ib = bands.index(wavelength_or_channel)
        else:
            hits = np.where((wavelength_or_channel >= wvl_min) &
                            (wavelength_or_channel < wvl_max))[0]
            if hits.size == 0:
                raise ValueError('wavelength outside REPTRAN range')
            ib = int(hits[0])

        iwvl = np.asarray(f.var('iwvl')[0])[:, ib]
        wgt = np.asarray(f.var('iwvl_weight')[0])[:, ib]
        sel = wgt > 0
        idx = iwvl[sel] - 1
        wgt = wgt[sel]
        wvls = np.asarray(f.var('wvl')[0])[idx]
        sol = np.asarray(f.var('extra')[0])[idx] / 1000.0   # -> W/m^2/nm
        xs_src = np.asarray(f.var('cross_section_source')[0])[idx, :]
        gas_bytes = np.asarray(f.var('species_name')[0])
        gases = [g.tobytes().decode('utf-8', 'ignore').strip().replace('\x00', '')
                 for g in gas_bytes]
        active = [gases[i] for i in np.where(xs_src.sum(axis=0) > 0)[0]]
    finally:
        f.close()

    nz = atm.lay.altitude.size
    ng = wgt.size
    abso = np.zeros((nz, ng))
    p_pa = atm.lay.pressure * 100.0
    dz_cm = atm.lay.thickness * 1.0e5
    h2o_vmr = atm.lay.h2o / atm.lay.factor

    fdir = os.path.dirname(fname_cdf)
    stem = os.path.basename(fname_cdf).rsplit('.', 1)[0]

    for i, w0 in enumerate(wvls):
        # continuum gray absorbers from the bundled cross sections
        if 300.0 <= w0 <= 1000.0:
            abso[:, i] += np.interp(w0, _O3_WVL, _O3_XS) * atm.lay.o3 * dz_cm
            abso[:, i] += np.interp(w0, _NO2_WVL, _NO2_XS) * atm.lay.no2 * dz_cm
        # line absorbers from REPTRAN lookups
        for gas in active:
            gl = gas.lower()
            if not hasattr(atm.lay, gl):
                continue
            lk = os.path.join(fdir, f'{stem}.lookup.{gas}.cdf')
            if not os.path.exists(lk):
                continue
            xs = _interp_xsec(lk, w0, p_pa, atm.lay.temperature,
                              h2o_vmr=h2o_vmr)
            # xsec units 1e-20 m^2 -> cm^2 is 1e-16; column per layer:
            # n [cm^-3] * dz [km] * 1e5 -> total factor 1e-11 on km basis
            abso[:, i] += np.clip(xs, 0, None) * atm.lay.gas(gl) * 1e-11 \
                * atm.lay.thickness

    return AbsCoef(wvl=float(np.mean(wvls)), abso_coef=abso,
                   slit_func=np.ones((nz, ng)), solar=sol,
                   weight=np.asarray(wgt, dtype=np.float64), synthetic=False)

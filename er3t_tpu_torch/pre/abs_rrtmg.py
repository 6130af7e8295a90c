"""RRTMG-SW band k-distribution loader (NumPy copy of
``er3t_tpu/pre/abs_rrtmg.py:25-236``: ``abs_rrtmg_sw`` and
``RRTMG_SW_WEIGHTS``).

Against the ``rrtmg_sw.nc`` layout: band selection by index, g-points per
``NumGPoints``, key-species absorption interpolated over (pressure,
temperature deviation from MLS, binary species parameter eta), minor gases
over (temperature, eta), the H2O self and foreign continua, and the solar
source per g.  A band gives as many g-points as the file says (4 or so),
not 16.
"""

from __future__ import annotations

import numpy as np

from ..util.ncio import open_any

__all__ = ['abs_rrtmg_sw', 'RRTMG_SW_WEIGHTS']

# fixed quadrature weights (reference abs_crk.py:1941-1953) — the same
# 16-value RRTMG-style quadrature as the 16-g database; single source of
# truth in pre/abs.py
from .abs import G16_WEIGHTS

RRTMG_SW_WEIGHTS = G16_WEIGHTS / G16_WEIGHTS.sum()


def _names(arr):
    """Decode a (N, Nchar) byte/char matrix into lowercase stripped names."""
    out = []
    for row in np.asarray(arr):
        chars = []
        for c in np.ravel(row):
            if isinstance(c, bytes):
                chars.append(c.decode('utf-8', 'ignore'))
            else:
                chars.append(str(c))
        out.append(''.join(chars).strip().lower().replace('\x00', ''))
    return out


def _lin(grid, val):
    """(index, fraction) for linear interpolation on a sorted 1D grid."""
    grid = np.asarray(grid, dtype=np.float64)
    i = np.clip(np.searchsorted(grid, val) - 1, 0, grid.size - 2)
    f = (val - grid[i]) / np.maximum(grid[i + 1] - grid[i], 1e-30)
    return i, np.clip(f, 0.0, 1.0)


class abs_rrtmg_sw:
    """RRTMG-SW per-band absorption for an atmosphere profile.

    Produces the framework's abs contract: ``coef`` dict plus
    wvl/ng/abso_coef/slit_func/solar/weight attributes consumable by
    ``build_scene`` (same shape as ``abs_16g``).
    """

    def __init__(self, iband=0, atm_obj=None, fname=None, g_mode=0,
                 verbose=False):
        if atm_obj is None:
            raise ValueError('atm_obj is required')
        if g_mode != 0:
            raise ValueError('only g_mode=0 supported (reference parity)')
        if fname is None:
            import os
            fname = os.environ.get('ER3T_RRTMG_SW_NC', '')
        self.iband = int(iband)
        self._load(fname, atm_obj, verbose)

    def _load(self, fname, atm, verbose):
        f = open_any(fname)
        try:
            def v(name):
                return np.asarray(f.var(name)[0])

            ib = self.iband
            wn_lo = v('BandWavenumberLowerLimit')[ib]
            wn_hi = v('BandWavenumberUpperLimit')[ib]
            self.wavelength = 2.0e7 / (wn_lo + wn_hi)
            self.band_range = (1.0e7 / wn_hi, 1.0e7 / wn_lo)
            self.wvl = float(self.wavelength)

            ng = int(v('NumGPoints')[0, ib])
            gases = _names(v('AbsorberNames'))
            key_low = [g for g in _names(v('KeySpeciesNamesLowerAtmos')[:, ib, :]) if g]
            key_upp = [g for g in _names(v('KeySpeciesNamesUpperAtmos')[:, ib, :]) if g]

            k_key_low = v('KeySpeciesAbsorptionCoefficientsLowerAtmos')[0, ib, :ng]
            k_key_upp = v('KeySpeciesAbsorptionCoefficientsUpperAtmos')[0, ib, :ng]
            k_min_low = v('AbsorptionCoefficientsLowerAtmos')[0, ib, :, :ng]
            k_min_upp = v('AbsorptionCoefficientsUpperAtmos')[0, ib, :, :ng]
            k_h2o_self = v('H2OSelfAbsorptionCoefficients')[0, ib, :ng]
            k_h2o_fore_low = v('H2OForeignAbsorptionCoefficientsLowerAtmos')[0, ib, :ng]
            try:
                k_h2o_fore_upp = v('H2OForeignAbsorptionCoefficientsUpperAtmos')[0, ib, :ng]
            except Exception:
                k_h2o_fore_upp = None
            try:   # foreign-continuum temperature axis
                t_fore = np.asarray(v('TemperatureH2OForeign'), dtype=np.float64)
            except Exception:
                t_fore = None

            p_low = np.asarray(v('PressureLowerAtmos'), dtype=np.float64)
            p_upp = np.asarray(v('PressureUpperAtmos'), dtype=np.float64)
            t_ref = np.asarray(v('Temperature'), dtype=np.float64)
            dt_mls = np.asarray(v('TemperatureDiffFromMLS'), dtype=np.float64)
            t_self = np.asarray(v('TemperatureH2OSelf'), dtype=np.float64)
            sol = v('SolarSourceFunctionLowerAtmos')[0, ib, 0, :ng]
            try:   # MLS reference profile for the dT axis (59 levels)
                p_ref59 = np.asarray(v('Pressure'), dtype=np.float64)
                t_ref59 = np.asarray(v('ReferenceTemperature'), dtype=np.float64)
            except Exception:
                p_ref59 = t_ref59 = None
        finally:
            f.close()

        # grids may be stored top-down; interpolate on sorted copies
        def sort_grid(p, k, axis):
            order = np.argsort(p)
            return p[order], np.take(k, order, axis=axis)

        p_low_s, k_key_low = sort_grid(p_low, k_key_low, 1)
        p_upp_s, k_key_upp = sort_grid(p_upp, k_key_upp, 1)
        p_split = p_low_s[0] if p_upp_s[-1] <= p_low_s[0] else p_upp_s[-1]

        nz = atm.lay.pressure.size
        p_lay = np.asarray(atm.lay.pressure, dtype=np.float64)   # hPa
        t_lay = np.asarray(atm.lay.temperature, dtype=np.float64)
        dz_cm = np.asarray(atm.lay.thickness, dtype=np.float64) * 1.0e5

        def col(gas):
            arr = getattr(atm.lay, gas, None)
            if arr is None:
                return np.zeros(nz)
            return np.asarray(arr, dtype=np.float64) * dz_cm     # molec/cm^2

        # MLS reference temperature at layer pressure for the dT axis
        if p_ref59 is not None:
            order = np.argsort(p_ref59)
            t_mls = np.interp(p_lay, p_ref59[order], t_ref59[order])
        else:
            xp = np.linspace(np.log(0.01), np.log(1050.0), t_ref.size)
            t_mls = np.interp(np.log(p_lay), xp, t_ref[::-1])
        dt_lay = np.clip(t_lay - t_mls, dt_mls[0], dt_mls[-1])

        abso = np.zeros((nz, ng))
        for iz in range(nz):
            lower = p_lay[iz] >= p_split
            keys = key_low if lower else key_upp
            n1 = col(keys[0])[iz] if len(keys) > 0 else 0.0
            n2 = col(keys[1])[iz] if len(keys) > 1 else 0.0
            eta = n1 / (n1 + n2) if (n1 + n2) > 0 else 1.0

            k_key = k_key_low if lower else k_key_upp
            p_grid = p_low_s if lower else p_upp_s
            n_eta = k_key.shape[-1]
            ip, fp = _lin(p_grid, p_lay[iz])
            it, ft = _lin(dt_mls, dt_lay[iz])
            eta_grid = np.linspace(0.0, 1.0, n_eta)
            ie, fe = _lin(eta_grid, eta)

            kk = 0.0
            for (i_, w_p) in ((ip, 1 - fp), (ip + 1, fp)):
                for (j_, w_t) in ((it, 1 - ft), (it + 1, ft)):
                    for (l_, w_e) in ((ie, 1 - fe), (ie + 1, fe)):
                        kk = kk + w_p * w_t * w_e * k_key[:, i_, j_, l_]
            abso[iz] += kk * (n1 + n2)

            # minor gases at this band: bilinear over (T, eta)
            itt, ftt = _lin(t_ref, t_lay[iz])
            k_min = k_min_low if lower else k_min_upp
            for igas, gname in enumerate(gases):
                if gname in keys or not gname:
                    continue
                ncol = col(gname)[iz]
                if ncol <= 0.0:
                    continue
                km = ((1 - ftt) * ((1 - fe) * k_min[igas, :, itt, ie]
                                   + fe * k_min[igas, :, itt, ie + 1])
                      + ftt * ((1 - fe) * k_min[igas, :, itt + 1, ie]
                               + fe * k_min[igas, :, itt + 1, ie + 1]))
                abso[iz] += np.clip(km, 0.0, None) * ncol

            # H2O continuum: self term (lower atmosphere only) over its own
            # T axis; foreign term interpolated over the foreign T axis with
            # the upper-atmosphere foreign table applied above p_split
            n_h2o = col('h2o')[iz]
            if n_h2o > 0:
                its, fts = _lin(t_self, t_lay[iz])
                ks = (1 - fts) * k_h2o_self[:, its] + fts * k_h2o_self[:, its + 1]
                abso[iz] += np.clip(ks, 0.0, None) * n_h2o * (1.0 if lower else 0.0)
                use_low = lower or k_h2o_fore_upp is None
                kf_tab = k_h2o_fore_low if use_low else k_h2o_fore_upp
                ncol_f = kf_tab.shape[1]
                if t_fore is not None and ncol_f > 1 and t_fore.size >= ncol_f:
                    # lower table spans the first foreign temperatures, the
                    # upper table the last ones (RRTMG_SW table layout)
                    t_ax = t_fore[:ncol_f] if use_low else t_fore[-ncol_f:]
                    ifo, ffo = _lin(t_ax, t_lay[iz])
                    kf = (1 - ffo) * kf_tab[:, ifo] + ffo * kf_tab[:, ifo + 1]
                else:
                    kf = kf_tab[:, 0]
                abso[iz] += np.clip(kf, 0.0, None) * n_h2o

        weight = RRTMG_SW_WEIGHTS[:ng].copy()
        weight /= weight.sum()
        self.abso_coef = np.clip(abso, 0.0, None)
        self.slit_func = np.ones((nz, ng))
        self.solar = np.asarray(sol, dtype=np.float64)
        self.weight = weight
        self.coef = {
            'wavelength': {'name': 'Wavelength (nm)', 'data': self.wavelength},
            'abso_coef': {'name': 'Absorption Coefficient (Nz, Ng)',
                          'data': self.abso_coef},
            'slit_func': {'name': 'Slit Function (Nz, Ng)',
                          'data': self.slit_func},
            'solar': {'name': 'Solar Factor (Ng)', 'data': self.solar},
            'weight': {'name': 'Weight (Ng)', 'data': self.weight},
        }

    @property
    def ng(self) -> int:
        return self.weight.size

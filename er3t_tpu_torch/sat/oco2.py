"""OCO-2 readers (HDF5).

A copy of ``er3t_tpu/sat/oco2.py`` (:1-130), function for function; its
relative imports resolve to the port's own ``util`` and ``sat`` modules.

Capability parity with er3t/util/oco2.py: L1B nadir radiance
(``oco2_rad_nadir``), L2 standard XCO2 product (``oco2_std``), meteorology
(``oco2_met``), and the photon-count unit conversion.
"""

from __future__ import annotations

import numpy as np

from ..util.ncio import open_any

__all__ = ['oco2_rad_nadir', 'oco2_std', 'oco2_met', 'photon_to_radiance']

_H = 6.62607015e-34
_C = 2.99792458e8


def photon_to_radiance(photon_rad, wvl_nm):
    """Ph/s/m^2/sr/um -> W/m^2/nm/sr (reference: er3t/util/oco2.py:17)."""
    e_photon = _H * _C / (wvl_nm * 1e-9)
    return photon_rad * e_photon * 1e-3


def _entry(data, name, units='N/A'):
    return {'data': data, 'name': name, 'units': units}


class oco2_rad_nadir:
    """OCO-2 L1bSc O2 A-band nadir radiance."""

    ID = 'OCO2 L1B'

    def __init__(self, fnames, extent=None):
        lons, lats, rads = [], [], []
        wvl = None
        for fname in np.atleast_1d(fnames):
            f = open_any(fname)
            try:
                lon, _ = f.var('SoundingGeometry/sounding_longitude')
                lat, _ = f.var('SoundingGeometry/sounding_latitude')
                rad, _ = f.var('SoundingMeasurements/radiance_o2')
                if wvl is None:
                    try:
                        disp, _ = f.var('InstrumentHeader/dispersion_coef_samp')
                        idx = np.arange(1, rad.shape[-1] + 1, dtype=np.float64)
                        coef = np.asarray(disp)[0, 0]
                        wvl = sum(c * idx ** i for i, c in enumerate(coef)) * 1000.0
                    except Exception:
                        wvl = np.linspace(757.0, 772.0, rad.shape[-1])
                sel = np.ones(lon.shape, bool)
                if extent is not None:
                    sel = ((lon >= extent[0]) & (lon <= extent[1]) &
                           (lat >= extent[2]) & (lat <= extent[3]))
                lons.append(lon[sel]); lats.append(lat[sel])
                rads.append(np.asarray(rad)[sel])
            finally:
                f.close()
        self.data = {
            'lon': _entry(np.concatenate(lons), 'Longitude', 'deg'),
            'lat': _entry(np.concatenate(lats), 'Latitude', 'deg'),
            'rad': _entry(np.concatenate(rads), 'O2 A-band radiance',
                          'ph/s/m^2/sr/um'),
            'wvl': _entry(wvl, 'Wavelength grid', 'nm'),
        }


class oco2_std:
    """OCO-2 L2 standard product (XCO2)."""

    ID = 'OCO2 L2 Std'

    def __init__(self, fnames, extent=None):
        lons, lats, xco2s = [], [], []
        for fname in np.atleast_1d(fnames):
            f = open_any(fname)
            try:
                lon, _ = f.var('RetrievalGeometry/retrieval_longitude')
                lat, _ = f.var('RetrievalGeometry/retrieval_latitude')
                xco2, _ = f.var('RetrievalResults/xco2')
                sel = np.ones(lon.shape, bool)
                if extent is not None:
                    sel = ((lon >= extent[0]) & (lon <= extent[1]) &
                           (lat >= extent[2]) & (lat <= extent[3]))
                lons.append(lon[sel]); lats.append(lat[sel])
                xco2s.append(np.asarray(xco2)[sel] * 1e6)
            finally:
                f.close()
        self.data = {
            'lon': _entry(np.concatenate(lons), 'Longitude', 'deg'),
            'lat': _entry(np.concatenate(lats), 'Latitude', 'deg'),
            'xco2': _entry(np.concatenate(xco2s), 'XCO2', 'ppm'),
        }


class oco2_met:
    """OCO-2 meteorology (surface pressure, wind for Cox-Munk)."""

    ID = 'OCO2 Met'

    def __init__(self, fnames, extent=None):
        lons, lats, psfc, u10, v10 = [], [], [], [], []
        for fname in np.atleast_1d(fnames):
            f = open_any(fname)
            try:
                lon, _ = f.var('SoundingGeometry/sounding_longitude')
                lat, _ = f.var('SoundingGeometry/sounding_latitude')
                sel = np.ones(lon.shape, bool)
                if extent is not None:
                    sel = ((lon >= extent[0]) & (lon <= extent[1]) &
                           (lat >= extent[2]) & (lat <= extent[3]))
                lons.append(lon[sel]); lats.append(lat[sel])
                for tgt, nm in ((psfc, 'Meteorology/surface_pressure_met'),
                                (u10, 'Meteorology/windspeed_u_met'),
                                (v10, 'Meteorology/windspeed_v_met')):
                    try:
                        d, _ = f.var(nm)
                        tgt.append(np.asarray(d)[sel])
                    except Exception:
                        tgt.append(np.full(int(sel.sum()), np.nan))
            finally:
                f.close()
        self.data = {
            'lon': _entry(np.concatenate(lons), 'Longitude', 'deg'),
            'lat': _entry(np.concatenate(lats), 'Latitude', 'deg'),
            'p_sfc': _entry(np.concatenate(psfc), 'Surface pressure', 'Pa'),
            'u10': _entry(np.concatenate(u10), '10m wind u', 'm/s'),
            'v10': _entry(np.concatenate(v10), '10m wind v', 'm/s'),
        }

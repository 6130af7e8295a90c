"""Himawari AHI L2 cloud-product reader (capability parity with
er3t/util/ahi.py:20-178).

A copy of ``er3t_tpu/sat/ahi.py`` (:1-93), function for function; its
relative imports resolve to the port's own ``util`` modules, and a classic
netCDF granule opens through SciPy with no ``h5py``.
"""

from __future__ import annotations

import numpy as np

from ..util.grid import grid_by_extent
from ..util.ncio import apply_scaling, open_any

__all__ = ['ahi_l2']


def _entry(data, name, units='N/A'):
    return {'data': data, 'name': name, 'units': units}


class ahi_l2:
    """AHI L2 cloud properties (CLP product) -> gridded cot/cer maps.

    Mirrors the reference reader's contract (er3t/util/ahi.py:20-178):
    1D lat/lon axes meshed to 2D, COT/CER variables selectable
    (``vname_cot``/``vname_cer``), optional extent subsetting + gridding,
    multiple granules concatenated, and ``read_vars`` for extra variables.
    """

    ID = 'AHI L2 Cloud'

    def __init__(self, fnames, extent=None, nx=None, ny=None,
                 vname_cot='CLOT', vname_cer='CLER_23'):
        self.fnames = list(np.atleast_1d(fnames))
        self.extent = extent
        lons, lats, cots, cers = [], [], [], []
        for fname in self.fnames:
            f = open_any(fname)
            try:
                lon1, _ = f.var('longitude')
                lat1, _ = f.var('latitude')
                cot, a1 = f.var(vname_cot)
                cer, a2 = f.var(vname_cer)
                cot = apply_scaling(cot, a1)
                cer = apply_scaling(cer, a2)
                lon, lat = np.meshgrid(np.asarray(lon1), np.asarray(lat1),
                                       indexing='xy')
                sel = np.ones(lon.shape, bool)
                if extent is not None:
                    sel = ((lon >= extent[0]) & (lon <= extent[1]) &
                           (lat >= extent[2]) & (lat <= extent[3]))
                lons.append(lon[sel]); lats.append(lat[sel])
                cots.append(cot[sel]); cers.append(cer[sel])
            finally:
                f.close()
        lon = np.concatenate(lons); lat = np.concatenate(lats)
        cot = np.nan_to_num(np.concatenate(cots), nan=0.0)
        cer = np.nan_to_num(np.concatenate(cers), nan=0.0)
        self.data = {
            'lon': _entry(lon, 'Longitude', 'deg'),
            'lat': _entry(lat, 'Latitude', 'deg'),
            'cot': _entry(cot, 'Cloud optical thickness'),
            'cer': _entry(cer, 'Cloud effective radius', 'um'),
        }
        if extent is not None:
            lon2, lat2, cot2 = grid_by_extent(lon, lat, cot, extent, nx=nx, ny=ny)
            _, _, cer2 = grid_by_extent(lon, lat, cer, extent, nx=nx, ny=ny)
            self.data['lon_2d'] = _entry(lon2, 'Gridded longitude', 'deg')
            self.data['lat_2d'] = _entry(lat2, 'Gridded latitude', 'deg')
            self.data['cot_2d'] = _entry(np.nan_to_num(cot2), 'Gridded COT')
            self.data['cer_2d'] = _entry(np.nan_to_num(cer2), 'Gridded CER', 'um')

    def read_vars(self, vnames):
        """Read extra scene variables (e.g. CLTH, CLTT, QA) subsetted to the
        reader's extent (reference ahi.py:155-170)."""
        for fname in self.fnames:
            f = open_any(fname)
            try:
                lon1, _ = f.var('longitude')
                lat1, _ = f.var('latitude')
                lon, lat = np.meshgrid(np.asarray(lon1), np.asarray(lat1),
                                       indexing='xy')
                sel = np.ones(lon.shape, bool)
                if self.extent is not None:
                    sel = ((lon >= self.extent[0]) & (lon <= self.extent[1]) &
                           (lat >= self.extent[2]) & (lat <= self.extent[3]))
                for vname in vnames:
                    d, a = f.var(vname)
                    d = apply_scaling(d, a)[sel]
                    key = vname.lower()
                    if key in self.data:
                        d = np.hstack((self.data[key]['data'], d))
                    self.data[key] = _entry(d, vname)
            finally:
                f.close()
        return self

"""Uniform scientific-file IO over whichever backends are installed (copy of
``er3t_tpu/util/ncio.py:16-170``, function for function).

One dispatcher covers netCDF4 files (netCDF4 if present, else h5py), HDF5
(h5py), classic netCDF3 (``scipy.io.netcdf_file``) and HDF4 (pyhdf).  Each
backend is imported inside its adapter, so a classic netCDF file opens
with none of netCDF4, h5py or pyhdf installed.  Fill-value and scale
handling follow the reference's get_data_h4/get_data_nc conventions
(er3t/util/util.py:281-338).
"""

from __future__ import annotations

import os

import numpy as np

__all__ = ['open_any', 'read_var', 'apply_scaling', 'sniff_format']


def apply_scaling(data, attrs):
    """Mask fill values, apply scale_factor/add_offset -> float array.

    Packing conventions differ by format: HDF4/MODIS SDSes use
    ``(raw - add_offset) * scale_factor`` while netCDF/HDF5 follow CF,
    ``raw * scale_factor + add_offset`` (the reference gets this via
    netCDF4 auto-maskandscale, util.py:326-338).  The adapters tag the
    attrs dict with the file's convention; untagged callers default to
    the HDF4 convention (identical whenever add_offset is 0).
    """
    arr = np.asarray(data).astype(np.float64)
    fill = attrs.get('_FillValue', attrs.get('missing_value'))
    valid = attrs.get('valid_range')
    mask = np.zeros(arr.shape, dtype=bool)
    if fill is not None:
        mask |= arr == np.float64(np.squeeze(fill))
    if valid is not None:
        v = np.squeeze(np.asarray(valid, dtype=np.float64))
        if v.size == 2:
            mask |= (arr < v[0]) | (arr > v[1])
    scale = np.float64(np.squeeze(attrs.get('scale_factor', 1.0)))
    offset = np.float64(np.squeeze(attrs.get('add_offset', 0.0)))
    if attrs.get('__convention__') == 'cf':
        arr = arr * scale + offset
    else:
        arr = (arr - offset) * scale
    arr[mask] = np.nan
    return arr


class _H5Adapter:
    def __init__(self, fname):
        import h5py
        self.f = h5py.File(fname, 'r')

    def var(self, name):
        ds = self.f[name]
        attrs = dict(ds.attrs)
        attrs['__convention__'] = 'cf'
        return np.asarray(ds[...]), attrs

    def close(self):
        self.f.close()


class _NC4Adapter:
    def __init__(self, fname):
        from netCDF4 import Dataset
        self.f = Dataset(fname, 'r')
        self.f.set_auto_maskandscale(False)

    def var(self, name):
        v = self.f
        for part in name.strip('/').split('/')[:-1]:
            v = v.groups[part]
        v = v.variables[name.strip('/').split('/')[-1]]
        attrs = {k: v.getncattr(k) for k in v.ncattrs()}
        attrs['__convention__'] = 'cf'
        return np.asarray(v[...]), attrs

    def close(self):
        self.f.close()


class _NC3Adapter:
    def __init__(self, fname):
        from scipy.io import netcdf_file
        self.f = netcdf_file(fname, 'r', mmap=False)

    def var(self, name):
        v = self.f.variables[name.strip('/')]
        attrs = {k: getattr(v, k) for k in dir(v)
                 if k in ('scale_factor', 'add_offset', '_FillValue',
                          'missing_value', 'valid_range', 'units')}
        attrs['__convention__'] = 'cf'
        return np.asarray(v[:]), attrs

    def close(self):
        self.f.close()


class _H4Adapter:
    def __init__(self, fname):
        from pyhdf.SD import SD, SDC
        self.f = SD(fname, SDC.READ)

    def var(self, name):
        ds = self.f.select(name)
        return np.asarray(ds[:]), ds.attributes()

    def close(self):
        self.f.end()


def sniff_format(fname):
    """Magic-byte format tag: 'hdf4' | 'nc3' | 'idl' | 'hdf5'.

    Single source of truth for the dispatch used by open_any and the
    bin/lss + bin/lsa tree viewers ('hdf5' also covers netCDF4, whose
    container is HDF5; 'idl' is the IDL-save format bin/lsa lists).
    """
    with open(fname, 'rb') as fh:
        magic = fh.read(8)
    if magic[:4] == b'\x0e\x03\x13\x01':
        return 'hdf4'
    if magic[:3] == b'CDF':
        return 'nc3'
    if magic[:2] == b'SR':
        return 'idl'
    return 'hdf5'


def open_any(fname):
    """Open a data granule with the best available backend."""
    if not os.path.exists(fname):
        raise FileNotFoundError(fname)
    fmt = sniff_format(fname)
    if fmt == 'hdf4':
        try:
            return _H4Adapter(fname)
        except ImportError as e:
            raise ImportError(
                f'{fname} is HDF4 (MODIS collection format); install pyhdf '
                'to read it') from e
    if fmt == 'nc3':                                 # netCDF3 classic
        return _NC3Adapter(fname)
    # HDF5 (covers netCDF4)
    try:
        return _H5Adapter(fname)
    except Exception:
        return _NC4Adapter(fname)


def read_var(fname_or_f, name, scaled=True):
    """Read one variable (opens and closes if given a path)."""
    close = False
    f = fname_or_f
    if isinstance(fname_or_f, str):
        f = open_any(fname_or_f)
        close = True
    try:
        data, attrs = f.var(name)
        return apply_scaling(data, attrs) if scaled else data
    finally:
        if close:
            f.close()

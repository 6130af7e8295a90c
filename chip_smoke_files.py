"""NumPy writers of the input files that phases 10 and 11 of ``chip_smoke.py``
read, and the flight track of phase 11.

Its JAX reference commands read the same files, so they import this module
(NumPy and SciPy only; neither ``torch`` nor ``jax``) and not
``chip_smoke.py``:

* :func:`write_les_snapshot` — a SAM-layout LES snapshot made from a seed,
  in classic netCDF through ``scipy.io.netcdf_file``, with every variable
  that ``cld_les`` reads (``x``, ``y``, ``z``, ``p``, ``QC``, ``QV``,
  ``REL``, ``NC``, ``TABS``);
* :func:`write_abs_16g_txt` — a 16-g correlated-k database in the text-tree
  layout of ``abs_16g_from_txt``, made by a generator with the signature of
  ``gen_abs_16g_h5`` (either package's) with no ``h5py``: each dataset the
  generator writes becomes a text table, every float64 written so that it
  reads back bit for bit;
* :func:`write_ahi_clp` — a Himawari AHI CLP L2 granule made from a seed,
  in classic netCDF, in the JAXA P-Tree full-disk layout that
  ``sat.ahi.ahi_l2`` reads (1-D ``longitude``/``latitude``, packed
  ``CLOT``, ``CLER_23``, ``CLTH``);
* :func:`flight_track` — the aircraft track of
  ``projects/03_spns_flux_sim.py:82-87``.
"""

import os
import sys
import types

import numpy as np

LES_SHAPE = (480, 480, 60)       # columns x, y; levels
LES_DX_M = 100.0                 # horizontal spacing [m]
LES_DZ_M = 50.0                  # level spacing [m]
LES_BASE_KM, LES_TOP_KM = 0.5, 2.5
LES_CLOUD_FRAC = 0.25
LES_COARSEN = (1, 1, 10)         # 0.5 km layers, on the bench atmosphere's
# the bispectral LUT's (COT, CER) quadrants: node index ranges of its
# default 25 COT x 11 CER grid, COT <= 2.7 or above, CER <= 14 um or above
LUT_QUADRANTS = (((0, 13), (0, 6)), ((0, 13), (6, 11)),
                 ((13, 25), (0, 6)), ((13, 25), (6, 11)))
# the AHI CLP full disk at 0.05 deg: 80-200 E, 60 N-60 S (north first),
# Himawari-8/9 over 140.7 E; no retrieval beyond 70 deg of central angle
AHI_LON = (80.0, 200.0)
AHI_LAT = (60.0, -60.0)
AHI_STEPS_PER_DEG = 20
AHI_SUBSAT_LON = 140.7
AHI_EDGE_DEG = 70.0
AHI_CLOUD_FRAC = 0.3
# name: (scale_factor, add_offset, units) of the int16 packing (CF:
# raw * scale + offset); -32768 is the fill
AHI_PACKING = {'CLOT': (0.01, 0.0, '1'), 'CLER_23': (0.01, 0.0, 'um'),
               'CLTH': (0.001, 10.0, 'km')}
AHI_FILL = -32768
# projects/03_spns_flux_sim.py's defaults: the extent read and its grid
AHI_EXTENT = (120.0, 122.0, 15.0, 17.0)
AHI_NX = 48


def curve_rises(cot, ref, group=5):
    """Whether a reflectance-vs-COT curve rises with COT from COT 1: the
    means of consecutive groups of ``group`` nodes (from the first node at
    COT >= 1) increase strictly.  Node by node a nadir curve of 5e5
    photons does not: its per-node noise (Mie local estimates of
    near-vertical upwelling photons) exceeds the rise between neighbours."""
    r = np.asarray(ref)[np.asarray(cot) >= 1.0]
    r = r[:r.size // group * group].reshape(-1, group).mean(axis=1)
    return bool(r.size >= 2 and np.all(np.diff(r) > 0))


def lut_summary(table):
    """[the mean of a (COT, CER) reflectance table, then the means of its
    four LUT_QUADRANTS]."""
    table = np.asarray(table)
    return [float(table.mean())] + [float(table[a:b, c:d].mean())
                                    for (a, b), (c, d) in LUT_QUADRANTS]


def write_les_snapshot(fname, seed=0, shape=LES_SHAPE, dx_m=LES_DX_M,
                       dz_m=LES_DZ_M, base_km=LES_BASE_KM, top_km=LES_TOP_KM,
                       cloud_frac=LES_CLOUD_FRAC):
    """Write a broken cumulus deck as one SAM snapshot (time, z, y, x).

    A periodic Gaussian-smoothed noise field (1 km length scale) from
    ``seed`` is cut at its ``1 - cloud_frac`` quantile; a cloudy column's
    top rises from ``base_km`` to ``top_km`` with the field's excess
    (square root, so the strongest columns reach the top), and inside it
    the liquid water grows by 0.1 g/kg a km above the base, the effective
    radius from 6 um by 3 um a km, at 100 droplets /cm^3.  Pressure,
    temperature and vapour follow smooth standard profiles.  Arrays are
    float32, as SAM writes them.
    """
    nx, ny, nz = shape
    rng = np.random.default_rng(seed)
    kx = np.fft.fftfreq(nx, d=dx_m / 1000.0)[:, None]
    ky = np.fft.fftfreq(ny, d=dx_m / 1000.0)[None, :]
    field = np.real(np.fft.ifft2(np.fft.fft2(rng.normal(size=(nx, ny)))
                                 * np.exp(-2.0 * (np.pi * 1.0) ** 2
                                          * (kx ** 2 + ky ** 2))))
    thr = np.quantile(field, 1.0 - cloud_frac)
    excess = np.clip((field - thr) / (field.max() - thr), 0.0, 1.0)
    cloudy2d = field > thr
    top = base_km + (top_km - base_km) * np.sqrt(excess)       # (nx, ny) km

    z_km = (np.arange(nz) + 0.5) * dz_m / 1000.0
    h = z_km[:, None, None] - base_km                           # (nz, 1, 1)
    inside = cloudy2d[None] & (h > 0.0) & (z_km[:, None, None] < top[None])
    qc = np.where(inside, 0.1 * h, 0.0)                         # g/kg
    rel = np.where(inside, 6.0 + 3.0 * h, 0.0)                  # um
    nc = np.where(inside, 100.0, 0.0)                           # /cm^3
    tabs = np.broadcast_to((290.0 - 6.5 * z_km)[:, None, None], qc.shape)
    qv = np.broadcast_to((10.0 * np.exp(-z_km / 2.5))[:, None, None],
                         qc.shape)
    p_hpa = 1013.25 * np.exp(-z_km / 8.4)

    from scipy.io import netcdf_file
    with netcdf_file(fname, 'w') as f:
        for name, n in (('time', 1), ('z', nz), ('y', ny), ('x', nx)):
            f.createDimension(name, n)
        for name, dims, data in (
                ('time', ('time',), np.zeros(1)),
                ('x', ('x',), (np.arange(nx) + 0.5) * dx_m),
                ('y', ('y',), (np.arange(ny) + 0.5) * dx_m),
                ('z', ('z',), z_km * 1000.0),
                ('p', ('z',), p_hpa)):
            f.createVariable(name, 'f', dims)[:] = data
        for name, data in (('QC', qc), ('QV', qv), ('REL', rel), ('NC', nc),
                           ('TABS', tabs)):
            # (nz, nx, ny) -> SAM's (time, z, y, x)
            f.createVariable(name, 'f', ('time', 'z', 'y', 'x'))[0] = \
                np.transpose(data, (0, 2, 1)).astype(np.float32)
    return fname


class _TextTree:
    """The part of ``h5py.File`` that ``gen_abs_16g_h5`` uses, writing each
    dataset as a text file of the ``abs_16g_from_txt`` tree: the k-tables
    at ``{root}/{GAS}/pressure.{j}/temperature.{j}[/wv.{j}]/{kg}.{wvl}``
    (the HDF5 layout's ``k_arraynir`` level dropped, as the text layout
    has none), the solar groups as ``{root}/solar_v1.3/{band}/
    solar_taug.{wvl}``: the ``params`` row as its header line, then the
    ``data`` rows."""

    def __init__(self, root, mode='w'):
        if mode != 'w':
            raise ValueError('the text tree is written, never read, here')
        self.root = root

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def create_dataset(self, path, data, compression=None):
        parts = [p for p in path.strip('/').split('/') if p != 'k_arraynir']
        if parts[-1] in ('params', 'data'):
            fname = os.path.join(self.root, *parts[:-1])
            os.makedirs(os.path.dirname(fname), exist_ok=True)
            with open(fname, 'w' if parts[-1] == 'params' else 'a') as fh:
                np.savetxt(fh, np.atleast_2d(data), fmt='%.17g')
            return
        fname = os.path.join(self.root, *parts)
        os.makedirs(os.path.dirname(fname), exist_ok=True)
        np.savetxt(fname, data, fmt='%.17g')


def write_abs_16g_txt(fdir, wavelengths, gen):
    """Run ``gen(fname, wavelengths)`` (``gen_abs_16g_h5`` of either
    package) with ``h5py`` stood in for by :class:`_TextTree`, so that the
    database lands as the text tree under ``fdir``; returns ``fdir``.  The
    module ``h5py`` (when installed) is put back afterwards."""
    stand_in = types.ModuleType('h5py')
    stand_in.File = _TextTree
    saved = sys.modules.get('h5py')
    sys.modules['h5py'] = stand_in
    try:
        gen(fdir, wavelengths)
    finally:
        if saved is None:
            del sys.modules['h5py']
        else:
            sys.modules['h5py'] = saved
    return fdir



def write_ahi_clp(fname, seed=0, lon=AHI_LON, lat=AHI_LAT):
    """Write a broken cumulus field as one AHI CLP L2 granule.

    The axes are 1-D and float32, ``k / AHI_STEPS_PER_DEG`` degrees from
    the first value rounded once, so whole degrees (an extent's edges) are
    exact.  A Gaussian-smoothed noise field (0.1 deg length scale) from
    ``seed`` is cut at its ``1 - AHI_CLOUD_FRAC`` quantile; with the cut's
    excess e in (0, 1] a cloudy pixel has COT 2 + 58 e^1.5, CER 8 + 7 e um
    and its top at 1 + 2 sqrt(e) km; clear pixels are 0, 0 and 0.  Pixels
    more than ``AHI_EDGE_DEG`` of central angle from the sub-satellite
    point hold the fill.  Each variable is int16, CF-packed as
    ``AHI_PACKING`` says.  Returns ``fname``.
    """
    n_lon = int(round(abs(lon[1] - lon[0]) * AHI_STEPS_PER_DEG)) + 1
    n_lat = int(round(abs(lat[1] - lat[0]) * AHI_STEPS_PER_DEG)) + 1
    lon1 = (lon[0] + np.sign(lon[1] - lon[0]) * np.arange(n_lon)
            / AHI_STEPS_PER_DEG).astype(np.float32)
    lat1 = (lat[0] + np.sign(lat[1] - lat[0]) * np.arange(n_lat)
            / AHI_STEPS_PER_DEG).astype(np.float32)
    rng = np.random.default_rng(seed)
    ky = np.fft.fftfreq(n_lat, d=1.0 / AHI_STEPS_PER_DEG)[:, None]
    kx = np.fft.fftfreq(n_lon, d=1.0 / AHI_STEPS_PER_DEG)[None, :]
    field = np.real(np.fft.ifft2(np.fft.fft2(rng.normal(size=(n_lat, n_lon)))
                                 * np.exp(-2.0 * (np.pi * 0.1) ** 2
                                          * (kx ** 2 + ky ** 2))))
    thr = np.quantile(field, 1.0 - AHI_CLOUD_FRAC)
    cloudy = field > thr
    e = np.where(cloudy, (field - thr) / (field.max() - thr), 0.0)
    values = {'CLOT': np.where(cloudy, 2.0 + 58.0 * e ** 1.5, 0.0),
              'CLER_23': np.where(cloudy, 8.0 + 7.0 * e, 0.0),
              'CLTH': np.where(cloudy, 1.0 + 2.0 * np.sqrt(e), 0.0)}
    lon2, lat2 = np.meshgrid(np.deg2rad(lon1.astype(np.float64)
                                        - AHI_SUBSAT_LON),
                             np.deg2rad(lat1.astype(np.float64)))
    off_disk = np.cos(lat2) * np.cos(lon2) < np.cos(np.deg2rad(AHI_EDGE_DEG))

    from scipy.io import netcdf_file
    with netcdf_file(fname, 'w') as f:
        f.createDimension('latitude', n_lat)
        f.createDimension('longitude', n_lon)
        for name, data in (('latitude', lat1), ('longitude', lon1)):
            v = f.createVariable(name, 'f', (name,))
            v[:] = data
            v.units = 'degrees_north' if name == 'latitude' else 'degrees_east'
        for name, (scale, offset, units) in AHI_PACKING.items():
            raw = np.round((values[name] - offset) / scale)
            raw = np.where(off_disk, AHI_FILL, raw).astype(np.int16)
            v = f.createVariable(name, 'h', ('latitude', 'longitude'))
            v[:] = raw
            v.scale_factor = np.float32(scale)
            v.add_offset = np.float32(offset)
            v._FillValue = np.int16(AHI_FILL)
            v.units = units
    return fname


def flight_track(nx, n_pts=200):
    """Parametric diagonal-with-wiggle track in grid coordinates (a copy
    of ``projects/03_spns_flux_sim.py:82-87``)."""
    t = np.linspace(0.0, 1.0, n_pts)
    fx = np.clip((0.1 + 0.8 * t) * nx, 0, nx - 1)
    fy = np.clip((0.2 + 0.6 * t + 0.08 * np.sin(6.28 * 3 * t)) * nx, 0, nx - 1)
    return fx.astype(int), fy.astype(int)

"""VIIRS granule readers (netCDF4/HDF5 — readable with h5py).

A copy of ``er3t_tpu/sat/viirs.py`` (:1-611), function for function; its
relative imports resolve to the port's own ``util`` and ``sat`` modules.

Capability parity with er3t/util/viirs.py: geolocation (VNP03),
L1B radiance (VNP02), cloud properties (CLDPROP_L2), surface reflectance
(VNP09).  Same ``data[key] = {'data', 'name', 'units'}`` contract as the
MODIS readers.
"""

from __future__ import annotations

import numpy as np

from ..util.grid import grid_by_extent
from ..util.ncio import apply_scaling, open_any

__all__ = ['viirs_03', 'viirs_l1b', 'viirs_cldprop_l2', 'viirs_09',
           'viirs_09a1', 'viirs_43ma3', 'viirs_43ma4',
           'viirs_mvcm_cldmsk_l2', 'get_fname_pattern']


def _entry(data, name, units='N/A'):
    return {'data': data, 'name': name, 'units': units}


def _subset(lon, lat, extent):
    if extent is None:
        return np.ones(lon.shape, dtype=bool)
    return ((lon >= extent[0]) & (lon <= extent[1]) &
            (lat >= extent[2]) & (lat <= extent[3]))


class viirs_03:
    """VNP03MOD / VNP03IMG geolocation (reference viirs.py:96-271).

    Full angle set: solar AND sensor zenith/azimuth plus the land/water
    mask and quality flag when present (the reference reads all of
    ``geolocation_data``'s angle SDSes; vza/vaa feed the parallax
    correction, apps/cldpos.py).  ``vnames``: extra ``geolocation_data``
    SDS names read verbatim into ``self.data`` (lower-cased keys, the
    reference's ``read_vars``).  ``keep_dims=True`` retains the 2-D
    granule arrays; the extent mask is stored on ``self.logic[fname]``
    either way so downstream readers (cldprop ``f03=``) can reuse it."""

    ID = 'VIIRS Geolocation'

    _ANGLES = (('sza', 'solar_zenith', 'Solar zenith'),
               ('saa', 'solar_azimuth', 'Solar azimuth'),
               ('vza', 'sensor_zenith', 'Sensor zenith'),
               ('vaa', 'sensor_azimuth', 'Sensor azimuth'))

    def __init__(self, fnames, extent=None, vnames=(), keep_dims=False):
        self.extent = extent
        self.keep_dims = keep_dims
        self.logic = {}
        cols = {k: [] for k, _, _ in self._ANGLES}
        cols.update(lon=[], lat=[], land_water_mask=[])
        extra = {v: [] for v in vnames}
        for fname in np.atleast_1d(fnames):
            f = open_any(fname)
            try:
                lon, _ = f.var('geolocation_data/longitude')
                lat, _ = f.var('geolocation_data/latitude')
                sel = _subset(lon, lat, extent)
                # keyed by the granule time pattern so a sibling product
                # (cldprop f03=) of the same acquisition can look it up
                self.logic[get_fname_pattern(fname)] = {'mask': sel}
                pick = (lambda a: a) if keep_dims else (lambda a: a[sel])
                cols['lon'].append(pick(lon))
                cols['lat'].append(pick(lat))
                for key, sds, _ in self._ANGLES:
                    d, a = f.var(f'geolocation_data/{sds}')
                    cols[key].append(pick(apply_scaling(d, a)))
                try:
                    lw, _ = f.var('geolocation_data/land_water_mask')
                    cols['land_water_mask'].append(pick(np.asarray(lw)))
                except Exception:
                    pass
                for v in vnames:
                    d, a = f.var(f'geolocation_data/{v}')
                    extra[v].append(pick(apply_scaling(d, a)))
            finally:
                f.close()
        # keep_dims granules are vstacked along track (reference
        # np.vstack): granule row counts may differ, np.stack would fail
        cat = np.concatenate
        self.data = {
            'lon': _entry(cat(cols['lon']), 'Longitude', 'deg'),
            'lat': _entry(cat(cols['lat']), 'Latitude', 'deg'),
        }
        for key, _, name in self._ANGLES:
            self.data[key] = _entry(cat(cols[key]), name, 'deg')
        if cols['land_water_mask']:
            self.data['land_water_mask'] = _entry(
                cat(cols['land_water_mask']), 'Land/water mask')
        for v in vnames:
            self.data[v.lower()] = _entry(cat(extra[v]), v)


class viirs_l1b:
    """VNP02 L1B calibrated reflectance + radiance (reference
    viirs.py:273-474).

    Per band: TOA reflectance (``scale_factor``/``add_offset`` scaling),
    radiance via the band's ``radiance_scale_factor``/``radiance_add_offset``
    attributes, the uncertainty index when present, and the quality flags
    SDS.  ``bands`` may list several M/I-bands; fields become
    ``ref``/``rad``/``uct`` (first band, back-compatible) and
    ``ref_<band>``/... for the rest.

    VNP02 carries no geolocation of its own: region cropping comes from a
    paired ``viirs_03`` object (``f03=``, same granule time pattern) whose
    extent mask is applied to every band field — so ``ref`` stays aligned
    with the ``lon``/``lat`` copied from it (reference viirs.py:417-421).
    ``keep_dims=True`` skips the mask and retains the 2-D granules."""

    ID = 'VIIRS L1B'

    def __init__(self, fnames, f03=None, band='M05', bands=None,
                 keep_dims=False):
        bands = list(bands) if bands else [band]
        cols = {}
        for fname in np.atleast_1d(fnames):
            mask = None
            if f03 is not None and not keep_dims:
                mask = f03.logic.get(get_fname_pattern(fname),
                                     {}).get('mask')
            f = open_any(fname)
            try:
                for b in bands:
                    raw, attrs = f.var(f'observation_data/{b}')
                    arr = np.asarray(raw, dtype=np.float64)
                    if mask is not None:
                        arr = arr[mask]
                    fill = attrs.get('_FillValue', 65535)
                    bad = arr >= np.float64(np.squeeze(fill))
                    sf = np.float64(np.squeeze(attrs.get('scale_factor', 1.0)))
                    off = np.float64(np.squeeze(attrs.get('add_offset', 0.0)))
                    ref = (arr - off) * sf
                    ref[bad] = np.nan
                    cols.setdefault(('ref', b), []).append(ref)
                    # radiance from the radiance_* attribute pair (the
                    # reference's rad field, viirs.py:439-448)
                    rsf = attrs.get('radiance_scale_factor', None)
                    if rsf is not None:
                        roff = np.float64(np.squeeze(
                            attrs.get('radiance_add_offset', 0.0)))
                        rad = (arr - roff) * np.float64(np.squeeze(rsf))
                        rad[bad] = np.nan
                        cols.setdefault(('rad', b), []).append(rad)
                    for suf, key in (('_uncert_index', 'uct'),
                                     ('_quality_flags', 'qf')):
                        try:
                            u, ua = f.var(f'observation_data/{b}{suf}')
                            u = (apply_scaling(u, ua) if key == 'uct'
                                 else np.asarray(u))
                            if mask is not None:
                                u = u[mask]
                            cols.setdefault((key, b), []).append(u)
                        except Exception:
                            pass
            finally:
                f.close()
        names = {'ref': 'Reflectance (TOA)', 'rad': 'Radiance',
                 'uct': 'Uncertainty index', 'qf': 'Quality flags'}
        units = {'rad': 'W/m^2/um/sr'}
        self.data = {}
        for (kind, b), arrs in cols.items():
            key = kind if b == bands[0] else f'{kind}_{b}'
            self.data[key] = _entry(
                np.concatenate([a.ravel() for a in arrs]),
                f'{names[kind]} ({b})', units.get(kind, 'N/A'))
        if f03 is not None:
            self.data['lon'] = f03.data['lon']
            self.data['lat'] = f03.data['lat']


def _bits(b, k, n=1):
    """MSB-first bit field: ``n`` bits starting at bit ``k`` of uint8
    ``b`` (the reference decodes with np.unpackbits, viirs.py:546-620;
    shifting is equivalent and needs no reshape)."""
    b = np.asarray(b).astype(np.uint8)
    return (b >> (8 - k - n)) & ((1 << n) - 1)


class viirs_cldprop_l2:
    """CLDPROP_L2_VIIRS cloud properties (reference viirs.py:476-919).

    Optical-property mode (default): full SDS set — ctp/cth/cot/cer/cwp,
    the clear-sky-restoral PCL trio (fill-in identical to the reference's
    read_cop: invalid/undetermined-phase retrievals reset to clear, PCL
    values fill standard-clear pixels, flagged in ``pcl``), and the three
    uncertainty fields (percent -> absolute).  ``maskvars=True`` instead
    decodes the Cloud_Mask byte 0 (cloud_mask_flag, day_night_flag,
    sunglint_flag, snow_ice_flag, land_water_cat, fov_qa_cat) and, with
    ``quality_assurance>0``, the Quality_Assurance bytes 0-1 into
    ``self.qa`` (ret_std/1621 outcome + confidence + data availability;
    cld_type/rayleigh/cot_bands/cot_oob/bowtie).

    ``keep_dims=True`` retains the 2-D granule arrays (stacked along a
    leading file axis; the extent mask is stored on ``self.logic[fname]``);
    ``f03=`` reuses a ``viirs_03`` object's geolocation mask instead of
    re-deriving it (reference viirs.py:530-545, 649-660)."""

    ID = 'VIIRS Cloud Properties'

    def __init__(self, fnames, f03=None, extent=None, nx=None, ny=None,
                 maskvars=False, quality_assurance=0, keep_dims=False):
        self.qa = {}
        self.logic = {}
        self.keep_dims = keep_dims
        self.f03 = f03
        if maskvars:
            self._read_mask(fnames, extent, quality_assurance)
        else:
            self._read_cop(fnames, extent, nx, ny)

    def _mask(self, f, fname, extent):
        """Extent mask: reuse the viirs_03 object's stored mask when given
        (the reference's ``f03=`` path), else compute from this file's own
        geolocation."""
        lon, _ = f.var('geolocation_data/longitude')
        lat, _ = f.var('geolocation_data/latitude')
        pat = get_fname_pattern(fname)
        if self.f03 is not None and pat in getattr(self.f03, 'logic', {}):
            sel = self.f03.logic[pat]['mask']
        else:
            sel = _subset(lon, lat, extent)
        self.logic[pat] = {'mask': sel}
        return np.asarray(lon), np.asarray(lat), sel

    def _read_cop(self, fnames, extent, nx, ny):
        keep = self.keep_dims
        cols = {k: [] for k in ('lon', 'lat', 'ctp', 'cth', 'cot', 'cer',
                                'cwp', 'cot_uct', 'cer_uct', 'cwp_uct',
                                'pcl')}
        for fname in np.atleast_1d(fnames):
            f = open_any(fname)
            try:
                lon, lat, sel = self._mask(f, fname, extent)

                def rd(name, default=None):
                    try:
                        d, a = f.var(f'geophysical_data/{name}')
                        v = apply_scaling(d, a)
                        return v if keep else v[sel]
                    except Exception:
                        return default
                ctp = rd('Cloud_Phase_Optical_Properties')
                cth = rd('Cloud_Top_Height')
                cot = rd('Cloud_Optical_Thickness')
                cer = rd('Cloud_Effective_Radius')
                npx = cot.shape if cot is not None \
                    else (lon.shape if keep else lon[sel].shape)
                has_cer, has_cwp = cer is not None, \
                    rd('Cloud_Water_Path') is not None
                zeros = np.zeros(npx)
                cot = zeros.copy() if cot is None else np.nan_to_num(cot, nan=-1.0)
                cer = zeros.copy() if cer is None else np.nan_to_num(cer, nan=-1.0)
                cwp = rd('Cloud_Water_Path')
                cwp = zeros.copy() if cwp is None else np.nan_to_num(cwp, nan=-1.0)
                ctp = np.zeros(npx, np.int32) + 1 if ctp is None \
                    else np.nan_to_num(ctp, nan=0.0).astype(np.int32)
                cth = zeros.copy() if cth is None \
                    else np.nan_to_num(cth, nan=0.0) / 1000.0  # m -> km
                uct = {k: np.nan_to_num(rd(f'Cloud_{n}_Uncertainty',
                                           zeros.copy()), nan=0.0)
                       for k, n in (('cot', 'Optical_Thickness'),
                                    ('cer', 'Effective_Radius'),
                                    ('cwp', 'Water_Path'))}
                # PCL fill-in is decided from the PRE-RESET standard values
                # (reference logic_pcl uses cot0/cer0/cwp0_data == 0,
                # viirs.py:873-878): a FAILED standard retrieval (negative
                # fill / undetermined phase) stays clear and must NOT be
                # PCL-filled — only standard-clear (exact zero) pixels are
                cot0, cer0, cwp0 = cot.copy(), cer.copy(), cwp.copy()
                # invalid/undetermined-phase retrievals -> clear sky
                # (reference read_cop, viirs.py:852-860)
                bad = (cot < 0) | (cer < 0) | (cwp < 0) | (ctp == 0)
                for arr in (cot, cer, cwp, uct['cot'], uct['cer'],
                            uct['cwp']):
                    arr[bad] = 0.0
                pcl = np.zeros(npx, np.uint8)
                cot_p = rd('Cloud_Optical_Thickness_PCL')
                cer_p = rd('Cloud_Effective_Radius_PCL')
                cwp_p = rd('Cloud_Water_Path_PCL')
                if cot_p is not None and cer_p is not None:
                    cot_p = np.nan_to_num(cot_p, nan=-1.0)
                    cer_p = np.nan_to_num(cer_p, nan=-1.0)
                    # a defaulted (absent-SDS) cer/cwp is all-zero and must
                    # not mark every pixel standard-clear
                    fill = ((cot0 == 0) | (has_cer & (cer0 == 0))
                            | (has_cwp & (cwp0 == 0))) \
                        & (cot_p > 0) & (cer_p > 0)
                    if cwp_p is not None:
                        cwp_p = np.nan_to_num(cwp_p, nan=-1.0)
                        fill &= cwp_p > 0
                    pcl[fill] = 1
                    cot[fill] = cot_p[fill]
                    cer[fill] = cer_p[fill]
                    cwp[fill] = cwp_p[fill] if cwp_p is not None \
                        else 2.0 / 3.0 * cot_p[fill] * cer_p[fill]
                for k, v in (('lon', lon if keep else lon[sel]),
                             ('lat', lat if keep else lat[sel]),
                             ('ctp', ctp), ('cth', cth), ('cot', cot),
                             ('cer', cer), ('cwp', cwp),
                             ('cot_uct', cot * uct['cot'] / 100.0),
                             ('cer_uct', cer * uct['cer'] / 100.0),
                             ('cwp_uct', cwp * uct['cwp'] / 100.0),
                             ('pcl', pcl)):
                    cols[k].append(v)
            finally:
                f.close()
        cat = {k: np.concatenate(v) for k, v in cols.items()}
        names = {'ctp': 'Cloud phase (optical properties)',
                 'cth': 'Cloud top height', 'cot': 'Cloud optical thickness',
                 'cer': 'Cloud effective radius', 'cwp': 'Cloud water path',
                 'cot_uct': 'COT uncertainty', 'cer_uct': 'CER uncertainty',
                 'cwp_uct': 'CWP uncertainty',
                 'pcl': 'PCL fill-in flag'}
        units = {'cth': 'km', 'cer': 'um', 'cwp': 'g/m^2', 'cer_uct': 'um',
                 'cwp_uct': 'g/m^2'}
        self.data = {'lon': _entry(cat['lon'], 'Longitude', 'deg'),
                     'lat': _entry(cat['lat'], 'Latitude', 'deg')}
        for k in names:
            self.data[k] = _entry(cat[k], names[k], units.get(k, 'N/A'))
        if extent is not None:
            flat = {k: cat[k].ravel() for k in ('lon', 'lat', 'cot', 'cer')}
            lon2, lat2, cot2 = grid_by_extent(flat['lon'], flat['lat'],
                                              flat['cot'], extent, nx=nx, ny=ny)
            _, _, cer2 = grid_by_extent(flat['lon'], flat['lat'], flat['cer'],
                                        extent, nx=nx, ny=ny)
            self.data['lon_2d'] = _entry(lon2, 'Gridded longitude', 'deg')
            self.data['lat_2d'] = _entry(lat2, 'Gridded latitude', 'deg')
            self.data['cot_2d'] = _entry(np.nan_to_num(cot2), 'Gridded COT')
            self.data['cer_2d'] = _entry(np.nan_to_num(cer2), 'Gridded CER',
                                         'um')

    def _read_mask(self, fnames, extent, quality_assurance):
        keep = self.keep_dims
        cols = {k: [] for k in ('lon', 'lat', 'cloud_mask_flag',
                                'day_night_flag', 'sunglint_flag',
                                'snow_ice_flag', 'land_water_cat',
                                'fov_qa_cat')}
        qa_cols = {}
        for fname in np.atleast_1d(fnames):
            f = open_any(fname)
            try:
                lon, lat, sel = self._mask(f, fname, extent)
                pick = (lambda a: a) if keep else (lambda a: a[sel])
                cm, _ = f.var('geophysical_data/Cloud_Mask')
                b0 = pick(np.asarray(cm)[..., 0] if np.ndim(cm) == 3
                          else np.asarray(cm))
                # byte-0 decode (reference extract_data, viirs.py:549-568)
                cols['lon'].append(pick(lon))
                cols['lat'].append(pick(lat))
                cols['land_water_cat'].append(_bits(b0, 0, 2))
                cols['snow_ice_flag'].append(_bits(b0, 2))
                cols['sunglint_flag'].append(_bits(b0, 3))
                cols['day_night_flag'].append(_bits(b0, 4))
                cols['fov_qa_cat'].append(_bits(b0, 5, 2))
                cols['cloud_mask_flag'].append(_bits(b0, 7))
                if quality_assurance > 0:
                    qa, _ = f.var('geophysical_data/Quality_Assurance')
                    qa = np.asarray(qa)
                    q0 = pick(qa[..., 0])
                    q1 = pick(qa[..., 1])
                    # QA byte 0: retrieval outcome/confidence/availability
                    # (reference quality_assurance_byte0, viirs.py:571-596)
                    fields = {'ret_1621_qa': _bits(q0, 0),
                              'ret_1621_conf_qa': _bits(q0, 1, 2),
                              'ret_1621_data_qa': _bits(q0, 3),
                              'ret_std_qa': _bits(q0, 4),
                              'ret_std_conf_qa': _bits(q0, 5, 2),
                              'ret_std_data_qa': _bits(q0, 7)}
                    if quality_assurance > 1:
                        # QA byte 1 (quality_assurance_byte1, :599-620)
                        fields.update(bowtie_qa=_bits(q1, 0),
                                      cot_oob_qa=_bits(q1, 1),
                                      cot_bands_qa=_bits(q1, 2, 2),
                                      rayleigh_qa=_bits(q1, 4),
                                      cld_type_qa=_bits(q1, 5, 3))
                    for k, v in fields.items():
                        qa_cols.setdefault(k, []).append(v)
            finally:
                f.close()
        names = {
            'cloud_mask_flag': 'Cloud mask determined (0=not, 1=determined)',
            'fov_qa_cat': 'FOV category (0=cloudy..3=confident clear)',
            'day_night_flag': 'Day/night (0=night 1=day)',
            'sunglint_flag': 'Sunglint (0=in path 1=not)',
            'snow_ice_flag': 'Snow/ice processing (0=snow/ice 1=no)',
            'land_water_cat': 'Land/water (0=water..3=land)'}
        self.data = {'lon': _entry(np.concatenate(cols['lon']),
                                   'Longitude', 'deg'),
                     'lat': _entry(np.concatenate(cols['lat']),
                                   'Latitude', 'deg')}
        for k, nm in names.items():
            self.data[k] = _entry(np.concatenate(cols[k]), nm)
        for k, v in qa_cols.items():
            self.qa[k] = _entry(np.concatenate(v), k.replace('_', ' '))


class viirs_09:
    """VNP09 surface reflectance -> alb_2d."""

    ID = 'VIIRS Surface Reflectance'

    def __init__(self, fnames, f03=None, band='M5', extent=None,
                 nx=None, ny=None):
        refs = []
        for fname in np.atleast_1d(fnames):
            mask = None
            if f03 is not None:
                mask = f03.logic.get(get_fname_pattern(fname),
                                     {}).get('mask')
            f = open_any(fname)
            try:
                for cand in (f'{band} Surface Reflectance',
                             f'SurfReflect_{band}', band):
                    try:
                        r, a = f.var(cand)
                        r = apply_scaling(r, a)
                        # keep ref aligned with the f03 lon/lat (which
                        # carry f03's extent mask) for the gridding below
                        refs.append(r[mask] if mask is not None
                                    and mask.shape == r.shape else r)
                        break
                    except Exception:
                        continue
            finally:
                f.close()
        ref = np.clip(np.nan_to_num(np.concatenate([r.ravel() for r in refs])),
                      0.0, 1.0)
        self.data = {'ref': _entry(ref, 'Surface reflectance')}
        if f03 is not None and extent is not None:
            lon = f03.data['lon']['data']
            lat = f03.data['lat']['data']
            lon2, lat2, alb2 = grid_by_extent(lon, lat, ref, extent, nx=nx, ny=ny)
            self.data['lon_2d'] = _entry(lon2, 'Gridded longitude', 'deg')
            self.data['lat_2d'] = _entry(lat2, 'Gridded latitude', 'deg')
            self.data['alb_2d'] = _entry(np.nan_to_num(alb2), 'Gridded albedo')


class viirs_mvcm_cldmsk_l2:
    """CLDMSK_L2 VIIRS continuity cloud mask (reference viirs.py:921):
    Integer_Cloud_Mask 0=cloudy .. 3=confident clear."""

    ID = 'VIIRS MVCM Continuity Cloud Mask 6-Min Swath 750 m'

    def __init__(self, fname, extent=None):
        f = open_any(fname)
        try:
            lon, _ = f.var('geolocation_data/longitude')
            lat, _ = f.var('geolocation_data/latitude')
            msk, _ = f.var('geophysical_data/Integer_Cloud_Mask')
            sel = _subset(np.asarray(lon), np.asarray(lat), extent)
            self.data = {
                'lon': _entry(np.asarray(lon)[sel], 'Longitude', 'deg'),
                'lat': _entry(np.asarray(lat)[sel], 'Latitude', 'deg'),
                'cld_msk': _entry(np.asarray(msk)[sel],
                                  'Integer Cloud Mask '
                                  '(0=cloudy 1=prob.cloudy 2=prob.clear 3=clear)'),
            }
        finally:
            f.close()


def _tile_lonlat(fname, nrow, ncol):
    """Approximate lon/lat of a sinusoidal-tile product from its hXXvYY tag
    (reference derives them from the projection; analytic inverse here).

    HDF-EOS tile arrays are (YDim, XDim): rows run north->south (the tile's
    descending y), columns west->east — so latitude varies along axis 0 and
    longitude along axis 1, matching ``data[row, col]``."""
    import re
    from .modis import cal_sinusoidal_grid, _R_SINU
    m = re.search(r'h(\d\d)v(\d\d)', fname)
    if not m:
        return None, None, None, None
    ih, iv = int(m.group(1)), int(m.group(2))
    gx, gy = cal_sinusoidal_grid()
    x = np.linspace(gx[ih], gx[ih + 1], ncol, endpoint=False)   # cols: x
    y = np.linspace(gy[iv], gy[iv + 1], nrow, endpoint=False)   # rows: y N->S
    yy, xx = np.meshgrid(y, x, indexing='ij')                   # (nrow, ncol)
    lat = np.rad2deg(yy / _R_SINU)
    with np.errstate(invalid='ignore', divide='ignore'):
        lon = np.rad2deg(xx / (_R_SINU * np.cos(np.deg2rad(lat))))
    return lon, lat, xx, yy


class _viirs_tile_product:
    """Shared machinery for VNP09A1/43MA3/43MA4 sinusoidal-tile products."""

    _PATH = 'HDFEOS/GRIDS/{grid}/Data Fields/{var}'

    def _read_var(self, f, names):
        for n in names:
            try:
                d, a = f.var(n)
                return apply_scaling(d, a)
            except Exception:
                continue
        raise KeyError(f'none of {names} found')


class viirs_09a1(_viirs_tile_product):
    """VNP09A1 8-day surface reflectance on the sinusoidal tile grid
    (reference viirs.py:1393): data keys ref/lon/lat/x/y."""

    ID = 'VIIRS surface reflectance (1 km, 8 day)'

    def __init__(self, fnames, band='M4', extent=None):
        band = band.upper().replace('M0', 'M')
        refs = lon = lat = x = y = None
        for fname in np.atleast_1d(fnames):
            f = open_any(fname)
            try:
                ref = self._read_var(
                    f, [f'SurfReflect_{band}', f'SurfReflect_{band}_1',
                        self._PATH.format(grid='VNP_Grid_1km_L3_2d',
                                          var=f'SurfReflect_{band}_1')])
            finally:
                f.close()
            refs = ref if refs is None else np.nanmean([refs, ref], axis=0)
            if lon is None:
                lon, lat, x, y = _tile_lonlat(fname, *ref.shape)
        refs = np.where((refs >= -0.1) & (refs <= 1.6), refs, np.nan)
        self.data = {'ref': _entry(np.nan_to_num(refs), 'Surface reflectance'),
                     'alb_2d': _entry(np.nan_to_num(refs), 'Surface albedo')}
        if lon is not None:
            self.data.update(lon=_entry(lon, 'Longitude', 'deg'),
                             lat=_entry(lat, 'Latitude', 'deg'),
                             x=_entry(x, 'Sinusoidal x', 'm'),
                             y=_entry(y, 'Sinusoidal y', 'm'))


class viirs_43ma3(_viirs_tile_product):
    """VNP43MA3 black/white-sky albedo on the sinusoidal tile grid
    (reference viirs.py:1515): data keys bsa/wsa/lon/lat/x/y."""

    ID = 'VIIRS surface albedo (1 km)'

    def __init__(self, fnames, channels=('M4',), extent=None):
        bsa, wsa = {}, {}
        lon = lat = x = y = None
        for fname in np.atleast_1d(fnames):
            f = open_any(fname)
            try:
                for ch in channels:
                    bsa[ch] = self._read_var(
                        f, [f'Albedo_BSA_{ch}',
                            self._PATH.format(grid='VIIRS_Grid_BRDF',
                                              var=f'Albedo_BSA_{ch}')])
                    wsa[ch] = self._read_var(
                        f, [f'Albedo_WSA_{ch}',
                            self._PATH.format(grid='VIIRS_Grid_BRDF',
                                              var=f'Albedo_WSA_{ch}')])
            finally:
                f.close()
            if lon is None:
                lon, lat, x, y = _tile_lonlat(fname, *bsa[channels[0]].shape)
        b = np.stack([bsa[c] for c in channels], axis=-1)
        w = np.stack([wsa[c] for c in channels], axis=-1)
        self.data = {'bsa': _entry(np.nan_to_num(b), 'Black-sky albedo'),
                     'wsa': _entry(np.nan_to_num(w), 'White-sky albedo'),
                     'alb_2d': _entry(np.nan_to_num(w[..., 0]),
                                      'Surface albedo')}
        if lon is not None:
            self.data.update(lon=_entry(lon, 'Longitude', 'deg'),
                             lat=_entry(lat, 'Latitude', 'deg'),
                             x=_entry(x, 'Sinusoidal x', 'm'),
                             y=_entry(y, 'Sinusoidal y', 'm'))


class viirs_43ma4(_viirs_tile_product):
    """VNP43MA4 nadir BRDF-adjusted reflectance (reference viirs.py:1657)."""

    ID = 'VIIRS surface reflectance (1 km)'

    def __init__(self, fnames, channels=('M4',), extent=None):
        ref = {}
        lon = lat = x = y = None
        for fname in np.atleast_1d(fnames):
            f = open_any(fname)
            try:
                for ch in channels:
                    ref[ch] = self._read_var(
                        f, [f'Nadir_Reflectance_{ch}',
                            self._PATH.format(grid='VIIRS_Grid_BRDF',
                                              var=f'Nadir_Reflectance_{ch}')])
            finally:
                f.close()
            if lon is None:
                lon, lat, x, y = _tile_lonlat(fname, *ref[channels[0]].shape)
        r = np.stack([ref[c] for c in channels], axis=-1)
        self.data = {'ref': _entry(np.nan_to_num(r),
                                   'Nadir BRDF-adjusted reflectance'),
                     'alb_2d': _entry(np.nan_to_num(r[..., 0]),
                                      'Surface albedo')}
        if lon is not None:
            self.data.update(lon=_entry(lon, 'Longitude', 'deg'),
                             lat=_entry(lat, 'Latitude', 'deg'),
                             x=_entry(x, 'Sinusoidal x', 'm'),
                             y=_entry(y, 'Sinusoidal y', 'm'))


def get_fname_pattern(fname, index_s=1, index_e=2):
    """'VNP09A1.A2019241.h10v05...' -> 'A2019241.h10v05'
    (reference viirs.py:1791)."""
    import os
    return '.'.join(os.path.basename(fname).split('.')[index_s:index_e + 1])

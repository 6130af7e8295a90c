"""MODIS granule readers.

A copy of ``er3t_tpu/sat/modis.py`` (:1-939), function for function; its
relative imports resolve to the port's own ``util`` and ``sat`` modules.

Capability parity with er3t/util/modis.py (reference): geolocation (MOD03),
calibrated radiance (MOD02), cloud properties (MOD06_L2), cloud mask
(MOD35_L2), aerosol (MOD04), surface reflectance (MOD09), BRDF/albedo
(MCD43A1/A3).  Readers emit the reference's data contract:
``self.data[key] = {'data', 'name', 'units'}`` with the key names the
preprocessing layer consumes (lon_2d/lat_2d/cot_2d/cer_2d/alb_2d ...,
cf. er3t/pre/cld/cld_sat.py:140-142, er3t/pre/sfc/sfc_sat.py:100-101).

MODIS collection-6 granules are HDF4; reading requires pyhdf
(er3t_tpu.util.ncio raises a clear error otherwise).
"""

from __future__ import annotations

import numpy as np

from ..util.grid import grid_by_extent
from ..util.ncio import apply_scaling, open_any

__all__ = ['modis_03', 'modis_l1b', 'modis_l2', 'modis_35_l2', 'modis_04',
           'modis_09', 'modis_09a1', 'modis_43a3', 'modis_43a1', 'modis_07',
           'modis_29', 'modis_mvcm_cldmsk_l2', 'modis_tiff',
           'upscale_modis_lonlat', 'get_sinusoidal_grid_tag',
           'cal_sinusoidal_grid', 'sinusoidal_xy', 'download_modis_rgb']

# MODIS band center wavelengths [nm] for the L1B logic
# (reference: er3t/util/modis.py:34-85): reflective solar bands 1-19 + 26,
# emissive thermal bands 20-25 + 27-36
BAND_WVL = {1: 650.0, 2: 860.0, 3: 470.0, 4: 555.0, 5: 1240.0, 6: 1640.0,
            7: 2130.0, 8: 412.0, 9: 443.0, 10: 488.0, 11: 531.0, 12: 551.0,
            13: 667.0, 14: 678.0, 15: 748.0, 16: 869.0, 17: 905.0, 18: 936.0,
            19: 940.0, 20: 3750.0, 21: 3964.0, 22: 3964.0, 23: 4050.0,
            24: 4465.0, 25: 4515.0, 26: 1380.0, 27: 6715.0, 28: 7235.0,
            29: 8550.0, 30: 9730.0, 31: 11030.0, 32: 12020.0, 33: 13335.0,
            34: 13635.0, 35: 13935.0, 36: 14235.0}
QKM_BANDS = (1, 2)
HKM_ONLY_BANDS = (3, 4, 5, 6, 7)
RSB_1KM_BANDS = (8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 26)
EMISSIVE_BANDS = (20, 21, 22, 23, 24, 25, 27, 28, 29, 30, 31, 32, 33, 34,
                  35, 36)


def _entry(data, name, units='N/A'):
    return {'data': data, 'name': name, 'units': units}


def _subset(lon, lat, extent):
    if extent is None:
        return np.ones(lon.shape, dtype=bool)
    return ((lon >= extent[0]) & (lon <= extent[1]) &
            (lat >= extent[2]) & (lat <= extent[3]))


class modis_03:
    """MOD03/MYD03 geolocation (reference modis.py:91-250).

    ``vnames``: additional SDS names read verbatim into ``self.data``
    (lower-cased keys, the reference's ``read_vars``).  ``keep_dims=True``
    retains the 2-D granule arrays (the extent mask is stored on
    ``self.logic[fname]``) instead of applying the geomask."""

    ID = 'MODIS Geolocation'

    _ANGLES = (('sza', 'SolarZenith', 'Solar zenith'),
               ('saa', 'SolarAzimuth', 'Solar azimuth'),
               ('vza', 'SensorZenith', 'Sensor zenith'),
               ('vaa', 'SensorAzimuth', 'Sensor azimuth'))

    def __init__(self, fnames, extent=None, vnames=(), keep_dims=False):
        self.extent = extent
        self.logic = {}
        cols = {k: [] for k, _, _ in self._ANGLES}
        cols.update(lon=[], lat=[])
        extra = {v: [] for v in vnames}
        for fname in np.atleast_1d(fnames):
            f = open_any(fname)
            try:
                lon, _ = f.var('Longitude')
                lat, _ = f.var('Latitude')
                sel = _subset(lon, lat, extent)
                self.logic[fname] = {'1km': sel}
                pick = (lambda a: a) if keep_dims else (lambda a: a[sel])
                cols['lon'].append(pick(lon))
                cols['lat'].append(pick(lat))
                for key, sds, _ in self._ANGLES:
                    d, a = f.var(sds)
                    cols[key].append(pick(apply_scaling(d, a)))
                for v in vnames:
                    d, a = f.var(v)
                    extra[v].append(pick(apply_scaling(d, a)))
            finally:
                f.close()
        # keep_dims granules are vstacked along track (reference np.vstack,
        # modis.py:226-233): adjacent granules alternate 2030/2040 scan
        # lines, so np.stack would fail on exactly the multi-granule case
        cat = np.concatenate
        self.data = {
            'lon': _entry(cat(cols['lon']), 'Longitude', 'deg'),
            'lat': _entry(cat(cols['lat']), 'Latitude', 'deg'),
        }
        for key, _, name in self._ANGLES:
            self.data[key] = _entry(cat(cols[key]), name, 'deg')
        for v in vnames:
            self.data[v.lower()] = _entry(cat(extra[v]), v)


class modis_l1b:
    """MOD02/MYD02 L1B calibrated radiance/reflectance for one or more bands.

    Mirrors the reference reader's contract (er3t/util/modis.py:257-331 and
    onward): resolution inferred from the file name (QKM/HKM/1KM) or passed
    explicitly; at each resolution the coarser bands arrive through their
    aggregated datasets (EV_250_Aggr500_RefSB, EV_250_Aggr1km_RefSB, ...);
    the 1KM product additionally carries the narrow solar bands
    (EV_1KM_RefSB) and the thermal emissive bands (EV_1KM_Emissive, radiance
    only).  Outputs per band: calibrated radiance [W/m^2/nm/sr],
    TOA reflectance (x cos(SZA); NaN for emissive bands), corrected counts,
    and the uncertainty percentage uct_spc * exp(uct_index / uct_sca).
    Band membership is read from the granule's Band_* datasets when present
    (falling back to the standard ordering).
    """

    ID = 'MODIS L1B'

    # (dataset, uncertainty dataset, band-list dataset, default band order)
    _GROUPS = {
        'qkm': [('EV_250_RefSB', 'EV_250_RefSB_Uncert_Indexes',
                 'Band_250M', QKM_BANDS)],
        'hkm': [('EV_250_Aggr500_RefSB', 'EV_250_Aggr500_RefSB_Uncert_Indexes',
                 'Band_250M', QKM_BANDS),
                ('EV_500_RefSB', 'EV_500_RefSB_Uncert_Indexes',
                 'Band_500M', HKM_ONLY_BANDS)],
        '1km': [('EV_250_Aggr1km_RefSB', 'EV_250_Aggr1km_RefSB_Uncert_Indexes',
                 'Band_250M', QKM_BANDS),
                ('EV_500_Aggr1km_RefSB', 'EV_500_Aggr1km_RefSB_Uncert_Indexes',
                 'Band_500M', HKM_ONLY_BANDS),
                ('EV_1KM_RefSB', 'EV_1KM_RefSB_Uncert_Indexes',
                 'Band_1KM_RefSB', RSB_1KM_BANDS),
                ('EV_1KM_Emissive', 'EV_1KM_Emissive_Uncert_Indexes',
                 'Band_1KM_Emissive', EMISSIVE_BANDS)],
    }
    _VALID = {'qkm': set(QKM_BANDS),
              'hkm': set(QKM_BANDS) | set(HKM_ONLY_BANDS),
              '1km': set(BAND_WVL)}

    def __init__(self, fnames, f03=None, band=None, bands=None,
                 resolution=None, extent=None):
        fnames = list(np.atleast_1d(fnames))
        if resolution is None:
            low = fnames[0].lower()
            for tag in ('qkm', 'hkm', '1km'):
                if tag in low:
                    resolution = tag
                    break
            else:
                raise ValueError(
                    'cannot infer resolution from file name; pass '
                    "resolution='qkm'|'hkm'|'1km'")
        if bands is None:
            bands = [band] if band is not None else \
                ([1, 2] if resolution == 'qkm' else [1, 2, 3, 4, 5, 6, 7])
        bands = [int(b) for b in bands]
        invalid = set(bands) - self._VALID[resolution]
        if invalid:
            raise KeyError(
                f'band(s) {sorted(invalid)} not available in the '
                f'{resolution.upper()} product; valid: '
                f'{sorted(self._VALID[resolution])}')
        self.bands = bands
        self.band = bands[0]
        self.resolution = resolution

        per_band = {b: {'rad': [], 'ref': [], 'cnt': [], 'uct': []}
                    for b in bands}
        for fname in fnames:
            f = open_any(fname)
            try:
                self._read_granule(f, resolution, bands, per_band)
            finally:
                f.close()
        if extent is not None and f03 is None:
            raise ValueError(
                'modis_l1b cannot crop by extent on its own (L1B band data '
                'carry no same-resolution geolocation); pass the paired '
                'modis_03 object as f03= — its extent mask is applied to '
                'every band, block-replicated to finer band resolutions')
        mask = None
        if f03 is not None and len(getattr(f03, 'logic', {})) == 1:
            m = next(iter(f03.logic.values()))['1km']
            if m.dtype == bool and not m.all():
                mask = m
        if mask is not None:
            from ..util.grid import upscale_2d
            for b, d in per_band.items():
                for k, v in d.items():
                    d[k] = [a[upscale_2d(mask, (a.shape[0] // mask.shape[0],
                                                a.shape[1] // mask.shape[1]))
                              .astype(bool)]
                            if a.shape != mask.shape else a[mask]
                            for a in v]
        cat = {b: {k: np.concatenate([a.ravel() for a in v])
                   for k, v in d.items()} for b, d in per_band.items()}
        stackf = lambda k: np.stack([cat[b][k] for b in bands])
        self.data = {
            'rad': _entry(stackf('rad'), 'Radiance', 'W/m^2/nm/sr'),
            'ref': _entry(stackf('ref'), 'Reflectance (x cos(SZA))'),
            'cnt': _entry(stackf('cnt'), 'Corrected Counts'),
            'uct': _entry(stackf('uct'), 'Uncertainty Percentage'),
            'wvl': _entry(np.array([BAND_WVL[b] for b in bands]),
                          'Band wavelength', 'nm'),
        }
        if len(bands) == 1:
            # single-band convenience: drop the leading band axis
            for k in ('rad', 'ref', 'cnt', 'uct'):
                self.data[k]['data'] = self.data[k]['data'][0]
            self.data['wvl']['data'] = float(self.data['wvl']['data'][0])
        if f03 is not None:
            self.data['lon'] = f03.data['lon']
            self.data['lat'] = f03.data['lat']

    def _read_granule(self, f, resolution, bands, per_band):
        for ds_name, uct_name, band_ds, default_order in \
                self._GROUPS[resolution]:
            emissive = 'Emissive' in ds_name
            try:
                order, _ = f.var(band_ds)
                order = [int(b) for b in np.atleast_1d(order)]
            except Exception:
                order = list(default_order)
            wanted = [b for b in bands if b in order]
            if not wanted:
                continue
            raw, attrs = f.var(ds_name)
            raw = np.asarray(raw, dtype=np.float64)
            try:
                uct_raw, uattrs = f.var(uct_name)
                uct_raw = np.asarray(uct_raw, dtype=np.float64)
            except Exception:
                uct_raw, uattrs = None, {}

            def vec(key, default):
                return np.atleast_1d(attrs.get(key, [default] * len(order)))

            r_sc = vec('radiance_scales', 1.0)
            r_of = vec('radiance_offsets', 0.0)
            f_sc = vec('reflectance_scales', 1.0)
            f_of = vec('reflectance_offsets', 0.0)
            c_sc = vec('corrected_counts_scales', 1.0)
            c_of = vec('corrected_counts_offsets', 0.0)
            u_spc = np.atleast_1d(uattrs.get('specified_uncertainty',
                                             [np.nan] * len(order)))
            u_sca = np.atleast_1d(uattrs.get('scaling_factor',
                                             [1.0] * len(order)))
            for b in wanted:
                i = order.index(b)
                r = raw[i]
                bad = r > 32767          # MODIS fill values start at 65500
                rad = (r - r_of[i]) * r_sc[i] / 1000.0   # -> W/m^2/nm/sr
                rad[bad] = np.nan
                if emissive:
                    ref = np.full_like(rad, np.nan)
                    cnt = np.full_like(rad, np.nan)
                else:
                    ref = (r - f_of[i]) * f_sc[i]
                    cnt = (r - c_of[i]) * c_sc[i]
                    ref[bad] = np.nan
                    cnt[bad] = np.nan
                if uct_raw is not None:
                    uct = u_spc[i] * np.exp(uct_raw[i] / u_sca[i])
                else:
                    uct = np.full_like(rad, np.nan)
                per_band[b]['rad'].append(rad)
                per_band[b]['ref'].append(ref)
                per_band[b]['cnt'].append(cnt)
                per_band[b]['uct'].append(uct)


class modis_l2:
    """MOD06_L2 cloud optical properties with the reference's full QA chain.

    Depth parity with ``er3t.util.modis.modis_l2`` (modis.py:582-855):

    * ``cop_flag`` selects the retrieval family (e.g. ``'1621'``);
    * cloud-phase QA: ``Cloud_Phase_Optical_Properties`` is read (ctp);
      negative/fill retrievals and phase-0 pixels are reset to clear sky,
      phase-1 (clear) pixels with zero retrievals stay clear;
    * PCL fill-in: pixels the standard retrieval calls clear but the
      partially-cloudy (``_PCL``) retrieval calls cloudy take the PCL
      values and are tagged in ``pcl``;
    * relative uncertainties are converted to absolute
      (``cot * cot_err / 100``);
    * ``vnames=`` reads arbitrary extra variables at their native 1 km or
      5 km resolution (the reference's ``read_vars``).
    """

    ID = 'MODIS L2 Cloud'

    def __init__(self, fnames, extent=None, nx=None, ny=None, vnames=(),
                 cop_flag=''):
        sfx = f'_{cop_flag}' if cop_flag else ''
        cols = {k: [] for k in ('lon', 'lat', 'cot', 'cer', 'cwp', 'cth',
                                'ctp', 'pcl', 'cot_err', 'cer_err',
                                'cwp_err')}
        extra = {v: [] for v in vnames}
        for fname in np.atleast_1d(fnames):
            f = open_any(fname)
            try:
                lon, _ = f.var('Longitude')
                lat, _ = f.var('Latitude')

                def rd(name, default=None):
                    try:
                        d, a = f.var(name)
                    except Exception:
                        return default
                    return apply_scaling(d, a)

                cot = rd(f'Cloud_Optical_Thickness{sfx}')
                cer = rd(f'Cloud_Effective_Radius{sfx}')
                cwp = rd(f'Cloud_Water_Path{sfx}')
                cth = rd('Cloud_Top_Height')
                ctp = rd('Cloud_Phase_Optical_Properties')
                cot_pcl = rd(f'Cloud_Optical_Thickness{sfx}_PCL')
                cer_pcl = rd(f'Cloud_Effective_Radius{sfx}_PCL')
                cwp_pcl = rd(f'Cloud_Water_Path{sfx}_PCL')
                cot_err = rd(f'Cloud_Optical_Thickness_Uncertainty{sfx}')
                cer_err = rd(f'Cloud_Effective_Radius_Uncertainty{sfx}')
                cwp_err = rd(f'Cloud_Water_Path_Uncertainty{sfx}')
                if cot is None:
                    raise KeyError(f'Cloud_Optical_Thickness{sfx} missing '
                                   f'in {fname}')
                zeros = np.zeros_like(cot)
                has_cer, has_cwp = cer is not None, cwp is not None
                cer = zeros if cer is None else cer
                cwp = zeros if cwp is None else cwp
                cth = zeros if cth is None else cth
                ctp = np.full(cot.shape, 2, np.int16) if ctp is None \
                    else np.nan_to_num(ctp, nan=0).astype(np.int16)
                cot_err = zeros if cot_err is None else cot_err
                cer_err = zeros if cer_err is None else cer_err
                cwp_err = zeros if cwp_err is None else cwp_err

                # COT/CER are 1km; lon/lat in MOD06 are 5km — upscale with
                # the standard MODIS geolocation interpolation (grid
                # offsets + linear interp/extrapolation,
                # upscale_modis_lonlat; the reference's modis_l2 path uses
                # the same function, modis.py:660-668/2556).  Block
                # replication (upscale_2d) put every 1-km pixel of a 5-km
                # cell on the SAME coordinate — a ~2.5 km registration
                # error at gridding time.
                if lon.shape != cot.shape:
                    fy = int(round(cot.shape[0] / lon.shape[0]))
                    fx = int(round(cot.shape[1] / lon.shape[1]))
                    if fy == fx and fy in (2, 4, 5):
                        lon, lat = upscale_modis_lonlat(
                            lon, lat, scale=fy, extra_grid=(fy == 5))
                        lon = lon[:cot.shape[0], :cot.shape[1]]
                        lat = lat[:cot.shape[0], :cot.shape[1]]
                    else:
                        from ..util.grid import upscale_2d
                        lon = upscale_2d(lon, (fy, fx))[:cot.shape[0],
                                                        :cot.shape[1]]
                        lat = upscale_2d(lat, (fy, fx))[:cot.shape[0],
                                                        :cot.shape[1]]

                cot = np.nan_to_num(cot, nan=-1.0)
                cer = np.nan_to_num(cer, nan=-1.0)
                cwp = np.nan_to_num(cwp, nan=-1.0)
                cth = np.nan_to_num(cth, nan=0.0) / 1000.0
                pcl = np.zeros(cot.shape, np.uint8)
                # PCL fill-in below is decided from the PRE-RESET values
                # (reference logic_pcl uses cot0/cer0/cwp0_data == 0,
                # modis.py:772-774): failed retrievals (negative fill /
                # phase 0) stay clear and must not be PCL-filled
                cot0, cer0, cwp0 = cot.copy(), cer.copy(), cwp.copy()
                # invalid retrievals (negative/fill or undetermined phase)
                # reset to clear sky (modis.py:752-762)
                bad = (cot < 0) | (cer < 0) | (cwp < 0) | (ctp == 0)
                for arr in (cot, cer, cwp, cot_err, cer_err, cwp_err):
                    arr[bad] = 0.0
                # clear-phase pixels with empty retrievals stay clear
                clear = ((cot == 0) | (cer == 0) | (cwp == 0)) & (ctp == 1)
                cot[clear] = 0.0
                cer[clear] = 0.0
                cwp[clear] = 0.0
                # PCL fill-in (modis.py:770-782): standard-clear pixels the
                # PCL retrieval calls cloudy take the PCL values
                if cot_pcl is not None and cer_pcl is not None:
                    cot_pcl = np.nan_to_num(cot_pcl, nan=-1.0)
                    cer_pcl = np.nan_to_num(cer_pcl, nan=-1.0)
                    has_cwp_pcl = cwp_pcl is not None
                    if has_cwp_pcl:
                        cwp_pcl = np.nan_to_num(cwp_pcl, nan=-1.0)
                    # a defaulted (absent-SDS) cer/cwp is all-zero and must
                    # not mark every pixel standard-clear
                    fill = ((cot0 == 0) | (has_cer & (cer0 == 0))
                            | (has_cwp & (cwp0 == 0))) \
                        & (cot_pcl > 0) & (cer_pcl > 0)
                    if has_cwp_pcl:
                        fill &= cwp_pcl > 0
                    pcl[fill] = 1
                    cot[fill] = cot_pcl[fill]
                    cer[fill] = cer_pcl[fill]
                    if has_cwp_pcl:
                        cwp[fill] = cwp_pcl[fill]
                    else:
                        # CWP_PCL absent: derive LWP = 2/3 rho_w COT CER
                        # (g/m^2; CER in um) instead of writing COT values
                        # into the cwp field (advisor round-4 low)
                        cwp[fill] = (2.0 / 3.0 * cot_pcl[fill]
                                     * cer_pcl[fill])

                sel = _subset(lon, lat, extent)
                for key, arr in (('lon', lon), ('lat', lat), ('cot', cot),
                                 ('cer', cer), ('cwp', cwp), ('cth', cth),
                                 ('ctp', ctp), ('pcl', pcl),
                                 ('cot_err', cot * cot_err / 100.0),
                                 ('cer_err', cer * cer_err / 100.0),
                                 ('cwp_err', cwp * cwp_err / 100.0)):
                    cols[key].append(arr[sel])
                for v in vnames:
                    d = rd(v)
                    if d is None:
                        continue
                    if d.shape == cot.shape:
                        extra[v].append(np.nan_to_num(d)[sel])
                    else:
                        extra[v].append(np.nan_to_num(d).ravel())
            finally:
                f.close()
        merged = {k: np.concatenate(v) for k, v in cols.items() if v}
        lon, lat = merged['lon'], merged['lat']
        self.data = {
            'lon': _entry(lon, 'Longitude', 'deg'),
            'lat': _entry(lat, 'Latitude', 'deg'),
            'cot': _entry(merged['cot'], 'Cloud optical thickness'),
            'cer': _entry(merged['cer'], 'Cloud effective radius', 'um'),
            'cwp': _entry(merged['cwp'], 'Cloud water path', 'g/m^2'),
            'cth': _entry(merged['cth'], 'Cloud top height', 'km'),
            'ctp': _entry(merged['ctp'], 'Cloud phase (optical properties)'),
            'pcl': _entry(merged['pcl'], 'PCL tag (1: partly cloudy fill)'),
            'cot_err': _entry(merged['cot_err'], 'COT uncertainty'),
            'cer_err': _entry(merged['cer_err'], 'CER uncertainty', 'um'),
            'cwp_err': _entry(merged['cwp_err'], 'CWP uncertainty', 'g/m^2'),
        }
        for v, chunks in extra.items():
            if chunks:
                self.data[v.lower()] = _entry(np.concatenate(chunks), v)
        if extent is not None:
            cot, cer, cth = merged['cot'], merged['cer'], merged['cth']
            lon2, lat2, cot2 = grid_by_extent(lon, lat, cot, extent, nx=nx, ny=ny)
            _, _, cer2 = grid_by_extent(lon, lat, cer, extent, nx=nx, ny=ny)
            _, _, cth2 = grid_by_extent(lon, lat, cth, extent, nx=nx, ny=ny)
            self.data['lon_2d'] = _entry(lon2, 'Gridded longitude', 'deg')
            self.data['lat_2d'] = _entry(lat2, 'Gridded latitude', 'deg')
            self.data['cot_2d'] = _entry(np.nan_to_num(cot2), 'Gridded COT')
            self.data['cer_2d'] = _entry(np.nan_to_num(cer2), 'Gridded CER', 'um')
            self.data['cth_2d'] = _entry(np.nan_to_num(cth2), 'Gridded CTH', 'km')


class modis_35_l2:
    """MOD35_L2 cloud mask (reference modis.py byte-0 decode).

    Geolocation: the granule's own 5-km Longitude/Latitude upscaled to the
    1-km grid (upscale_modis_lonlat) masked to ``extent``, or a paired
    ``modis_03`` object's stored 1-km mask (``f03=``).  MODIS cloud-mask
    bits are LSB-first: bit0 determined, bits1-2 confidence category,
    bit3 day/night, bit4 sunglint, bit5 snow/ice, bits6-7 land/water;
    QA byte 0 gives use_qa (bit0) + confidence_qa (bits1-3)."""

    ID = 'MODIS Cloud Mask'

    def __init__(self, fnames, f03=None, extent=None):
        cols = {k: [] for k in
                ('lon', 'lat', 'cloud_mask', 'cloud_mask_flag', 'fov_qa_cat',
                 'day_night_flag', 'sunglint_flag', 'snow_ice_flag',
                 'land_water_cat', 'use_qa', 'confidence_qa')}
        for fname in np.atleast_1d(fnames):
            f = open_any(fname)
            try:
                cm, _ = f.var('Cloud_Mask')
                b0 = np.asarray(cm)[0].astype(np.uint8)     # byte 0, 1 km
                sel = lon = lat = None
                if f03 is not None and len(getattr(f03, 'logic', {})) == 1:
                    # reuse the stored 2-D extent mask of the paired
                    # granule (shape-matched; modis_03 keys masks by fname;
                    # multi-granule f03 data would not align per-file)
                    for m in f03.logic.values():
                        if m['1km'].shape == b0.shape:
                            sel = m['1km']
                            lon = np.asarray(f03.data['lon']['data'])
                            lat = np.asarray(f03.data['lat']['data'])
                            break
                if sel is None:
                    try:
                        lon5, _ = f.var('Longitude')
                        lat5, _ = f.var('Latitude')
                        lon, lat = upscale_modis_lonlat(
                            np.asarray(lon5, np.float64),
                            np.asarray(lat5, np.float64),
                            scale=5, extra_grid=True)
                        lon = lon[:b0.shape[0], :b0.shape[1]]
                        lat = lat[:b0.shape[0], :b0.shape[1]]
                    except Exception:
                        lon = lat = None
                    if lon is not None:
                        sel = _subset(lon, lat, extent)
                        lon, lat = lon[sel], lat[sel]
                pick = (lambda a: a[sel].ravel()) if sel is not None \
                    else (lambda a: a.ravel())
                if lon is not None:
                    cols['lon'].append(np.ravel(lon))
                    cols['lat'].append(np.ravel(lat))
                determined = b0 & 0x01
                conf = (b0 >> 1) & 0x03      # 0 cloudy .. 3 confident clear
                cols['cloud_mask'].append(pick(
                    np.where(determined > 0, conf, 255).astype(np.uint8)))
                cols['cloud_mask_flag'].append(pick(determined))
                cols['fov_qa_cat'].append(pick(conf))
                cols['day_night_flag'].append(pick((b0 >> 3) & 1))
                cols['sunglint_flag'].append(pick((b0 >> 4) & 1))
                cols['snow_ice_flag'].append(pick((b0 >> 5) & 1))
                cols['land_water_cat'].append(pick((b0 >> 6) & 3))
                try:
                    qa, _ = f.var('Quality_Assurance')
                    q0 = np.asarray(qa)[..., 0].astype(np.uint8)
                    cols['use_qa'].append(pick(q0 & 1))
                    cols['confidence_qa'].append(pick((q0 >> 1) & 7))
                except Exception:
                    pass
            finally:
                f.close()
        names = {
            'cloud_mask': 'Cloud mask (0 cloudy..3 clear; 255 undetermined)',
            'cloud_mask_flag': 'Cloud mask determined (0=not 1=determined)',
            'fov_qa_cat': 'FOV category (0=cloudy..3=confident clear)',
            'day_night_flag': 'Day/night (0=night 1=day)',
            'sunglint_flag': 'Sunglint flag',
            'snow_ice_flag': 'Snow/ice background flag',
            'land_water_cat': 'Land/water (0=water..3=land)',
            'use_qa': 'QA: usefulness (0=discard 1=useful)',
            'confidence_qa': 'QA: confidence (0..7)',
            'lon': 'Longitude', 'lat': 'Latitude'}
        self.data = {}
        for k, v in cols.items():
            if v:
                self.data[k] = _entry(
                    np.concatenate(v), names[k],
                    'deg' if k in ('lon', 'lat') else 'N/A')


class modis_04:
    """MOD04 aerosol optical depth."""

    ID = 'MODIS Aerosol'

    def __init__(self, fnames, extent=None):
        lons, lats, aods = [], [], []
        for fname in np.atleast_1d(fnames):
            f = open_any(fname)
            try:
                lon, _ = f.var('Longitude')
                lat, _ = f.var('Latitude')
                aod, a = f.var('AOD_550_Dark_Target_Deep_Blue_Combined')
                aod = apply_scaling(aod, a)
                sel = _subset(lon, lat, extent)
                lons.append(lon[sel]); lats.append(lat[sel]); aods.append(aod[sel])
            finally:
                f.close()
        self.data = {
            'lon': _entry(np.concatenate(lons), 'Longitude', 'deg'),
            'lat': _entry(np.concatenate(lats), 'Latitude', 'deg'),
            'aod': _entry(np.concatenate(aods), 'AOD 550nm'),
        }


class modis_09:
    """MOD09 atmospherically-corrected surface reflectance -> alb_2d."""

    ID = 'MODIS Surface Reflectance'

    def __init__(self, fnames, extent=None, band=1, nx=None, ny=None):
        lons, lats, refs = [], [], []
        for fname in np.atleast_1d(fnames):
            f = open_any(fname)
            try:
                lon, _ = f.var('Longitude')
                lat, _ = f.var('Latitude')
                ref, a = f.var(f'1km Surface Reflectance Band {band}')
                ref = apply_scaling(ref, a)
                sel = _subset(lon, lat, extent)
                lons.append(lon[sel]); lats.append(lat[sel]); refs.append(ref[sel])
            finally:
                f.close()
        lon = np.concatenate(lons); lat = np.concatenate(lats)
        ref = np.clip(np.nan_to_num(np.concatenate(refs)), 0.0, 1.0)
        self.data = {
            'lon': _entry(lon, 'Longitude', 'deg'),
            'lat': _entry(lat, 'Latitude', 'deg'),
            'ref': _entry(ref, 'Surface reflectance'),
        }
        if extent is not None:
            lon2, lat2, alb2 = grid_by_extent(lon, lat, ref, extent, nx=nx, ny=ny)
            self.data['lon_2d'] = _entry(lon2, 'Gridded longitude', 'deg')
            self.data['lat_2d'] = _entry(lat2, 'Gridded latitude', 'deg')
            self.data['alb_2d'] = _entry(np.nan_to_num(alb2), 'Gridded albedo')


class modis_43a3:
    """MCD43A3 white/black-sky albedo."""

    ID = 'MODIS BRDF Albedo'

    def __init__(self, fnames, band=1):
        wsas, bsas = [], []
        for fname in np.atleast_1d(fnames):
            f = open_any(fname)
            try:
                wsa, a1 = f.var(f'Albedo_WSA_Band{band}')
                bsa, a2 = f.var(f'Albedo_BSA_Band{band}')
                wsas.append(apply_scaling(wsa, a1))
                bsas.append(apply_scaling(bsa, a2))
            finally:
                f.close()
        self.data = {
            'wsa': _entry(np.stack(wsas).squeeze(), 'White-sky albedo'),
            'bsa': _entry(np.stack(bsas).squeeze(), 'Black-sky albedo'),
        }


class modis_43a1:
    """MCD43A1 BRDF kernel weights (f_iso, f_vol, f_geo) -> LSRT surface."""

    ID = 'MODIS BRDF Parameters'

    def __init__(self, fnames, band=1):
        pars = []
        for fname in np.atleast_1d(fnames):
            f = open_any(fname)
            try:
                p, a = f.var(f'BRDF_Albedo_Parameters_Band{band}')
                pars.append(apply_scaling(p, a))
            finally:
                f.close()
        p = np.stack(pars).squeeze()
        self.data = {
            'f_iso': _entry(p[..., 0], 'Isotropic kernel weight'),
            'f_vol': _entry(p[..., 1], 'RossThick kernel weight'),
            'f_geo': _entry(p[..., 2], 'LiSparseR kernel weight'),
        }

    def lsrt_2d(self):
        """(Nx, Ny, 3) array for er3t_tpu.pre.sfc.sfc_2d_gen."""
        return np.stack([np.nan_to_num(self.data['f_iso']['data']),
                         np.nan_to_num(self.data['f_geo']['data']),
                         np.nan_to_num(self.data['f_vol']['data'])], axis=-1)


class modis_07:
    """MOD07/MYD07 atmospheric profiles (reference modis.py:1756).

    data keys: lon, lat, p_level, cld_mask, T_level_retrieved,
    dewT_level_retrieved, wvmx_level_retrieved, h_sfc, p_sfc, sza/saa/vza/vaa.
    """

    ID = 'MODIS Atmospheric Profiles'

    _VARS = {
        'cld_mask': 'Cloud_Mask',
        'T_level_retrieved': 'Retrieved_Temperature_Profile',
        'dewT_level_retrieved': 'Retrieved_Moisture_Profile',
        'wvmx_level_retrieved': 'Retrieved_WV_Mixing_Ratio_Profile',
        'h_sfc': 'Surface_Elevation',
        'p_sfc': 'Surface_Pressure',
        'sza': 'Solar_Zenith',
        'saa': 'Solar_Azimuth',
        'vza': 'Sensor_Zenith',
        'vaa': 'Sensor_Azimuth',
    }

    def __init__(self, fnames=None, extent=None):
        self.extent = extent
        acc = {k: [] for k in ('lon', 'lat', *self._VARS)}
        p_lev = None      # first non-None Pressure_Levels across granules
        for fname in np.atleast_1d(fnames):
            f = open_any(fname)
            try:
                lon, _ = f.var('Longitude')
                lat, _ = f.var('Latitude')
                sel = _subset(lon, lat, extent)
                acc['lon'].append(np.asarray(lon)[sel])
                acc['lat'].append(np.asarray(lat)[sel])
                for key, var in self._VARS.items():
                    try:
                        d, a = f.var(var)
                    except Exception:
                        continue
                    d = apply_scaling(d, a)
                    if d.ndim == 3:       # (level, y, x) profile variables
                        acc[key].append(np.moveaxis(d, 0, -1)[sel])
                    else:
                        acc[key].append(np.asarray(d)[sel])
                if p_lev is None:
                    try:
                        p_lev, _ = f.var('Pressure_Levels')
                    except Exception:
                        p_lev = None
            finally:
                f.close()
        self.data = {k: _entry(np.concatenate(v) if v else np.array([]),
                               k) for k, v in acc.items()}
        self.data['lon']['units'] = self.data['lat']['units'] = 'deg'
        if p_lev is not None:
            self.data['p_level'] = _entry(np.asarray(p_lev), 'Pressure Level',
                                          'hPa')


class modis_29:
    """MOD29/MYD29 sea-ice extent + ice-surface temperature
    (reference modis.py:2080)."""

    ID = 'MODIS Sea Ice Extent 5-Min L2 Swath 1km'

    def __init__(self, fname, f03=None, extent=None):
        f = open_any(fname)
        try:
            d_ice, a_ice = f.var('Sea_Ice_by_Reflectance')
            d_t, a_t = f.var('Ice_Surface_Temperature')
            d_ice = np.asarray(d_ice)
            ist = apply_scaling(d_t, a_t)
            try:
                lon, _ = f.var('Longitude')
                lat, _ = f.var('Latitude')
                lon, lat = np.asarray(lon), np.asarray(lat)
                sel = _subset(lon, lat, extent)
            except Exception:
                if f03 is None:
                    raise ValueError('modis_29 needs 1-km geolocation: pass '
                                     'a modis_03 object as f03')
                # f03.data lon/lat are already extent-masked 1-D; its
                # stored 2-D mask (shape-matched) indexes this granule's
                # SDS arrays consistently
                lon = np.asarray(f03.data['lon']['data'])
                lat = np.asarray(f03.data['lat']['data'])
                sel = None
                for m in getattr(f03, 'logic', {}).values():
                    if m['1km'].shape == d_ice.shape:
                        sel = m['1km']
                        break
                if sel is None or int(sel.sum()) != lon.size:
                    raise ValueError(
                        'modis_29: the f03 mask does not match this '
                        'granule shape; build modis_03 from the paired '
                        'MOD03 granule (same extent, single file)')
                self.data = {
                    'lon': _entry(lon, 'Longitude', 'deg'),
                    'lat': _entry(lat, 'Latitude', 'deg'),
                    'ice_extent': _entry(d_ice[sel],
                                         'Sea Ice by Reflectance'),
                    'ist': _entry(ist[sel], 'Ice Surface Temperature', 'K'),
                }
                return
            self.data = {
                'lon': _entry(lon[sel], 'Longitude', 'deg'),
                'lat': _entry(lat[sel], 'Latitude', 'deg'),
                'ice_extent': _entry(d_ice[sel], 'Sea Ice by Reflectance'),
                'ist': _entry(ist[sel], 'Ice Surface Temperature', 'K'),
            }
        finally:
            f.close()


class modis_09a1:
    """MOD09A1/MYD09A1 8-day gridded surface reflectance (sinusoidal tile;
    reference modis.py:1954): per-band alb on the tile grid."""

    ID = 'MODIS Surface Reflectance 8-Day L3 Global 500m'

    def __init__(self, fnames, band=1, extent=None):
        albs = []
        for fname in np.atleast_1d(fnames):
            f = open_any(fname)
            try:
                d, a = f.var(f'sur_refl_b{band:02d}')
                alb = apply_scaling(d, a)
                alb = np.where((alb >= 0) & (alb <= 1.6), alb, np.nan)
                albs.append(alb)
            finally:
                f.close()
        alb = np.concatenate([a[None] for a in albs]).squeeze(0) \
            if len(albs) == 1 else np.nanmean(np.stack(albs), axis=0)
        self.data = {
            'alb_2d': _entry(np.nan_to_num(alb), 'Surface reflectance'),
            'band': _entry(band, 'MODIS band'),
        }


class modis_mvcm_cldmsk_l2:
    """CLDMSK_L2 continuity MODIS-VIIRS cloud mask (netCDF;
    reference modis.py:1079): Integer_Cloud_Mask 0..3."""

    ID = 'MODIS MVCM Continuity Cloud Mask 5-Min Swath 1 km'

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


class modis_tiff:
    """GeoTIFF quicklook reader (reference modis.py:2474); requires PIL or
    matplotlib for decoding."""

    ID = 'MODIS GeoTIFF'

    def __init__(self, fname):
        try:
            from PIL import Image
            img = np.asarray(Image.open(fname))
        except ImportError:
            import matplotlib.image as mpimg
            img = mpimg.imread(fname)
        self.data = {'img': _entry(img, 'Image'),
                     'shape': _entry(img.shape, 'Shape')}


# --- geolocation utilities (reference modis.py:2556-3041) ---

_R_SINU = 6371007.181  # MODIS sinusoidal sphere radius [m]


def sinusoidal_xy(lon, lat):
    """Forward MODIS sinusoidal projection (exact analytic form)."""
    lon = np.deg2rad(np.asarray(lon, dtype=np.float64))
    lat = np.deg2rad(np.asarray(lat, dtype=np.float64))
    return _R_SINU * lon * np.cos(lat), _R_SINU * lat


def cal_sinusoidal_grid():
    """36x18 MODIS sinusoidal tile boundaries [m]
    (reference cal_sinusoidal_grid, modis.py:2963)."""
    x_max = _R_SINU * np.pi
    y_max = _R_SINU * np.pi / 2.0
    return np.linspace(-x_max, x_max, 37), np.linspace(y_max, -y_max, 19)


def get_sinusoidal_grid_tag(lon, lat, verbose=False):
    """Tile tags ('h10v17', ...) containing the given track
    (reference get_sinusoidal_grid_tag, modis.py:2998)."""
    x, y = sinusoidal_xy(np.ravel(lon), np.ravel(lat))
    grid_x, grid_y = cal_sinusoidal_grid()
    tags = []
    for ih in range(36):
        for iv in range(18):
            hit = ((x >= grid_x[ih]) & (x <= grid_x[ih + 1]) &
                   (y >= grid_y[iv + 1]) & (y <= grid_y[iv]))
            if hit.any():
                tags.append(f'h{ih:02d}v{iv:02d}')
    return tags


def upscale_modis_lonlat(lon_in, lat_in, scale=5, extra_grid=True):
    """Upscale MODIS geolocation 5km->1km (scale=5), 1km->250m (4),
    1km->500m (2) by separable linear interpolation/extrapolation in index
    space with the standard grid offsets (reference modis.py:2556; see
    icare.univ-lille1.fr MODIS geolocation notes).  Pure numpy — the
    interpolation runs on locally linearized coordinates, adequate at
    sub-5km scales away from the dateline."""
    offsets = {4: (0.0, 1.5), 5: (2.0, 2.0), 2: (0.0, 0.5)}[scale]
    lon_in = np.asarray(lon_in, dtype=np.float64).copy()
    lat_in = np.asarray(lat_in, dtype=np.float64)
    lon_in[lon_in > 180.0] -= 360.0
    # unwrap dateline within the granule
    if lon_in.max() - lon_in.min() > 180.0:
        lon_in = np.where(lon_in < 0.0, lon_in + 360.0, lon_in)

    ny, nx = lon_in.shape
    # MOD/MYD 05/06 5-km geolocation is 4 ALONG-SCAN columns short of the
    # 1-km grid: a (406, 270) granule upscales to (2030, 1354), i.e. the
    # extension is +4 columns (reference XX = np.arange(x+4)), never rows
    ny_out = ny * scale
    nx_out = nx * scale + (4 if (extra_grid and scale == 5) else 0)
    iy = (np.arange(ny_out) - offsets[1]) / scale
    ix = (np.arange(nx_out) - offsets[0]) / scale

    def interp2(z):
        # separable linear interp with linear extrapolation at the edges
        def interp1(zi, t, n):
            i0 = np.clip(np.floor(t).astype(int), 0, n - 2)
            f = t - i0
            return zi[..., i0] * (1 - f) + zi[..., i0 + 1] * f
        z1 = interp1(np.moveaxis(z, 0, -1), iy, ny)      # (nx, ny_out)
        return interp1(np.moveaxis(z1, 0, -1), ix, nx)   # (ny_out, nx_out)

    lon_out = interp2(lon_in)
    lat_out = interp2(lat_in)
    lon_out = np.where(lon_out > 180.0, lon_out - 360.0, lon_out)
    return lon_out, lat_out


def download_modis_rgb(date, extent, which='terra', fdir='.', dpm=100,
                       run=True, _get=None):
    """MODIS true-color RGB over ``extent`` (reference download_modis_rgb,
    modis.py:2650).

    The reference renders the GIBS WMTS layer through cartopy/owslib; here
    the same corrected-reflectance layer comes from the Worldview snapshot
    API (sat/daac.py) with no plotting-stack dependency.  ``run=False``
    returns the filename without touching the network (the reference's
    contract for cached images).  Returns the local PNG filename.
    """
    import os

    from .daac import (download_url, worldview_image_fname,
                       worldview_image_url)
    which = which.lower()
    if which not in ('terra', 'aqua'):
        raise ValueError("which must be 'terra' or 'aqua'")
    layer = f'MODIS_{which.capitalize()}_CorrectedReflectance_TrueColor'
    fname = worldview_image_fname(f'{which}_rgb', date, extent, fdir)
    if run:
        url = worldview_image_url(date, extent, layer=layer, dpm=dpm)
        out = download_url(url, fdir, min_size=128, _get=_get)
        os.replace(out, fname)
    return fname

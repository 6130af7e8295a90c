"""NASA DAAC download machinery.

A copy of ``er3t_tpu/sat/daac.py`` (:1-573), function for function; its
relative imports resolve to the port's own ``util`` and ``sat`` modules.

Capability parity with er3t/util/daac.py: Earthdata authentication
(token/netrc), LAADS/LANCE/NSIDC/GES-DISC URL construction, geoMeta-based
granule search for a (date, lon, lat) query, file download with integrity
check, and Worldview quicklook imagery URLs.  Network access is optional —
every function that touches the network degrades with a clear error when
offline.
"""

from __future__ import annotations

import datetime
import io
import os

import numpy as np

__all__ = ['earthdata_token', 'geometa_url', 'parse_geometa',
           'find_granules', 'granules_over_extent', 'swath_lonlat_utc',
           'download_url', 'download_laads_https', 'download_nsidc_https',
           'download_oco2_https', 'list_remote_dir',
           'worldview_image_url', 'worldview_image_fname', 'SAT_TAGS']


def _t(tag, dataset_tag, key, desc, sat, inst, daac='laads'):
    """Catalog entry (reference layout: er3t/common.py:66-591 entries carry
    dataset_tag/dict_key/description/satellite/instrument + DOI website)."""
    archive = dataset_tag.split('/')[0] if '/' in dataset_tag else ''
    product = dataset_tag.split('/')[-1]
    if daac == 'laads' and archive:
        website = f'http://dx.doi.org/10.5067/{inst}/{product}.0{archive[:2]}'
    elif daac == 'worldview':
        website = 'https://worldview.earthdata.nasa.gov'
    elif daac == 'gesdisc':
        website = 'https://disc.gsfc.nasa.gov'
    else:
        website = 'https://nsidc.org'
    return tag, {'dataset_tag': dataset_tag, 'archive': archive or '61',
                 'dict_key': key, 'description': desc, 'satellite': sat,
                 'sat': sat, 'instrument': inst, 'daac': daac,
                 'website': website}


# full product catalog (reference er3t/common.py:66-591, all entries)
SAT_TAGS = dict([
    _t('MODRGB', 'MODRGB', 'mod_rgb', 'Terra MODIS True Color (RGB) Imagery', 'Terra', 'MODIS', 'worldview'),
    _t('MYDRGB', 'MYDRGB', 'myd_rgb', 'Aqua MODIS True Color (RGB) Imagery', 'Aqua', 'MODIS', 'worldview'),
    _t('MOD03', '61/MOD03', 'mod_03', 'Terra MODIS Geolocation Fields Product', 'Terra', 'MODIS'),
    _t('MYD03', '61/MYD03', 'myd_03', 'Aqua MODIS Geolocation Fields Product', 'Aqua', 'MODIS'),
    _t('MOD02QKM', '61/MOD02QKM', 'mod_02', 'Terra MODIS Level 1b (250m) Calibrated Radiances Product', 'Terra', 'MODIS'),
    _t('MYD02QKM', '61/MYD02QKM', 'myd_02', 'Aqua MODIS Level 1b (250m) Calibrated Radiances Product', 'Aqua', 'MODIS'),
    _t('MOD02HKM', '61/MOD02HKM', 'mod_02', 'Terra MODIS Level 1b (500m) Calibrated Radiances Product', 'Terra', 'MODIS'),
    _t('MYD02HKM', '61/MYD02HKM', 'myd_02', 'Aqua MODIS Level 1b (500m) Calibrated Radiances Product', 'Aqua', 'MODIS'),
    _t('MOD021KM', '61/MOD021KM', 'mod_02', 'Terra MODIS Level 1b (1km) Calibrated Radiances Product', 'Terra', 'MODIS'),
    _t('MYD021KM', '61/MYD021KM', 'myd_02', 'Aqua MODIS Level 1b (1km) Calibrated Radiances Product', 'Aqua', 'MODIS'),
    _t('MOD06_L2', '61/MOD06_L2', 'mod_l2', 'Terra MODIS Atmosphere Level 2 Cloud Product', 'Terra', 'MODIS'),
    _t('MYD06_L2', '61/MYD06_L2', 'myd_l2', 'Aqua MODIS Atmosphere Level 2 Cloud Product', 'Aqua', 'MODIS'),
    _t('MOD35_L2', '61/MOD35_L2', 'mod_l2', 'Terra MODIS Atmosphere Level 2 Cloud Mask', 'Terra', 'MODIS'),
    _t('MYD35_L2', '61/MYD35_L2', 'myd_l2', 'Aqua MODIS Atmosphere Level 2 Cloud Mask', 'Aqua', 'MODIS'),
    _t('MOD04_L2', '61/MOD04_L2', 'mod_04', 'Terra MODIS Aerosol 5-Min L2 Swath 10km', 'Terra', 'MODIS'),
    _t('MYD04_L2', '61/MYD04_L2', 'myd_04', 'Aqua MODIS Aerosol 5-Min L2 Swath 10km', 'Aqua', 'MODIS'),
    _t('MYD_CLDMSK_L2', '5110/CLDMSK_L2_MODIS_Aqua', 'myd_cldmsk_l2', 'Aqua MODIS Continuity Cloud Mask (MVCM) 5-Min Swath 1 km', 'Aqua', 'MODIS'),
    _t('AQUA_CLDMSK_L2', '5110/CLDMSK_L2_MODIS_Aqua', 'myd_cldmsk_l2', 'Aqua MODIS Continuity Cloud Mask (MVCM) 5-Min Swath 1 km', 'Aqua', 'MODIS'),
    _t('MOD09', '61/MOD09', 'mod_09', 'Terra MODIS Atmospherically Corrected Surface Reflectance', 'Terra', 'MODIS'),
    _t('MYD09', '61/MYD09', 'myd_09', 'Aqua MODIS Atmospherically Corrected Surface Reflectance', 'Aqua', 'MODIS'),
    _t('MCD43A1', '61/MCD43A1', 'mod_43', 'MODIS BRDF/Albedo Model Parameters Level 3 Product', 'Terra+Aqua', 'MODIS'),
    _t('MCD43A3', '61/MCD43A3', 'mod_43', 'MODIS BRDF/Albedo Level 3 Surface Product', 'Terra+Aqua', 'MODIS'),
    _t('VNP02IMG', '5200/VNP02IMG', 'vnp_02', 'Suomi-NPP VIIRS Level 1b (375m) Calibrated Radiances Product', 'SNPP', 'VIIRS'),
    _t('VJ102IMG', '5201/VJ102IMG', 'vj1_02', 'JPSS1 (NOAA-20) VIIRS Level 1b (375m) Calibrated Radiances Product', 'NOAA20', 'VIIRS'),
    _t('VJ202IMG', '5200/VJ202IMG', 'vj2_02', 'JPSS2 (NOAA-21) VIIRS Level 1b (375m) Calibrated Radiances Product', 'NOAA21', 'VIIRS'),
    _t('VNP02MOD', '5200/VNP02MOD', 'vnp_02', 'Suomi-NPP VIIRS Level 1b (750m) Calibrated Radiances Product', 'SNPP', 'VIIRS'),
    _t('VJ102MOD', '5201/VJ102MOD', 'vj1_02', 'JPSS1 (NOAA-20) VIIRS Level 1b (750m) Calibrated Radiances Product', 'NOAA20', 'VIIRS'),
    _t('VJ202MOD', '5200/VJ202MOD', 'vj2_02', 'JPSS2 (NOAA-21) VIIRS Level 1b (750m) Calibrated Radiances Product', 'NOAA21', 'VIIRS'),
    _t('VNP03IMG', '5200/VNP03IMG', 'vnp_03', 'Suomi-NPP VIIRS (375m) Geolocation Fields Product', 'SNPP', 'VIIRS'),
    _t('VJ103IMG', '5201/VJ103IMG', 'vj1_03', 'JPSS1 (NOAA-20) VIIRS (375m) Geolocation Fields Product', 'NOAA20', 'VIIRS'),
    _t('VJ203IMG', '5200/VJ203IMG', 'vj2_03', 'JPSS2 (NOAA-21) VIIRS (375m) Geolocation Fields Product', 'NOAA21', 'VIIRS'),
    _t('VNP03MOD', '5200/VNP03MOD', 'vnp_03', 'Suomi-NPP VIIRS (750m) Geolocation Fields Product', 'SNPP', 'VIIRS'),
    _t('VJ103MOD', '5201/VJ103MOD', 'vj1_03', 'JPSS1 (NOAA-20) VIIRS (750m) Geolocation Fields Product', 'NOAA20', 'VIIRS'),
    _t('VJ203MOD', '5200/VJ203MOD', 'vj2_03', 'JPSS2 (NOAA-21) VIIRS (750m) Geolocation Fields Product', 'NOAA21', 'VIIRS'),
    _t('VNPRGB', '5200/VNPRGB', 'vnp_rgb', 'Suomi-NPP VIIRS True Color (RGB) Imagery', 'SNPP', 'VIIRS', 'worldview'),
    _t('VJ1RGB', '5201/VJ1RGB', 'vj1_rgb', 'JPSS1 (NOAA-20) VIIRS True Color (RGB) Imagery', 'NOAA20', 'VIIRS', 'worldview'),
    _t('VJ2RGB', '5200/VJ2RGB', 'vj2_rgb', 'JPSS2 (NOAA-21) VIIRS True Color (RGB) Imagery', 'NOAA21', 'VIIRS', 'worldview'),
    _t('VNP_CLDPROP_L2', '5111/CLDPROP_L2_VIIRS_SNPP', 'vnp_l2', 'Suomi-NPP VIIRS Cloud Properties Product', 'SNPP', 'VIIRS'),
    _t('VJ1_CLDPROP_L2', '5111/CLDPROP_L2_VIIRS_NOAA20', 'vj1_l2', 'JPSS1 (NOAA-20) VIIRS Cloud Properties Product', 'NOAA20', 'VIIRS'),
    _t('CLDPROP_L2_VIIRS_SNPP', '5111/CLDPROP_L2_VIIRS_SNPP', 'vnp_l2', 'Suomi-NPP VIIRS Cloud Properties Product', 'SNPP', 'VIIRS'),
    _t('VNP_CLDMSK_L2', '5110/CLDMSK_L2_VIIRS_SNPP', 'vnp_cldmsk_l2', 'SNPP VIIRS Continuity Cloud Mask (MVCM) 6-Min Swath 750 m', 'SNPP', 'VIIRS'),
    _t('VJ1_CLDMSK_L2', '5110/CLDMSK_L2_VIIRS_NOAA20', 'vj1_cldmsk_l2', 'NOAA20 (JPSS1) VIIRS Continuity Cloud Mask (MVCM) 6-Min Swath 750 m', 'NOAA20', 'VIIRS'),
    _t('VJ2_CLDMSK_L2', '5110/CLDMSK_L2_VIIRS_NOAA21', 'vj2_cldmsk_l2', 'NOAA21 (JPSS2) VIIRS Continuity Cloud Mask (MVCM) 6-Min Swath 750 m', 'NOAA21', 'VIIRS'),
    _t('VNP09', '5200/VNP09', 'vnp_09', 'Suomi-NPP VIIRS Atmospherically Corrected Surface Reflectance Product', 'SNPP', 'VIIRS'),
    _t('VJ109', '5200/VJ109', 'vj1_09', 'JPSS1 (NOAA-20) Atmospherically Corrected Surface Reflectance Product', 'NOAA20', 'VIIRS'),
    _t('MOD29', '61/MOD29', 'mod_29', 'MODIS/Terra Sea Ice Extent 5-Min L2 Swath 1km', 'Terra', 'MODIS', 'nsidc'),
    _t('MYD29', '61/MYD29', 'myd_29', 'MODIS/Aqua Sea Ice Extent 5-Min L2 Swath 1km', 'Aqua', 'MODIS', 'nsidc'),
    _t('MOD29_NRT', '61/MOD29', 'mod_29', 'MODIS/Terra Sea Ice Extent 5-Min L2 Swath 1km (NRT)', 'Terra', 'MODIS', 'lance'),
    _t('MYD29_NRT', '61/MYD29', 'myd_29', 'MODIS/Aqua Sea Ice Extent 5-Min L2 Swath 1km (NRT)', 'Aqua', 'MODIS', 'lance'),
    _t('oco2_L1bScND', 'OCO2_L1B_Science.11r', 'oco_l1b', 'OCO-2 L1B Calibrated Radiances Product', 'OCO-2', 'OCO-2', 'gesdisc'),
    _t('oco2_L2MetND', 'OCO2_L2_Met.11r', 'oco_met_l2', 'OCO-2 L2 Meteorological Parameters Product', 'OCO-2', 'OCO-2', 'gesdisc'),
    _t('oco2_L2StdND', 'OCO2_L2_Standard.11r', 'oco_ret_l2', 'OCO-2 L2 XCO2 Retrieval Product', 'OCO-2', 'OCO-2', 'gesdisc'),
])

_LAADS = 'https://ladsweb.modaps.eosdis.nasa.gov'


def earthdata_token() -> str | None:
    """EARTHDATA_TOKEN from the environment (reference: daac.py:61-111)."""
    return os.environ.get('EARTHDATA_TOKEN')


def geometa_url(product: str, date: datetime.date) -> str:
    """geoMeta CSV listing URL for a product/day."""
    tag = SAT_TAGS.get(product, {'archive': '61'})
    sat = {'Terra': 'TERRA', 'Aqua': 'AQUA', 'SNPP': 'NPP',
           'NOAA20': 'NOAA-20', 'NOAA21': 'NOAA-21'}.get(
        tag.get('sat', 'Terra'), 'TERRA')
    coll = '61' if tag['archive'] == '61' else tag['archive']
    return (f'{_LAADS}/archive/geoMeta/{coll}/{sat}/{date:%Y}/'
            f'{product}_{date:%Y-%m-%d}.txt')


def parse_geometa(text: str):
    """Parse a geoMeta CSV into a structured list of granule records.

    Columns: GranuleID, StartDateTime, ..., GRingLongitude1..4,
    GRingLatitude1..4 (reference parsing: daac.py:676-971).
    """
    rows = []
    header = None
    for line in io.StringIO(text):
        line = line.strip()
        if not line:
            continue
        if line.startswith('#'):
            header = [h.strip() for h in line.lstrip('#').split(',')]
            continue
        parts = [p.strip() for p in line.split(',')]
        if header is None or len(parts) < len(header):
            continue
        rec = dict(zip(header, parts))
        try:
            lons = [float(rec[f'GRingLongitude{i}']) for i in range(1, 5)]
            lats = [float(rec[f'GRingLatitude{i}']) for i in range(1, 5)]
        except (KeyError, ValueError):
            continue
        rows.append({'granule': rec.get('GranuleID', ''),
                     'start': rec.get('StartDateTime', ''),
                     'ring_lon': lons, 'ring_lat': lats,
                     'day_night': rec.get('DayNightFlag', '')})
    return rows


def _unwrap_ring(ring_lon):
    """Shift G-ring longitudes into one continuous frame across the
    dateline (reference role: the geoMeta projection helpers,
    daac.py:676-971, which re-project swaths that straddle +-180)."""
    out = [ring_lon[0]]
    for x in ring_lon[1:]:
        prev = out[-1]
        while x - prev > 180.0:
            x -= 360.0
        while x - prev < -180.0:
            x += 360.0
        out.append(x)
    return out


def _point_in_ring(lon, lat, ring_lon, ring_lat):
    """Even-odd point-in-polygon of a swath G-ring, dateline-safe."""
    ring_lon = _unwrap_ring(list(ring_lon))
    lo = min(ring_lon)
    # bring the query longitude into the ring's frame: [lo, lo + 360)
    lon = lo + (lon - lo) % 360.0
    inside = False
    n = len(ring_lon)
    j = n - 1
    for i in range(n):
        xi, yi = ring_lon[i], ring_lat[i]
        xj, yj = ring_lon[j], ring_lat[j]
        if (yi > lat) != (yj > lat):
            x_int = (xj - xi) * (lat - yi) / (yj - yi) + xi
            if lon < x_int:
                inside = not inside
        j = i
    return inside


def granules_over_extent(product, date, extent, geometa_text=None,
                         day_only=True, n_sample=5):
    """Granules whose swath covers part of ``extent`` (lon0, lon1, lat0,
    lat1), with the covered fraction of an n_sample x n_sample grid
    (reference role: swath-polygon geometa search, daac.py:676-971).

    Returns the matched records sorted by descending coverage, each with a
    'coverage' key in [0, 1].
    """
    if geometa_text is None:
        geometa_text = _fetch_geometa(product, date)
    lon0, lon1, lat0, lat1 = extent
    gl = np.linspace(lon0, lon1, n_sample)
    gt = np.linspace(lat0, lat1, n_sample)
    out = []
    for rec in parse_geometa(geometa_text):
        if day_only and rec['day_night'] not in ('', 'D', 'B'):
            continue
        hit = sum(_point_in_ring(x, y, rec['ring_lon'], rec['ring_lat'])
                  for x in gl for y in gt)
        if hit:
            out.append({**rec, 'coverage': hit / (n_sample * n_sample)})
    return sorted(out, key=lambda r: -r['coverage'])


def swath_lonlat_utc(rec, nx=64, ny=64):
    """(lon, lat, utc_hours) grids bilinearly spanned by a granule's G-ring
    (reference role: cal_lon_lat_utc_geometa, daac.py:676-971): corner 1-2
    is the first scanline, 4-3 the last; UTC advances linearly along track
    from the granule's StartDateTime."""
    rl = _unwrap_ring(list(rec['ring_lon']))
    rt = rec['ring_lat']
    u = np.linspace(0.0, 1.0, nx)[:, None]    # across track
    v = np.linspace(0.0, 1.0, ny)[None, :]    # along track
    def bil(q):
        return ((1 - u) * (1 - v) * q[0] + u * (1 - v) * q[1]
                + u * v * q[2] + (1 - u) * v * q[3])
    lon = bil(rl)
    lon = (lon + 180.0) % 360.0 - 180.0
    lat = bil(rt)
    try:
        hh = float(rec['start'][11:13]) + float(rec['start'][14:16]) / 60.0
    except (ValueError, IndexError):
        hh = 0.0
    utc = hh + np.broadcast_to(v, lon.shape) * (5.0 / 60.0)  # 5-min granule
    return lon, lat, utc


def _fetch_geometa(product, date):
    import requests
    headers = {}
    tok = earthdata_token()
    if tok:
        headers['Authorization'] = f'Bearer {tok}'
    r = requests.get(geometa_url(product, date), headers=headers, timeout=60)
    r.raise_for_status()
    return r.text


def find_granules(product: str, date: datetime.date, lon: float, lat: float,
                  geometa_text: str | None = None, day_only=True):
    """Granules of a product/day whose swath G-ring contains (lon, lat).

    Pass ``geometa_text`` to search offline; otherwise the geoMeta listing
    is fetched (requires network + token).
    """
    if geometa_text is None:
        geometa_text = _fetch_geometa(product, date)
    out = []
    for rec in parse_geometa(geometa_text):
        if day_only and rec['day_night'] not in ('', 'D', 'B'):
            continue
        if _point_in_ring(lon, lat, rec['ring_lon'], rec['ring_lat']):
            out.append(rec)
    return out


def granule_url(product: str, date: datetime.date, granule: str) -> str:
    tag = SAT_TAGS.get(product, {'archive': '61'})
    doy = date.timetuple().tm_yday
    return (f'{_LAADS}/archive/allData/{tag["archive"]}/{product}/'
            f'{date:%Y}/{doy:03d}/{granule}')


def download_url(url: str, fdir_out: str, token: str | None = None,
                 min_size: int = 1024, overwrite=False, retries: int = 3,
                 backoff: float = 2.0, validate=False,
                 _get=None) -> str:
    """Download with bearer-token auth, size sanity check, retry with
    exponential backoff and optional content validation (reference:
    retry/size logic at daac.py:352 + final_file_check daac.py:498).

    ``_get``: injection point for the HTTP getter (offline tests).
    """
    import time
    if _get is None:
        import requests

        def _get(u, headers):
            r = requests.get(u, headers=headers, stream=True, timeout=300)
            r.raise_for_status()
            return r.iter_content(1 << 20)

    os.makedirs(fdir_out, exist_ok=True)
    fname = os.path.join(fdir_out, url.rsplit('/', 1)[-1])
    if os.path.exists(fname) and not overwrite and os.path.getsize(fname) > min_size:
        return fname
    headers = {}
    tok = token or earthdata_token()
    if tok:
        headers['Authorization'] = f'Bearer {tok}'
    last_err = None
    for attempt in range(max(retries, 1)):
        try:
            with open(fname, 'wb') as fo:
                for chunk in _get(url, headers):
                    fo.write(chunk)
            if os.path.getsize(fname) < min_size:
                raise IOError(f'downloaded file too small: {url}')
            if validate and not final_file_check(fname):
                raise IOError(f'downloaded file failed validation: {url}')
            return fname
        except Exception as e:            # noqa: BLE001 — retried
            last_err = e
            if os.path.exists(fname):
                os.remove(fname)
            if attempt + 1 < max(retries, 1):
                time.sleep(backoff * (2 ** attempt))
    raise IOError(f'download failed after {retries} attempts: {url}') \
        from last_err


def download_laads_https(date: datetime.date, product: str, lon: float,
                         lat: float, fdir_out='.', token=None):
    """Search geoMeta for granules over a point and download them
    (reference: download_laads_https, daac.py:1273)."""
    grans = find_granules(product, date, lon, lat)
    return [download_url(granule_url(product, date, g['granule']), fdir_out,
                         token=token) for g in grans]


def worldview_image_url(date: datetime.date, extent, layer='MODIS_Terra_CorrectedReflectance_TrueColor',
                        dpm=100):
    """NASA Worldview snapshot URL (reference: download_worldview_image,
    daac.py:1767)."""
    lon0, lon1, lat0, lat1 = extent
    w = int(abs(lon1 - lon0) * dpm)
    h = int(abs(lat1 - lat0) * dpm)
    return ('https://wvs.earthdata.nasa.gov/api/v1/snapshot?request=GetSnapshot'
            f'&time={date:%Y-%m-%d}&bbox={lat0},{lon0},{lat1},{lon1}'
            f'&layers={layer}&format=image/png&width={w}&height={h}')


def worldview_image_fname(product: str, date_or_dtime, extent,
                          fdir_out='.') -> str:
    """Time-stamped local filename for a Worldview snapshot (the reference
    stamps the satellite overpass time into the image name,
    daac.py:1767): e.g. MODRGB_2019-08-25-1830Z_(-61.00,-59.00,14.00,16.00).png."""
    if isinstance(date_or_dtime, datetime.datetime):
        stamp = f'{date_or_dtime:%Y-%m-%d-%H%MZ}'
    else:
        stamp = f'{date_or_dtime:%Y-%m-%d}'
    ext_s = '(' + ','.join(f'{v:.2f}' for v in extent) + ')'
    return os.path.join(fdir_out, f'{product}_{stamp}_{ext_s}.png')


def download_worldview_image(date_or_dtime, extent, product='MODRGB',
                             fdir_out='.', dpm=100, run=True, _get=None):
    """Download a time-stamped Worldview snapshot over ``extent``
    (reference download_worldview_image, daac.py:1767); run=False returns
    (url, fname) without touching the network."""
    tag = SAT_TAGS.get(product, SAT_TAGS['MODRGB'])
    layer = {'MODIS': f'MODIS_{tag["satellite"]}_CorrectedReflectance_TrueColor',
             'VIIRS': f'VIIRS_{tag["satellite"]}_CorrectedReflectance_TrueColor',
             }.get(tag['instrument'],
                   'MODIS_Terra_CorrectedReflectance_TrueColor')
    date = date_or_dtime.date() if isinstance(date_or_dtime, datetime.datetime) \
        else date_or_dtime
    url = worldview_image_url(date, extent, layer=layer, dpm=dpm)
    fname = worldview_image_fname(product, date_or_dtime, extent, fdir_out)
    if not run:
        return url, fname
    out = download_url(url, fdir_out, min_size=128, _get=_get)
    os.replace(out, fname)
    return url, fname


def lance_url(date: datetime.date, dataset_tag: str, granule: str,
              server='https://nrt3.modaps.eosdis.nasa.gov',
              fdir_prefix='/archives/allData') -> str:
    """LANCE near-real-time archive URL (reference download_lance_https,
    daac.py:1390): dataset_tag like '61/MYD06_L2'."""
    doy = date.timetuple().tm_yday
    return f'{server}{fdir_prefix}/{dataset_tag}/{date.year}/{doy:03d}/{granule}'


def download_lance_https(date: datetime.date, dataset_tag: str,
                         filename_tag: str, lon=0.0, lat=0.0, fdir_out='.',
                         token=None, geometa_text=None, run=True):
    """Download LANCE NRT granules over (lon, lat) matching a filename tag;
    with run=False returns the target URLs only (offline-testable with
    ``geometa_text``)."""
    product = dataset_tag.split('/')[-1]
    grans = find_granules(product, date, lon, lat, geometa_text=geometa_text)
    urls = [lance_url(date, dataset_tag, g['granule']) for g in grans
            if filename_tag in g['granule']]
    if not run:
        return urls
    return [download_url(u, fdir_out, token=token) for u in urls]


def nsidc_url(date: datetime.date, product: str, version: str, granule: str,
              server='https://n5eil01u.ecs.nsidc.org') -> str:
    """NSIDC archive URL (reference download_nsidc_https, daac.py:1514):
    e.g. product 'MOD29', version '61'."""
    sat_dir = {'MOD': 'MOST', 'MYD': 'MOSA', 'VNP': 'VIIRS',
               'VJ1': 'VIIRS'}.get(granule[:3], 'MOST')
    return (f'{server}/{sat_dir}/{product}.{version.zfill(3)}/'
            f'{date:%Y.%m.%d}/{granule}')


def oco2_url(dtime: datetime.datetime, dataset_tag: str, granule: str,
             server='https://oco2.gesdisc.eosdis.nasa.gov',
             fdir_prefix='/data/OCO2_DATA') -> str:
    """OCO-2 GES DISC archive URL (reference download_oco2_https,
    daac.py:1629): dataset_tag like 'OCO2_L2_Standard.11r'."""
    doy = dtime.timetuple().tm_yday
    return (f'{server}{fdir_prefix}/{dataset_tag}/{dtime.year}/{doy:03d}/'
            f'{granule}')


def list_remote_dir(url: str, token: str | None = None,
                    html_text: str | None = None) -> list:
    """File names listed on an HTTPS archive index page.

    The reference's NSIDC/OCO-2 downloaders scrape the server directory
    listing to discover granule names (daac.py:1560-1610, 1700-1720); this
    is the shared scraper.  ``html_text`` injects a page for offline tests.
    """
    import re
    if html_text is None:
        import requests
        headers = {}
        tok = token or earthdata_token()
        if tok:
            headers['Authorization'] = f'Bearer {tok}'
        r = requests.get(url, headers=headers, timeout=120)
        r.raise_for_status()
        html_text = r.text
    names = re.findall(r'href="([^"?/][^"?]*)"', html_text)
    # drop navigation links and duplicates, keep order
    seen, out = set(), []
    for n in names:
        if n.startswith(('..', 'http', '#')) or n.endswith('/'):
            continue
        if n not in seen:
            seen.add(n)
            out.append(n)
    return out


def _granule_hhmm(name: str):
    """datetime.time from an .AYYYYDDD.HHMM. style granule name, else None."""
    import re
    m = re.search(r'\.A\d{7}\.(\d{2})(\d{2})\.', name)
    if m:
        return datetime.time(int(m.group(1)), int(m.group(2)))
    return None


def download_nsidc_https(date, extent=None, product_dict=None,
                         filename_tags=None, fdir_out='tmp-data',
                         data_format=None, run=True, start_dt_hhmm=None,
                         end_dt_hhmm=None, token=None, html_text=None,
                         server='https://n5eil01u.ecs.nsidc.org'):
    """Download NSIDC granules for a date (reference download_nsidc_https,
    daac.py:1514-1628): list the archive day directory, filter by filename
    tags / format / acquisition-time window, download + validity-check.
    ``run=False`` returns the target URLs (offline with ``html_text``).

    ``product_dict``: {'short_name': e.g. 'MOD29', 'version': '61'}.
    """
    import os
    product_dict = product_dict or {'short_name': 'MOD29', 'version': '61'}
    short = product_dict['short_name']
    version = str(product_dict.get('version', '61'))
    sat_dir = {'MOD': 'MOST', 'MYD': 'MOSA', 'VNP': 'VIIRS',
               'VJ1': 'VIIRS'}.get(short[:3], 'MOST')
    dir_url = (f'{server}/{sat_dir}/{short}.{version.zfill(3)}/'
               f'{date:%Y.%m.%d}/')
    names = list_remote_dir(dir_url, token=token, html_text=html_text)
    if isinstance(filename_tags, str):
        filename_tags = [filename_tags]
    picked = []
    for n in names:
        if data_format and not n.endswith(data_format.lstrip('.')):
            continue
        if filename_tags and not all(t in n for t in filename_tags):
            continue
        t = _granule_hhmm(n)
        if t is not None and (start_dt_hhmm or end_dt_hhmm):
            t0 = start_dt_hhmm.time() if start_dt_hhmm else datetime.time(0, 0)
            t1 = end_dt_hhmm.time() if end_dt_hhmm else datetime.time(23, 59)
            if not (t0 <= t <= t1):
                continue
        picked.append(n)
    urls = [dir_url + n for n in picked]
    if not run:
        return urls
    os.makedirs(fdir_out, exist_ok=True)
    out = []
    for u in urls:
        fn = download_url(u, fdir_out, token=token)
        if fn and final_file_check(fn, data_format=data_format):
            out.append(fn)
    return out


_OCO2_DEEP_TAGS = ('OCO2_L2_Met', 'OCO2_L2_Standard', 'OCO2_L1B_Science',
                   'OCO2_L1B_Calibration', 'OCO2_L2_CO2Prior',
                   'OCO2_L2_IMAPDOAS', 'OCO2_L2_Diagnostic')
_OCO2_LITE_TAGS = ('OCO2_L2_Lite_FP', 'OCO2_L2_Lite_SIF')


def download_oco2_https(dtime, dataset_tag, fnames=None,
                        server='https://oco2.gesdisc.eosdis.nasa.gov',
                        fdir_prefix='/data/OCO2_DATA', fdir_out='tmp-data',
                        data_format=None, run=True, token=None,
                        html_text=None):
    """Download OCO-2 granules (reference download_oco2_https,
    daac.py:1629-1766): the deep products live under year/doy directories,
    the Lite products under year only; files are discovered from the server
    listing and filtered by format.  ``fnames`` restricts to specific
    granule names; ``run=False`` returns URLs (offline with ``html_text``).
    """
    import os
    year = f'{dtime.year:04d}'
    doy = f'{dtime.timetuple().tm_yday:03d}'
    base = dataset_tag.split('.')[0]
    if base in _OCO2_DEEP_TAGS:
        fdir_data = f'{fdir_prefix}/{dataset_tag}/{year}/{doy}'
    elif base in _OCO2_LITE_TAGS:
        fdir_data = f'{fdir_prefix}/{dataset_tag}/{year}'
    else:
        raise ValueError(
            f'download_oco2_https: unsupported dataset {dataset_tag!r}')
    dir_url = f'{server}{fdir_data}/'
    names = list_remote_dir(dir_url, token=token, html_text=html_text)
    picked = []
    for n in names:
        if n.endswith('.xml'):
            continue
        if data_format and not n.endswith(data_format.lstrip('.')):
            continue
        if fnames and n not in fnames:
            continue
        picked.append(n)
    urls = [dir_url + n for n in picked]
    if not run:
        return urls
    os.makedirs(fdir_out, exist_ok=True)
    out = []
    for u in urls:
        fn = download_url(u, fdir_out, token=token)
        if fn and final_file_check(fn, data_format=data_format):
            out.append(fn)
    return out


def final_file_check(fname: str, data_format=None, verbose=False) -> bool:
    """Post-download validity check (reference final_file_check,
    daac.py:498): non-empty + openable by the matching backend."""
    import os
    if not os.path.isfile(fname) or os.path.getsize(fname) == 0:
        return False
    fmt = data_format or fname.rsplit('.', 1)[-1].lower()
    try:
        if fmt in ('h5', 'he5', 'hdf5', 'nc', 'nc4', 'hdf', 'h4'):
            from ..util.ncio import open_any
            open_any(fname).close()
        elif fmt == 'out':
            from scipy.io import readsav
            readsav(fname)
        return True
    except Exception as e:
        if verbose:
            print(f'final_file_check: {fname}: {e}')
        return False

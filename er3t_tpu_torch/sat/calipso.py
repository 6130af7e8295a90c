"""CALIPSO lidar Vertical Feature Mask (VFM) utilities.

A copy of ``er3t_tpu/sat/calipso.py`` (:1-146), function for function; its
relative imports resolve to the port's own ``util`` and ``sat`` modules.

Counterpart of the reference's ``er3t/dev/calipso.py`` (CMR granule search,
VFM block decoding after NASA VOCAL, altitude regridding, reader).  The VFM
packs each 5-km record as 5515 samples spanning three altitude regimes; the
decode follows the CALIPSO data-summary layout.
"""

from __future__ import annotations

import datetime

import numpy as np

__all__ = ['cmr_vfm_search_url', 'vfm_row2block', 'vfm_altitude',
           'extract_type', 'uniform_alt', 'regrid_lidar', 'read_calipso_vfm',
           'VFM_TYPES']

_CONCEPT_IDS = {
    'v4-51': 'C2667982867-LARC_ASDC',
    'v4-20': 'C1556717900-LARC_ASDC',
    'v4-21': 'C1978624326-LARC_ASDC',
}

VFM_TYPES = {0: 'invalid', 1: 'clear air', 2: 'cloud',
             3: 'tropospheric aerosol', 4: 'stratospheric aerosol',
             5: 'surface', 6: 'subsurface', 7: 'no signal'}

# altitude regimes (km): (n_bins, dz, z_top) per the VFM layout
_HIGH = (55, 0.180, 30.1)     # 20.2 .. 30.1 km
_MID = (200, 0.060, 20.2)     # 8.2 .. 20.2 km
_LOW = (290, 0.030, 8.2)      # -0.5 .. 8.2 km


def cmr_vfm_search_url(date: datetime.date, extent, version='v4-51',
                       n_results=49) -> str:
    """Earthdata CMR OpenSearch URL for VFM granules over a bbox
    (reference get_calipso_vfm_rel, calipso.py:22-106)."""
    if version not in _CONCEPT_IDS:
        raise ValueError(f'unsupported VFM version {version!r}')
    lon_w, lon_e, lat_s, lat_n = extent
    lon_w = ((lon_w + 180.0) % 360.0) - 180.0
    lon_e = ((lon_e + 180.0) % 360.0) - 180.0
    return ('https://cmr.earthdata.nasa.gov/opensearch/granules?utf8=%E2%9C%93&'
            f'parentIdentifier={_CONCEPT_IDS[version]}&'
            f'startTime={date:%Y-%m-%d}T00%3A00%3A00Z&'
            f'endTime={date:%Y-%m-%d}T23%3A59%3A59Z&'
            f'spatial_type=bbox&boundingBox={lon_w:.2f}%2C{lat_s:.2f}%2C'
            f'{lon_e:.2f}%2C{lat_n:.2f}&'
            f'numberOfResults={n_results}&commit=Search')


def vfm_altitude() -> np.ndarray:
    """Non-uniform VFM altitude array [km], descending resolution blocks
    stacked top-down (high 180 m / mid 60 m / low 30 m)."""
    zs = []
    for n, dz, z_top in (_HIGH, _MID, _LOW):
        zs.append(z_top - dz * (np.arange(n) + 0.5))
    return np.concatenate(zs)


def vfm_row2block(vfm_row: np.ndarray) -> np.ndarray:
    """One 5515-sample VFM record -> (545, 15) altitude x along-track block
    (reference vfm_row2block, calipso.py:174-255, after NASA VOCAL).

    Higher-altitude regimes are horizontally oversampled: the 55-bin block
    repeats each profile 5x, the 200-bin block 3x, the 290-bin block is at
    native single-shot resolution.
    """
    vfm_row = np.asarray(vfm_row).ravel()
    if vfm_row.size != 5515:
        raise ValueError(f'VFM record must have 5515 samples, got {vfm_row.size}')
    n_hi, n_mid, n_low = _HIGH[0], _MID[0], _LOW[0]
    block = np.ones((n_hi + n_mid + n_low, 15), dtype=vfm_row.dtype)
    for i in range(3):                       # 20.2-30.1 km: 3 profiles x5
        prof = vfm_row[i * n_hi:(i + 1) * n_hi]
        block[:n_hi, 5 * i:5 * i + 5] = prof[:, None]
    off = 3 * n_hi
    for i in range(5):                       # 8.2-20.2 km: 5 profiles x3
        prof = vfm_row[off + i * n_mid:off + (i + 1) * n_mid]
        block[n_hi:n_hi + n_mid, 3 * i:3 * i + 3] = prof[:, None]
    off = 3 * n_hi + 5 * n_mid
    for i in range(15):                      # -0.5-8.2 km: 15 profiles
        block[n_hi + n_mid:, i] = vfm_row[off + i * n_low:off + (i + 1) * n_low]
    return block


def extract_type(vfm_array: np.ndarray) -> np.ndarray:
    """Feature type = bits 1-3 of the classification flag (reference
    extract_type, calipso.py:256-274): see VFM_TYPES."""
    return np.asarray(vfm_array).astype(np.uint16) & 7


def uniform_alt(max_altitude: float, old_altitude: np.ndarray) -> np.ndarray:
    """Uniform altitude grid at the finest (lowest-block) resolution up to
    ``max_altitude`` (reference uniform_alt_2, calipso.py:276-319)."""
    dz = _LOW[1]
    new_alt = np.arange(old_altitude.min(), max_altitude + dz / 2, dz)
    return new_alt


def regrid_lidar(alt: np.ndarray, in_matrix: np.ndarray,
                 new_alt: np.ndarray) -> np.ndarray:
    """Nearest-neighbor regrid of a (Nz, Nx) lidar curtain onto ``new_alt``
    (reference regrid_lidar, calipso.py:321-349)."""
    alt = np.asarray(alt)
    order = np.argsort(alt)
    idx = np.clip(np.searchsorted(alt[order], new_alt), 0, alt.size - 1)
    lo = np.clip(idx - 1, 0, alt.size - 1)
    pick = np.where(np.abs(alt[order][idx] - new_alt)
                    <= np.abs(alt[order][lo] - new_alt), idx, lo)
    return np.asarray(in_matrix)[order[pick], :]


def read_calipso_vfm(fname, extent=None):
    """Read a LID_L2_VFM granule: returns dict with lon/lat/type curtain on
    the uniform altitude grid (reference read_calipso_vfm, calipso.py:350)."""
    from ..util.ncio import open_any
    f = open_any(fname)
    try:
        lon, _ = f.var('Longitude')
        lat, _ = f.var('Latitude')
        fcf, _ = f.var('Feature_Classification_Flags')
    finally:
        f.close()
    lon = np.asarray(lon).ravel()
    lat = np.asarray(lat).ravel()
    fcf = np.asarray(fcf)
    sel = np.ones(lon.size, bool)
    if extent is not None:
        sel = ((lon >= extent[0]) & (lon <= extent[1]) &
               (lat >= extent[2]) & (lat <= extent[3]))
    alt = vfm_altitude()
    blocks = [extract_type(vfm_row2block(fcf[i]))
              for i in np.where(sel)[0]]
    curtain = np.concatenate(blocks, axis=1) if blocks else \
        np.zeros((alt.size, 0), np.uint16)
    new_alt = uniform_alt(20.0, alt)
    curtain_u = regrid_lidar(alt, curtain, new_alt) if curtain.size else curtain
    return {
        'lon': {'data': lon[sel], 'name': 'Longitude', 'units': 'deg'},
        'lat': {'data': lat[sel], 'name': 'Latitude', 'units': 'deg'},
        'altitude': {'data': new_alt, 'name': 'Altitude', 'units': 'km'},
        'feature_type': {'data': curtain_u, 'name':
                         'VFM feature type (0..7, see VFM_TYPES)'},
    }

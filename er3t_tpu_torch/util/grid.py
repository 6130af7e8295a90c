"""Gridding and resampling helpers (NumPy copy of ``er3t_tpu/util/grid.py``,
whole: ``downscale`` :17-35, ``downscale_3d`` :38-39, ``upscale_2d`` :42-44,
``find_nearest`` :47-50, ``get_lay_index`` :53-57, ``combine_alt`` :60-65,
``_grid_core`` :68-85, ``grid_by_extent`` :88-102, ``grid_by_lonlat``
:105-129, ``grid_by_dxdy`` :132-145).

Capability parity with the reference's array utilities
(er3t/util/util.py:384-880): block coarsening/upscaling, nearest-index
search, swath-to-grid resampling, and layer-index mapping.
"""

from __future__ import annotations

import numpy as np

__all__ = ['downscale_3d', 'downscale', 'upscale_2d', 'find_nearest',
           'get_lay_index', 'combine_alt', 'grid_by_dxdy', 'grid_by_extent',
           'grid_by_lonlat']


def downscale(data: np.ndarray, new_shape, operation: str = 'mean') -> np.ndarray:
    """Block-reduce an array to ``new_shape`` (each dim must divide evenly)."""
    data = np.asarray(data)
    if data.ndim != len(new_shape):
        raise ValueError('rank mismatch')
    pairs = []
    for old, new in zip(data.shape, new_shape):
        if old % new:
            raise ValueError(f'{old} not divisible by {new}')
        pairs.extend([new, old // new])
    out = data.reshape(pairs)
    axes = tuple(range(1, 2 * len(new_shape), 2))
    if operation == 'mean':
        return out.mean(axis=axes)
    if operation == 'sum':
        return out.sum(axis=axes)
    if operation == 'max':
        return out.max(axis=axes)
    raise ValueError(operation)


def downscale_3d(data, new_shape):
    return downscale(data, new_shape, 'mean')


def upscale_2d(data: np.ndarray, scale=(2, 2)) -> np.ndarray:
    """Repeat each cell (sx, sy) times (reference: util.py:857-880)."""
    return np.repeat(np.repeat(np.asarray(data), scale[0], axis=0), scale[1], axis=1)


def find_nearest(array, value):
    """Index of the nearest element (reference: util.py:384)."""
    array = np.asarray(array)
    return int(np.abs(array - value).argmin())


def get_lay_index(z_query: np.ndarray, z_grid: np.ndarray) -> np.ndarray:
    """Nearest layer index in ``z_grid`` for each query altitude
    (reference: util.py:816-833)."""
    z_query = np.atleast_1d(z_query)
    return np.abs(z_query[:, None] - np.asarray(z_grid)[None, :]).argmin(axis=1)


def combine_alt(alt_base: np.ndarray, alt_extra: np.ndarray, tol=1e-6) -> np.ndarray:
    """Merge and sort two altitude grids, dropping near-duplicates
    (reference: util.py:786-814)."""
    merged = np.sort(np.concatenate([np.asarray(alt_base), np.asarray(alt_extra)]))
    keep = np.concatenate([[True], np.diff(merged) > tol])
    return merged[keep]


def _grid_core(lon, lat, data, lon_edges, lat_edges):
    """Bin-average irregular samples onto a regular lon/lat grid."""
    lon = np.asarray(lon).ravel()
    lat = np.asarray(lat).ravel()
    data = np.asarray(data, dtype=np.float64).ravel()
    ok = np.isfinite(lon) & np.isfinite(lat) & np.isfinite(data)
    lon, lat, data = lon[ok], lat[ok], data[ok]
    nlon, nlat = lon_edges.size - 1, lat_edges.size - 1
    ix = np.clip(np.searchsorted(lon_edges, lon) - 1, 0, nlon - 1)
    iy = np.clip(np.searchsorted(lat_edges, lat) - 1, 0, nlat - 1)
    inside = (lon >= lon_edges[0]) & (lon <= lon_edges[-1]) & \
             (lat >= lat_edges[0]) & (lat <= lat_edges[-1])
    flat = ix[inside] * nlat + iy[inside]
    ssum = np.bincount(flat, weights=data[inside], minlength=nlon * nlat)
    cnt = np.bincount(flat, minlength=nlon * nlat)
    with np.errstate(invalid='ignore'):
        grid = np.where(cnt > 0, ssum / np.maximum(cnt, 1), np.nan)
    return grid.reshape(nlon, nlat)


def grid_by_extent(lon, lat, data, extent, nx=None, ny=None):
    """Average swath samples onto a regular grid over ``extent``
    = (lon0, lon1, lat0, lat1) (reference: util.py:480-560)."""
    lon0, lon1, lat0, lat1 = extent
    if nx is None:
        nx = max(int(round((lon1 - lon0) * 100)), 1)
    if ny is None:
        ny = max(int(round((lat1 - lat0) * 100)), 1)
    lon_e = np.linspace(lon0, lon1, nx + 1)
    lat_e = np.linspace(lat0, lat1, ny + 1)
    grid = _grid_core(lon, lat, data, lon_e, lat_e)
    lon_c = 0.5 * (lon_e[1:] + lon_e[:-1])
    lat_c = 0.5 * (lat_e[1:] + lat_e[:-1])
    lon2d, lat2d = np.meshgrid(lon_c, lat_c, indexing='ij')
    return lon2d, lat2d, grid


def grid_by_lonlat(lon, lat, data, lon_1d, lat_1d):
    """Average onto cell centres given by 1D lon/lat arrays
    (reference: util.py:561-660).

    Descending axes (common for satellite L3 grids, north-first latitude)
    are binned on the flipped ascending grid and flipped back —
    np.searchsorted on decreasing edges would silently return garbage
    bins."""
    lon_1d = np.asarray(lon_1d)
    lat_1d = np.asarray(lat_1d)
    flip_x = lon_1d.size > 1 and lon_1d[1] < lon_1d[0]
    flip_y = lat_1d.size > 1 and lat_1d[1] < lat_1d[0]
    lx = lon_1d[::-1] if flip_x else lon_1d
    ly = lat_1d[::-1] if flip_y else lat_1d
    dlon = np.diff(lx).mean()
    dlat = np.diff(ly).mean()
    lon_e = np.concatenate([lx - dlon / 2, [lx[-1] + dlon / 2]])
    lat_e = np.concatenate([ly - dlat / 2, [ly[-1] + dlat / 2]])
    grid = _grid_core(lon, lat, data, lon_e, lat_e)
    if flip_x:
        grid = grid[::-1, :]
    if flip_y:
        grid = grid[:, ::-1]
    lon2d, lat2d = np.meshgrid(lon_1d, lat_1d, indexing='ij')
    return lon2d, lat2d, grid


def grid_by_dxdy(lon, lat, data, extent=None, dx_km=0.25, dy_km=0.25):
    """Average onto a grid of approximately (dx, dy) km cells
    (reference: util.py:661-742)."""
    lon = np.asarray(lon)
    lat = np.asarray(lat)
    if extent is None:
        extent = (np.nanmin(lon), np.nanmax(lon), np.nanmin(lat), np.nanmax(lat))
    lon0, lon1, lat0, lat1 = extent
    lat_mid = 0.5 * (lat0 + lat1)
    km_per_deg_lat = 111.32
    km_per_deg_lon = km_per_deg_lat * np.cos(np.deg2rad(lat_mid))
    nx = max(int(round((lon1 - lon0) * km_per_deg_lon / dx_km)), 1)
    ny = max(int(round((lat1 - lat0) * km_per_deg_lat / dy_km)), 1)
    return grid_by_extent(lon, lat, data, extent, nx=nx, ny=ny)

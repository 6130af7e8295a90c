"""Geodesic helpers on the WGS84 ellipsoid.

A copy of ``er3t_tpu/util/geo.py`` (:1-111), function for function.

Counterparts of the reference's cartopy-backed ``cal_geodesic_dist`` /
``cal_geodesic_lonlat`` / ``parse_geojson``
(reference er3t/util/util.py:1174-1240), implemented with Vincenty's
inverse/direct formulae (mm-level on WGS84) so no cartopy is needed.
"""

from __future__ import annotations

import numpy as np

__all__ = ['cal_geodesic_dist', 'cal_geodesic_lonlat', 'parse_geojson']

_A = 6378137.0                 # WGS84 semi-major axis [m]
_F = 1.0 / 298.257223563       # flattening
_B = _A * (1.0 - _F)


def cal_geodesic_dist(lon0, lat0, lon1, lat1, n_iter=60):
    """Vincenty inverse: geodesic distance [m] between point arrays."""
    lon0, lat0, lon1, lat1 = (np.asarray(v, dtype=np.float64).ravel()
                              for v in (lon0, lat0, lon1, lat1))
    u1 = np.arctan((1 - _F) * np.tan(np.deg2rad(lat0)))
    u2 = np.arctan((1 - _F) * np.tan(np.deg2rad(lat1)))
    ell = np.deg2rad(lon1 - lon0)
    su1, cu1 = np.sin(u1), np.cos(u1)
    su2, cu2 = np.sin(u2), np.cos(u2)

    lam = ell.copy()
    for _ in range(n_iter):
        sl, cl = np.sin(lam), np.cos(lam)
        s_sig = np.sqrt((cu2 * sl) ** 2 + (cu1 * su2 - su1 * cu2 * cl) ** 2)
        c_sig = su1 * su2 + cu1 * cu2 * cl
        sig = np.arctan2(s_sig, c_sig)
        with np.errstate(invalid='ignore', divide='ignore'):
            sin_alpha = np.where(s_sig > 0, cu1 * cu2 * sl / np.maximum(s_sig, 1e-300), 0.0)
            cos2_alpha = 1.0 - sin_alpha ** 2
            cos_2sigm = np.where(cos2_alpha > 0,
                                 c_sig - 2 * su1 * su2 / np.maximum(cos2_alpha, 1e-300),
                                 0.0)
        c = _F / 16 * cos2_alpha * (4 + _F * (4 - 3 * cos2_alpha))
        lam_new = ell + (1 - c) * _F * sin_alpha * (
            sig + c * s_sig * (cos_2sigm + c * c_sig * (-1 + 2 * cos_2sigm ** 2)))
        if np.all(np.abs(lam_new - lam) < 1e-12):
            lam = lam_new
            break
        lam = lam_new

    u_sq = cos2_alpha * (_A ** 2 - _B ** 2) / _B ** 2
    big_a = 1 + u_sq / 16384 * (4096 + u_sq * (-768 + u_sq * (320 - 175 * u_sq)))
    big_b = u_sq / 1024 * (256 + u_sq * (-128 + u_sq * (74 - 47 * u_sq)))
    d_sig = big_b * s_sig * (cos_2sigm + big_b / 4 * (
        c_sig * (-1 + 2 * cos_2sigm ** 2)
        - big_b / 6 * cos_2sigm * (-3 + 4 * s_sig ** 2) * (-3 + 4 * cos_2sigm ** 2)))
    dist = _B * big_a * (sig - d_sig)
    return np.where(np.isfinite(dist), dist, 0.0)


def cal_geodesic_lonlat(lon0, lat0, dist, azimuth, n_iter=60):
    """Vincenty direct: (lon1, lat1) reached from (lon0, lat0) after
    ``dist`` [m] along initial ``azimuth`` [deg, clockwise from north]."""
    lon0, lat0, dist, azimuth = (np.asarray(v, dtype=np.float64).ravel()
                                 for v in (lon0, lat0, dist, azimuth))
    alpha1 = np.deg2rad(azimuth)
    u1 = np.arctan((1 - _F) * np.tan(np.deg2rad(lat0)))
    su1, cu1 = np.sin(u1), np.cos(u1)
    sa1, ca1 = np.sin(alpha1), np.cos(alpha1)
    sigma1 = np.arctan2(np.tan(u1), ca1)
    sin_alpha = cu1 * sa1
    cos2_alpha = 1 - sin_alpha ** 2
    u_sq = cos2_alpha * (_A ** 2 - _B ** 2) / _B ** 2
    big_a = 1 + u_sq / 16384 * (4096 + u_sq * (-768 + u_sq * (320 - 175 * u_sq)))
    big_b = u_sq / 1024 * (256 + u_sq * (-128 + u_sq * (74 - 47 * u_sq)))

    sigma = dist / (_B * big_a)
    for _ in range(n_iter):
        cos_2sigm = np.cos(2 * sigma1 + sigma)
        s_sig, c_sig = np.sin(sigma), np.cos(sigma)
        d_sig = big_b * s_sig * (cos_2sigm + big_b / 4 * (
            c_sig * (-1 + 2 * cos_2sigm ** 2)
            - big_b / 6 * cos_2sigm * (-3 + 4 * s_sig ** 2)
            * (-3 + 4 * cos_2sigm ** 2)))
        sigma_new = dist / (_B * big_a) + d_sig
        if np.all(np.abs(sigma_new - sigma) < 1e-12):
            sigma = sigma_new
            break
        sigma = sigma_new

    s_sig, c_sig = np.sin(sigma), np.cos(sigma)
    cos_2sigm = np.cos(2 * sigma1 + sigma)
    lat1 = np.arctan2(su1 * c_sig + cu1 * s_sig * ca1,
                      (1 - _F) * np.sqrt(sin_alpha ** 2 +
                                         (su1 * s_sig - cu1 * c_sig * ca1) ** 2))
    lam = np.arctan2(s_sig * sa1, cu1 * c_sig - su1 * s_sig * ca1)
    c = _F / 16 * cos2_alpha * (4 + _F * (4 - 3 * cos2_alpha))
    ell = lam - (1 - c) * _F * sin_alpha * (
        sigma + c * s_sig * (cos_2sigm + c * c_sig * (-1 + 2 * cos_2sigm ** 2)))
    lon1 = (np.deg2rad(lon0) + ell + 3 * np.pi) % (2 * np.pi) - np.pi
    return np.rad2deg(lon1), np.rad2deg(lat1)


def parse_geojson(geojson_fpath):
    """(lons, lats) of the first feature's first ring
    (reference util.py:1228-1240)."""
    import json
    with open(geojson_fpath) as f:
        data = json.load(f)
    coords = data['features'][0]['geometry']['coordinates']
    arr = np.array(coords[0])
    return arr[:, 0], arr[:, 1]

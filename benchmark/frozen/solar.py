"""Frozen copy of ``er3t_tpu_torch/physics/solar.py (whole, at bdb0f8e)``, kept for the benchmark's inputs and its
plain reference; do not edit.

Sun-Earth distance factor, solar position and TOA solar spectrum (NumPy
copy of ``er3t_tpu/physics/solar.py``: ``sol_fac`` :22-30, ``solar_angles``
:33-67, the bundled spectrum and ``solar_irradiance`` :70-91).
"""

from __future__ import annotations

import datetime

import numpy as np

__all__ = ['sol_fac', 'solar_angles', 'solar_irradiance']


def sol_fac(dtime: datetime.datetime | None) -> float:
    """Solar factor (inverse squared Sun-Earth distance in AU)."""
    if dtime is None:
        return 1.0
    doy = dtime.timetuple().tm_yday
    eps = 0.0167086
    perh = 4.0
    rsun = 1.0 - eps * np.cos(0.017202124161707175 * (doy - perh))
    return float(1.0 / rsun ** 2)


def solar_angles(dtime_utc: datetime.datetime, lon_deg, lat_deg):
    """Solar zenith and azimuth [deg] (azimuth clockwise from north).

    Low-precision solar position (Meeus, Astronomical Algorithms ch. 25),
    accurate to ~0.01 deg over 1950-2050 — sufficient for RT geometry.
    """
    lon = np.asarray(lon_deg, dtype=np.float64)
    lat = np.asarray(lat_deg, dtype=np.float64)

    if dtime_utc.tzinfo is not None:
        dtime_utc = dtime_utc.astimezone(datetime.timezone.utc).replace(tzinfo=None)
    epoch = datetime.datetime(2000, 1, 1, 12)
    d = (dtime_utc - epoch).total_seconds() / 86400.0  # days since J2000.0

    g = np.deg2rad((357.529 + 0.98560028 * d) % 360.0)   # mean anomaly
    q = (280.459 + 0.98564736 * d) % 360.0               # mean longitude
    lam = np.deg2rad(q + 1.915 * np.sin(g) + 0.020 * np.sin(2 * g))  # ecliptic lon
    e = np.deg2rad(23.439 - 0.00000036 * d)              # obliquity

    ra = np.arctan2(np.cos(e) * np.sin(lam), np.cos(lam))          # right ascension
    dec = np.arcsin(np.sin(e) * np.sin(lam))                       # declination

    gmst = (18.697374558 + 24.06570982441908 * d) % 24.0           # hours
    lst = gmst * 15.0 + lon                                        # deg
    ha = np.deg2rad((lst - np.rad2deg(ra) + 540.0) % 360.0 - 180.0)  # hour angle

    phi = np.deg2rad(lat)
    sin_alt = np.sin(phi) * np.sin(dec) + np.cos(phi) * np.cos(dec) * np.cos(ha)
    alt = np.arcsin(np.clip(sin_alt, -1.0, 1.0))
    az = np.arctan2(-np.sin(ha),
                    np.tan(dec) * np.cos(phi) - np.sin(phi) * np.cos(ha))

    sza = 90.0 - np.rad2deg(alt)
    saa = np.rad2deg(az) % 360.0
    return sza, saa


# ----------------------------------------------------------------------------
# bundled coarse TOA solar spectrum [W/m^2/nm] at 1 AU
# (smoothed composite; integrates to ~1361 W/m^2 over 200-4000 nm)
# ----------------------------------------------------------------------------
_SOL_WVL = np.array([
    200, 250, 300, 320, 340, 360, 380, 400, 420, 440, 460, 480, 500,
    520, 540, 560, 580, 600, 620, 640, 650, 660, 680, 700, 720, 750,
    760, 780, 800, 850, 900, 950, 1000, 1100, 1200, 1300, 1400, 1500,
    1600, 1700, 1800, 1900, 2000, 2200, 2400, 2500, 2700, 3000, 3500, 4000,
], dtype=np.float64)
_SOL_IRR = np.array([
    0.011, 0.064, 0.51, 0.78, 0.95, 1.00, 1.12, 1.70, 1.74, 1.80, 2.04,
    2.07, 1.94, 1.88, 1.87, 1.83, 1.82, 1.77, 1.72, 1.64, 1.60, 1.58,
    1.51, 1.43, 1.37, 1.29, 1.27, 1.22, 1.15, 0.98, 0.91, 0.82, 0.75,
    0.61, 0.50, 0.41, 0.34, 0.29, 0.24, 0.20, 0.17, 0.14, 0.12, 0.085,
    0.062, 0.055, 0.041, 0.027, 0.014, 0.008,
], dtype=np.float64)


def solar_irradiance(wvl_nm):
    """TOA solar spectral irradiance [W/m^2/nm] at 1 AU (coarse spectrum)."""
    return np.interp(np.asarray(wvl_nm, dtype=np.float64), _SOL_WVL, _SOL_IRR)

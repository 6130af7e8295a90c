"""Spectral flux and radiance machinery (copy of
``er3t_tpu/apps/spectral.py:29-268``: ``spec_flx``, ``spec_rad``,
``slit_convolve``, ``triangular_slit`` and their helpers, and the Monte
Carlo loops ``spectral_flux`` and ``spectral_radiance``).

``spec_flx`` and ``spec_rad`` run the port's NumPy doubling-adding solver
(:mod:`er3t_tpu_torch.rtm.oned`, the libRadtran/DISORT role of the
reference's ``lrt_init_spec_flx``/``lrt_init_spec_rad``, lrt_flx.py:
207-412 and lrt_rad.py:31-541) on the host: per-wavelength correlated-k
gases (``abs_16g``, synthetic where the database is missing), 1D cloud
layers from a ``cld_cfg`` dict with the bulk optics of
:mod:`~er3t_tpu_torch.physics.cloud_optics`, 1D aerosol layers from an
``aer_cfg`` dict, a spectral surface albedo, and SSFR-style triangular
slits (8 nm vis, 16 nm nir).  ``spectral_flux`` and ``spectral_radiance``
run :func:`~er3t_tpu_torch.rtm.solver.solve` once a wavelength on
``device`` (the card unless the caller asks for the CPU).
"""

from __future__ import annotations

import numpy as np

from ..physics.cloud_optics import water_cloud_optics
from ..physics.rayleigh import rayleigh_od
from ..pre.abs import abs_16g
from ..rtm import solver
from ..rtm.oned import hg_moments, rayleigh_moments, solve_plane_parallel
from ..rtm.out import spectral_factors

__all__ = ['spec_flx', 'spec_rad', 'slit_convolve', 'triangular_slit',
           'spectral_flux', 'spectral_radiance']


def triangular_slit(half_width_nm: float, n: int = 17):
    """(offsets, weights) of a triangular slit — the shape of the SSFR
    slit-function files the reference selects by band (8 nm below 950 nm,
    16 nm above; lrt_flx.py:295-305)."""
    off = np.linspace(-half_width_nm, half_width_nm, n)
    w = 1.0 - np.abs(off) / half_width_nm
    return off, w / w.sum()


def slit_convolve(wvl_grid, spectrum, slit_wvl, slit_weight, wvl_out):
    """Convolve ``spectrum`` sampled on ``wvl_grid`` with a tabulated slit."""
    spectrum = np.asarray(spectrum)
    out_shape = (np.atleast_1d(wvl_out).size,) + spectrum.shape[1:]
    out = np.zeros(out_shape)
    for i, w0 in enumerate(np.atleast_1d(wvl_out)):
        pts = w0 + np.asarray(slit_wvl)
        wts = np.asarray(slit_weight, dtype=np.float64)
        acc = np.zeros(spectrum.shape[1:])
        for p, wt in zip(pts, wts):
            j = np.clip(np.searchsorted(wvl_grid, p) - 1, 0,
                        len(wvl_grid) - 2)
            f = np.clip((p - wvl_grid[j]) / (wvl_grid[j + 1] - wvl_grid[j]),
                        0.0, 1.0)
            acc = acc + wt * ((1 - f) * spectrum[j] + f * spectrum[j + 1])
        out[i] = acc / wts.sum()
    return out


def _albedo_at(surface_albedo, wvl):
    if callable(surface_albedo):
        return float(surface_albedo(wvl))
    arr = np.asarray(surface_albedo, dtype=np.float64)
    if arr.ndim == 2:          # albedo_file role: columns (wvl, albedo)
        return float(np.interp(wvl, arr[:, 0], arr[:, 1]))
    return float(arr)


def _layers(atm, ab, g, wvl, cld_cfg, aer_cfg, n_mom):
    """(tau, ssa, moments) per layer for one wavelength and g-point."""
    nz = atm.lay.altitude.size
    tau_ray = rayleigh_od(wvl, atm.lev.pressure, lat_deg=atm.lat)
    tau_gas = ab.abso_coef[:, g]

    tau_c = np.zeros(nz)
    ssa_c, asy_c = 1.0, 0.85
    if cld_cfg is not None:
        base = float(cld_cfg.get('cloud_base', 1.0))
        top = float(cld_cfg.get('cloud_top', 2.0))
        cot550 = float(cld_cfg.get('cloud_optical_thickness', 10.0))
        cer = float(cld_cfg.get('cloud_effective_radius', 10.0))
        scale, ssa_c, asy_c = water_cloud_optics(wvl, cer)
        zlo = atm.lay.altitude - 0.5 * atm.lay.thickness
        zhi = atm.lay.altitude + 0.5 * atm.lay.thickness
        ov = np.clip(np.minimum(zhi, top) - np.maximum(zlo, base), 0.0, None)
        if ov.sum() > 0:
            tau_c = cot550 * scale * ov / ov.sum()

    tau_a = np.zeros(nz)
    ssa_a, asy_a = 0.9, 0.7
    if aer_cfg is not None:
        aod = float(aer_cfg.get('aerosol_optical_depth', 0.2))
        ssa_a = float(aer_cfg.get('single_scattering_albedo', 0.9))
        asy_a = float(aer_cfg.get('asymmetry_parameter', 0.7))
        base = float(aer_cfg.get('aerosol_base', 0.0))
        top = float(aer_cfg.get('aerosol_top', 3.0))
        ang = float(aer_cfg.get('angstrom_exponent', 1.3))
        zlo = atm.lay.altitude - 0.5 * atm.lay.thickness
        zhi = atm.lay.altitude + 0.5 * atm.lay.thickness
        ov = np.clip(np.minimum(zhi, top) - np.maximum(zlo, base), 0.0, None)
        if ov.sum() > 0:
            tau_a = aod * (wvl / 550.0) ** (-ang) * ov / ov.sum()

    tau = tau_ray + tau_gas + tau_c + tau_a
    sca = tau_ray + ssa_c * tau_c + ssa_a * tau_a
    ssa = sca / np.maximum(tau, 1e-12)
    mom = np.zeros((nz, n_mom))
    m_ray = rayleigh_moments(min(n_mom, 3))
    m_cld = hg_moments(asy_c, n_mom)
    m_aer = hg_moments(asy_a, n_mom)
    with np.errstate(invalid='ignore'):
        wr = tau_ray / np.maximum(sca, 1e-12)
        wc = ssa_c * tau_c / np.maximum(sca, 1e-12)
        wa = ssa_a * tau_a / np.maximum(sca, 1e-12)
    mom[:, :m_ray.size] += wr[:, None] * m_ray[None, :]
    mom += wc[:, None] * m_cld[None, :] + wa[:, None] * m_aer[None, :]
    mom[:, 0] = 1.0
    return tau, ssa, mom


def _resolve_slit(slit, wvl_max):
    if slit is None:
        return None
    if slit == 'auto':
        slit = 'nir' if wvl_max > 950.0 else 'vis'
    if slit == 'vis':
        return triangular_slit(8.0)
    if slit == 'nir':
        return triangular_slit(16.0)
    return np.asarray(slit[0]), np.asarray(slit[1])


def _apply_slit(wvl, v, slit):
    """Slit-convolve ``v(wvl)`` onto the same grid.

    ``'auto'`` selects the SSFR slit PER CHANNEL — 8 nm (vis) at
    wavelengths <= 950 nm, 16 nm (nir) above — matching the reference's
    per-band selection (lrt_flx.py:295-305); a single max-wavelength
    choice would smooth a mixed vis/nir spectrum's visible channels with
    double the intended half-width."""
    if slit is None:
        return v
    if slit == 'auto':
        out = np.array(v, dtype=np.float64)
        vis = wvl <= 950.0
        for m, band in ((vis, 'vis'), (~vis, 'nir')):
            if m.any():
                sw = _resolve_slit(band, 0.0)
                out[m] = slit_convolve(wvl, v, sw[0], sw[1], wvl[m])
        return out
    sw = _resolve_slit(slit, float(np.max(wvl)))
    return slit_convolve(wvl, v, sw[0], sw[1], wvl)


def spec_flx(atm, wavelengths=None, date=None, surface_albedo=0.03,
             solar_zenith_angle=0.0, cld_cfg=None, aer_cfg=None,
             slit='auto', abs_fn=None, n_streams=8):
    """Spectral boundary irradiances [W/m^2/nm] (lrt_init_spec_flx role).

    Returns dict: wvl, f_down_direct/f_down_diffuse/f_down (surface),
    f_up (TOA), toa (TOA down irradiance), each (Nwvl,) — slit-convolved
    when ``slit`` is set ('auto' picks the SSFR vis/nir half-width by band,
    mirroring lrt_flx.py:295-305; pass None for monochromatic).
    """
    wvl = np.atleast_1d(np.asarray(
        wavelengths if wavelengths is not None
        else np.arange(350.0, 951.0, 5.0), dtype=np.float64))
    abs_fn = abs_fn or abs_16g
    mu0 = float(np.cos(np.deg2rad(solar_zenith_angle)))
    n_mom = 64
    cols = {k: np.zeros(wvl.size) for k in
            ('f_down_direct', 'f_down_diffuse', 'f_up', 'toa')}
    for i, w in enumerate(wvl):
        ab = abs_fn(float(w), atm)
        factors, toa = spectral_factors(ab, date=date, nz_out=1)
        alb = _albedo_at(surface_albedo, w)
        for g in range(ab.ng):
            tau, ssa, mom = _layers(atm, ab, g, float(w), cld_cfg, aer_cfg,
                                    n_mom)
            _, fl = solve_plane_parallel(
                tau, ssa, mom, mu0, 0.5, 0.0, surface_albedo=alb,
                n_streams=n_streams, n_modes=1, flux=True)
            fac = factors[0][g]
            cols['f_down_direct'][i] += fac * fl['f_dn_sfc_direct']
            cols['f_down_diffuse'][i] += fac * fl['f_dn_sfc_diffuse']
            cols['f_up'][i] += fac * fl['f_up_toa']
        cols['toa'][i] = toa * mu0
    out = {'wvl': wvl}
    for k, v in cols.items():
        out[k] = _apply_slit(wvl, v, slit)
    out['f_down'] = out['f_down_direct'] + out['f_down_diffuse']
    return out


def spec_rad(atm, wavelengths=None, date=None, surface_albedo=0.03,
             solar_zenith_angle=30.0, sensor_zenith_angle=0.0,
             relative_azimuth=0.0, cld_cfg=None, aer_cfg=None,
             slit='auto', abs_fn=None, n_streams=16):
    """Spectral TOA radiance [W/m^2/nm/sr] (lrt_init_spec_rad /
    lrt_init_rad role, lrt_rad.py:31-541): doubling-adding with delta-M +
    TMS at the given viewing geometry, slit-convolved like spec_flx."""
    wvl = np.atleast_1d(np.asarray(
        wavelengths if wavelengths is not None
        else np.arange(350.0, 951.0, 5.0), dtype=np.float64))
    abs_fn = abs_fn or abs_16g
    mu0 = float(np.cos(np.deg2rad(solar_zenith_angle)))
    muv = float(np.cos(np.deg2rad(sensor_zenith_angle)))
    muv = min(max(muv, 0.05), 0.9999)
    dphi = float(np.deg2rad(relative_azimuth))
    n_mom = 128
    rad = np.zeros(wvl.size)
    for i, w in enumerate(wvl):
        ab = abs_fn(float(w), atm)
        factors, _ = spectral_factors(ab, date=date, nz_out=1)
        alb = _albedo_at(surface_albedo, w)
        for g in range(ab.ng):
            tau, ssa, mom = _layers(atm, ab, g, float(w), cld_cfg, aer_cfg,
                                    n_mom)
            r = solve_plane_parallel(tau, ssa, mom, mu0, muv, dphi,
                                     surface_albedo=alb,
                                     n_streams=n_streams)
            rad[i] += factors[0][g] * float(np.atleast_1d(r)[0])
    out = {'wvl': wvl}
    out['rad'] = _apply_slit(wvl, rad, slit)
    return out


# ---------------------------------------------------------------------------
# MC-solver spectral loops (3D scenes; the per-wavelength example drivers)
# ---------------------------------------------------------------------------

def _spectral(atm, wavelengths, target, abs_fn=None, *, device, **kw):
    abs_fn = abs_fn or (lambda w, a: abs_16g(w, a))
    results = []
    for w in np.atleast_1d(wavelengths):
        ab = abs_fn(float(w), atm)
        results.append(solver.solve(atm=atm, abs_coef=ab, target=target,
                                    device=device, **kw))
    return results


def spectral_flux(atm, wavelengths, *, device='cuda', **kw):
    """MC flux spectra over 3D scenes: dict of (Nwvl, ...) arrays + 'wvl',
    each wavelength's ``solve`` run on ``device``."""
    res = _spectral(atm, wavelengths, 'flux', device=device, **kw)
    out = {'wvl': np.atleast_1d(np.asarray(wavelengths, dtype=float))}
    for key in ('f_down', 'f_up', 'f_down_direct', 'f_down_diffuse'):
        out[key] = np.stack([r[key] for r in res])
    out['toa'] = np.array([r.toa for r in res])
    return out


def spectral_radiance(atm, wavelengths, *, device='cuda', **kw):
    """MC radiance spectra over 3D scenes: (Nwvl, Nx, Ny) + 'wvl', each
    wavelength's ``solve`` run on ``device``."""
    res = _spectral(atm, wavelengths, 'radiance', device=device, **kw)
    return {'wvl': np.atleast_1d(np.asarray(wavelengths, dtype=float)),
            'rad': np.stack([r['rad'] for r in res]),
            'toa': np.array([r.toa for r in res])}

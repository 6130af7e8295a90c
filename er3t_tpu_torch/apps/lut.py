"""Reflectance lookup tables and bispectral (Nakajima-King) retrievals
(copy of ``er3t_tpu/apps/lut.py:16-230``: ``_grid_cloud``,
``_reflectance``, ``gen_bispectral_lookup_table``, ``retrieve_cot_cer``,
``func_ref_vs_cot`` and ``func_ref_vs_cot_multi_pixel``) over the port's
:func:`~er3t_tpu_torch.rtm.solver.solve`.

Every LUT node is a column of one IPA scene, so one transport run computes
a whole table (upstream EaR3T starts one libRadtran or MCARaTS process
per node: er3t/rtm/lrt/util.py:201-918, er3t/rtm/mca/util.py:19-415).
The functions that reach ``solve`` take ``device`` (the card unless the
caller asks for the CPU) and pass it on; their NumPy arithmetic is the
reference's, operation for operation.
"""

from __future__ import annotations

import numpy as np

from ..physics.twostream import r_twostream
from ..pre.cld import Cloud3D
from ..rtm import solver

__all__ = ['gen_bispectral_lookup_table', 'retrieve_cot_cer',
           'func_ref_vs_cot', 'func_ref_vs_cot_multi_pixel']


def _grid_cloud(cot_grid, cer_grid, cloud_base=1.0, cloud_top=2.0, nz=1,
                dx=1.0, dy=1.0):
    """One cloud column per (cot, cer) node."""
    cot_grid = np.asarray(cot_grid, dtype=np.float64)
    cer_grid = np.asarray(cer_grid, dtype=np.float64)
    nx, ny = cot_grid.size, cer_grid.size
    edges = np.linspace(cloud_base, cloud_top, nz + 1)
    alt = 0.5 * (edges[1:] + edges[:-1])
    thick = np.diff(edges)
    depth_m = (cloud_top - cloud_base) * 1000.0
    ext = np.broadcast_to((cot_grid / depth_m)[:, None, None],
                          (nx, ny, nz)).copy()
    cer = np.broadcast_to(cer_grid[None, :, None], (nx, ny, nz)).copy()
    x = (np.arange(nx) + 0.5) * dx
    y = (np.arange(ny) + 0.5) * dy
    return Cloud3D(x=x, y=y, dx=dx, dy=dy, altitude=alt, thickness=thick,
                   extinction=ext, cer=cer)


def _reflectance(res, ab, mu0):
    """pi I / (mu0 E) from a radiance Result."""
    toa = res.toa
    return np.pi * res['rad'] / (mu0 * toa)


def gen_bispectral_lookup_table(
        atm, wvl_vis=650.0, wvl_nir=1600.0,
        cot_grid=None, cer_grid=None,
        solar_zenith_angle=30.0, surface_albedo=0.03,
        photons=2e6, seed=0, abs_fn=None, *, device='cuda'):
    """Bispectral reflectance LUT over (COT, CER), run on ``device``.

    Returns dict with 'cot', 'cer', 'ref_vis' (Ncot, Ncer), 'ref_nir'.
    """
    from ..pre.abs import abs_synthetic
    from ..pre.pha import pha_mie_wc

    if cot_grid is None:
        cot_grid = np.concatenate([[0.0], np.logspace(-1, np.log10(100), 24)])
    if cer_grid is None:
        cer_grid = np.arange(4.0, 25.1, 2.0)
    abs_fn = abs_fn or abs_synthetic
    cld = _grid_cloud(cot_grid, cer_grid)
    mu0 = np.cos(np.deg2rad(solar_zenith_angle))

    out = {'cot': np.asarray(cot_grid), 'cer': np.asarray(cer_grid)}
    for tag, wvl in (('vis', wvl_vis), ('nir', wvl_nir)):
        ab = abs_fn(wvl, atm)
        pha = pha_mie_wc(wvl)
        res = solver.solve(atm=atm, abs_coef=ab, cld=cld, pha=pha,
                           surface=surface_albedo, target='radiance',
                           solver='ipa', solar_zenith_angle=solar_zenith_angle,
                           photons=photons, n_run=1, seed=seed,
                           device=device)
        out[f'ref_{tag}'] = _reflectance(res, ab, mu0)
    return out


def retrieve_cot_cer(lut, ref_vis, ref_nir):
    """Invert measured (vis, nir) reflectance pairs to (COT, CER).

    Nearest-node + local refinement on the LUT surface (the reference
    inverts by interpolation over the same table, lrt/util.py:500-...).
    """
    rv = np.atleast_1d(np.asarray(ref_vis, dtype=np.float64))
    rn = np.atleast_1d(np.asarray(ref_nir, dtype=np.float64))
    tv, tn = lut['ref_vis'], lut['ref_nir']
    d2 = (tv[None, :, :] - rv[:, None, None]) ** 2 \
        + (tn[None, :, :] - rn[:, None, None]) ** 2
    flat = d2.reshape(rv.size, -1).argmin(axis=1)
    icot, icer = np.unravel_index(flat, tv.shape)
    return lut['cot'][icot], lut['cer'][icer]


def func_ref_vs_cot(atm, wavelength=650.0, cot_grid=None, cer0=10.0,
                    solar_zenith_angle=30.0, surface_albedo=0.03,
                    photons=2e6, seed=0, *, device='cuda'):
    """IPA reflectance vs COT curve + two-stream companion + inverter,
    the transport run on ``device``.

    Returns an object with .cot, .ref (MC), .ref_2s (two-stream closed form),
    and .get_cot_from_ref(ref) (reference: er3t/rtm/mca/util.py:19-415).
    """
    from ..pre.abs import abs_synthetic
    from ..pre.pha import pha_mie_wc

    if cot_grid is None:
        cot_grid = np.concatenate([[0.0], np.logspace(-1, 2, 30)])
    cot_grid = np.asarray(cot_grid, dtype=np.float64)
    cld = _grid_cloud(cot_grid, np.array([cer0]))
    mu0 = np.cos(np.deg2rad(solar_zenith_angle))
    ab = abs_synthetic(wavelength, atm)
    pha = pha_mie_wc(wavelength)
    res = solver.solve(atm=atm, abs_coef=ab, cld=cld, pha=pha,
                       surface=surface_albedo, target='radiance', solver='ipa',
                       solar_zenith_angle=solar_zenith_angle, photons=photons,
                       n_run=1, seed=seed, device=device)
    ref = _reflectance(res, ab, mu0)[:, 0]

    class _Curve:
        cot = cot_grid
        pass

    c = _Curve()
    c.ref = ref
    c.toa = float(res.toa)     # TOA irradiance [W/m^2/nm]: converts an
    #                            observed radiance to the curve's
    #                            reflectance convention, pi L / (toa mu0)
    iref = np.searchsorted(np.asarray(pha.data['ref']), cer0)
    g0 = float(np.asarray(pha.data['asy'])[min(iref, len(pha.data['asy']) - 1)])
    c.ref_2s = r_twostream(cot_grid, a=surface_albedo, g=g0, mu=mu0)

    def get_cot_from_ref(r):
        r = np.atleast_1d(r)
        order = np.argsort(ref)
        return np.interp(r, ref[order], cot_grid[order])

    c.get_cot_from_ref = get_cot_from_ref
    return c


class func_ref_vs_cot_multi_pixel:
    """Per-pixel reflectance-vs-COT retrieval curve (reference:
    ``func_ref_vs_cot_multi_pixel``, er3t/rtm/mca/util.py:218-415).

    Each COT node is a homogeneous Nx x Ny cloud scene run through the
    full solver (``solver='ipa'`` or ``'3d'``) at the requested
    solar/sensor geometry with Nrun repeats; ``ref``/``ref_std`` hold the
    pixel-mean reflectance and its run-to-run std, and the two-stream
    companion curve fills the ``'2s'`` inversion mode.  Where the
    reference launches Nrun x Ng MCARaTS processes per node and reads the
    results back from HDF5, every node here is a single solve() call.

    Methods mirror the reference: ``get_cot_from_ref(ref, method, mode)``
    and ``get_ref_from_cot(cot, method, mode)`` with 'cubic'/'linear'
    interpolation and 'rt'/'2s' modes.  Every node runs on ``device``.
    """

    def __init__(self, cot, atm=None, cer0=10.0, wavelength=650.0,
                 surface_albedo=0.03, solar_zenith_angle=30.0,
                 solar_azimuth_angle=0.0, sensor_zenith_angle=0.0,
                 sensor_azimuth_angle=0.0, cloud_top_height=2.0,
                 cloud_geometrical_thickness=1.0, solver_name='ipa',
                 photons=2e5, n_run=3, nx=2, ny=2, dx=0.1, dy=0.1,
                 seed=0, abs_fn=None, *, device='cuda'):
        from ..pre.abs import abs_synthetic
        from ..pre.atm import atm_atmmod
        from ..pre.cld import cld_gen_hom
        from ..pre.pha import pha_mie_wc

        if atm is None:
            atm = atm_atmmod(np.concatenate([np.arange(0.0, 5.0, 0.5),
                                             np.arange(5.0, 20.1, 1.0)]))
        self.cot = np.asarray(cot, dtype=np.float64)
        self.cer0 = float(cer0)
        self.mu0 = float(np.cos(np.deg2rad(solar_zenith_angle)))
        abs_fn = abs_fn or abs_synthetic
        ab = abs_fn(float(wavelength), atm)
        pha = pha_mie_wc(float(wavelength))

        rad, rad_std = [], []
        toa = None
        for i, cot0 in enumerate(self.cot):
            cld = cld_gen_hom(nx=nx, ny=ny, dx=dx, dy=dy, cot0=float(cot0),
                              cer0=cer0,
                              cloud_base=cloud_top_height
                              - cloud_geometrical_thickness,
                              cloud_top=cloud_top_height)
            res = solver.solve(
                atm=atm, abs_coef=ab, cld=cld, pha=pha,
                surface=surface_albedo, target='radiance',
                solver=solver_name,
                solar_zenith_angle=solar_zenith_angle,
                solar_azimuth_angle=solar_azimuth_angle,
                sensor_zenith_angle=sensor_zenith_angle,
                sensor_azimuth_angle=sensor_azimuth_angle,
                photons=photons, n_run=n_run, seed=seed + 37 * i,
                device=device)
            rad.append(float(np.mean(res['rad'])))
            rad_std.append(float(np.mean(res.std['rad_std'])))
            toa = res.toa
        self.toa0 = toa
        self.rad = np.array(rad)
        self.rad_std = np.array(rad_std)
        self.ref = np.pi * self.rad / (toa * self.mu0)
        self.ref_std = np.pi * self.rad_std / (toa * self.mu0)
        iref = np.searchsorted(np.asarray(pha.data['ref']), cer0)
        g0 = float(np.asarray(pha.data['asy'])[
            min(iref, len(pha.data['asy']) - 1)])
        self.ref_2s = r_twostream(self.cot, a=surface_albedo, g=g0,
                                  mu=self.mu0)

    def _interp(self, x, y, x0, method):
        from scipy.interpolate import interp1d
        order = np.argsort(x)
        f = interp1d(x[order], y[order], kind=method, bounds_error=False,
                     fill_value='extrapolate')
        return f(np.atleast_1d(np.asarray(x0, dtype=np.float64)))

    def get_cot_from_ref(self, ref, method='cubic', mode='rt'):
        src = self.ref_2s if mode == '2s' else self.ref
        return self._interp(src, self.cot, ref, method)

    def get_ref_from_cot(self, cot, method='cubic', mode='rt'):
        src = self.ref_2s if mode == '2s' else self.ref
        return self._interp(self.cot, src, cot, method)

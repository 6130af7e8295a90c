"""Frozen copy of ``er3t_tpu_torch/rtm/scene.py:57-74, 98-288`` (``SceneStatic``,
``_cloud_to_grids``, ``_build_numpy``: the optics the scene builder
derives from its inputs, as NumPy leaves) and
``er3t_tpu_torch/util/grid.py:57-61`` (``get_lay_index``), kept for the benchmark's inputs and its plain
reference; do not edit.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .pha import PhaseTable, build_phase_table, pha_hg
from .rayleigh import rayleigh_od
from .sfc import SFC_LAMBERTIAN, sfc_lambertian


def get_lay_index(z_query: np.ndarray, z_grid: np.ndarray) -> np.ndarray:
    """Nearest layer index in ``z_grid`` for each query altitude
    (reference: util.py:816-833)."""
    z_query = np.atleast_1d(z_query)
    return np.abs(z_query[:, None] - np.asarray(z_grid)[None, :]).argmin(axis=1)


@dataclasses.dataclass(frozen=True)
class SceneStatic:
    """Hashable static configuration accompanying :class:`SceneArrays`."""
    nz: int
    ng: int
    nx: int
    ny: int
    nz3: int
    iz3l: int                 # first atmosphere layer of the 3D region
    nxs: int
    nys: int
    dx: float                 # m
    dy: float                 # m
    has_3d: bool
    has_aer1d: bool
    ipa: bool = False         # independent-pixel mode
    ns3: int = 1              # number of 3D constituents
    sfc_lambertian: bool = False  # every surface cell is Lambertian



def _cloud_to_grids(cld, pha, atm):
    """Map a Cloud3D onto atmosphere layers; derive ssa/apf per voxel
    (reference ``scene.py:100-132``)."""
    lay_index = get_lay_index(cld.altitude, atm.lay.altitude)
    iz3l = int(lay_index[0])
    nz3 = int(lay_index.size)
    if np.any(np.diff(lay_index) != 1):
        raise ValueError('cloud layers must map to contiguous atmosphere layers; '
                         'choose atmosphere levels that resolve the cloud grid')

    ext = np.asarray(cld.extinction, dtype=np.float32)
    cloudy = ext > 0.0
    ssa = np.ones_like(ext, dtype=np.float32)
    apf = np.zeros(ext.shape, dtype=np.int32)

    if pha is None:
        # HG g=0.85 (table row 1 of the default table)
        apf[cloudy] = 1
    else:
        ref = np.asarray(pha.data['ref'])
        ssa_t = np.asarray(pha.data['ssa'])
        cer = np.asarray(cld.cer)
        # nearest effective-radius row (rows offset by 1: row 0 = Rayleigh)
        mid = 0.5 * (ref[1:] + ref[:-1])
        idx = np.searchsorted(mid, cer).astype(np.int32)
        apf[cloudy] = (idx + 1)[cloudy]
        ssa[cloudy] = np.interp(cer[cloudy], ref, ssa_t).astype(np.float32)
    return iz3l, nz3, ext, ssa, apf


def _build_numpy(atm, abs_coef, cld, pha, aer_1ds, aer_3ds, surface,
                 solar_zenith_angle, solar_azimuth_angle, ipa,
                 forward_trunc_deg, pfpeak, phase_bins):
    """The reference's NumPy scene body: returns (leaves dict, SceneStatic)."""
    nz = atm.nz
    ng = abs_coef.ng
    dz_m = atm.lay.thickness * 1000.0

    tau_ray = rayleigh_od(abs_coef.wvl, atm.lev.pressure, lat_deg=atm.lat)
    sig_ray = (tau_ray / dz_m).astype(np.float32)
    kabs = (abs_coef.abso_coef / dz_m[:, None]).astype(np.float32)

    # 1D aerosol channels: one per constituent, own ssa and phase row
    aer_1ds = tuple(aer_1ds)
    aer_3ds = tuple(aer_3ds)
    na = max(len(aer_1ds), 1)
    sig_aer = np.zeros((nz, na), dtype=np.float32)
    for j, a in enumerate(aer_1ds):
        sig_aer[:, j] = a.extinction_profile(
            atm.lay.altitude, atm.lay.thickness).astype(np.float32)
    aer_ssa = np.array([a.ssa for a in aer_1ds] or [1.0], dtype=np.float32)
    extra_asy = [a.asy for a in aer_1ds] + [a.asy for a in aer_3ds]

    # phase table: default HG(0.85) for clouds + aerosol HG rows appended
    pb = {} if phase_bins is None else {'n_u': int(phase_bins),
                                        'n_m': int(phase_bins)}
    if pha is None:
        asy_rows = [0.85] + extra_asy
        table = build_phase_table(pha_hg(asy_params=tuple(asy_rows)),
                                  forward_trunc_deg=forward_trunc_deg, **pb)
    else:
        table = build_phase_table(pha, forward_trunc_deg=forward_trunc_deg,
                                  **pb)
        if extra_asy:
            aer_tab = build_phase_table(pha_hg(asy_params=tuple(extra_asy)),
                                        **pb)
            table = PhaseTable(
                mu_sample=np.concatenate([table.mu_sample, aer_tab.mu_sample[1:]], axis=0),
                p_eval=np.concatenate([table.p_eval, aer_tab.p_eval[1:]], axis=0),
                asy=np.concatenate([table.asy, aer_tab.asy[1:]]),
                ssa=np.concatenate([table.ssa, aer_tab.ssa[1:]]),
                reff=np.concatenate([table.reff, aer_tab.reff[1:]]),
                trunc_f=np.concatenate([table.trunc_f, aer_tab.trunc_f[1:]]),
                p_tms=np.concatenate([table.p_tms, aer_tab.p_tms[1:]], axis=0),
            )
    first_extra = table.n_pf - len(extra_asy)
    aer_apf = np.array([first_extra + j for j in range(len(aer_1ds))] or [0],
                       dtype=np.int32)
    aer3d_rows = [first_extra + len(aer_1ds) + j for j in range(len(aer_3ds))]

    # 3D region: one slot per constituent (cloud + each 3D aerosol), each
    # with its own ssa and phase row, chosen at collision time by share
    if cld is not None:
        iz3l, nz3, ext_c, ssa_c, apf_c = _cloud_to_grids(cld, pha, atm)
        nx, ny = cld.nx, cld.ny
        dx, dy = cld.dx * 1000.0, cld.dy * 1000.0
        exts = [ext_c]
        ssas = [ssa_c]
        apfs = [apf_c]
        for j, a in enumerate(aer_3ds):
            exts.append(np.asarray(a.extinction, dtype=np.float32))
            ssas.append(np.full_like(exts[-1], np.float32(a.ssa)))
            apfs.append(np.full(exts[-1].shape, aer3d_rows[j], dtype=np.int32))
        if table.trunc_f is not None and np.any(table.trunc_f > 0):
            # delta-truncation similarity scaling per constituent
            for s in range(len(exts)):
                f_vox = table.trunc_f[apfs[s]]
                sf = 1.0 - ssas[s] * f_vox
                ssas[s] = (ssas[s] * (1.0 - f_vox)
                           / np.maximum(sf, 1e-9)).astype(np.float32)
                exts[s] = (exts[s] * sf).astype(np.float32)
        ext3d = np.sum(exts, axis=0).astype(np.float32)
        ssa3d = np.stack(ssas, axis=-1)
        apf3d = np.stack(apfs, axis=-1)
        with np.errstate(invalid='ignore', divide='ignore'):
            cf3d = np.cumsum(np.stack(exts, axis=-1), axis=-1) \
                / np.maximum(ext3d[..., None], 1e-30)
        cf3d[..., -1] = 1.0
        cf3d = np.where(ext3d[..., None] > 0, cf3d, 1.0).astype(np.float32)
        has_3d = True
    else:
        if aer_3ds:
            raise ValueError(
                '3D aerosols ride the cloud grid (Aerosol3D carries no '
                'geometry of its own); pass cld= to define the 3D region — '
                'a zero-extinction carrier (e.g. cld_gen_hom(..., cot0=0)) '
                'works for aerosol-only scenes')
        iz3l, nz3 = 0, 1
        nx = ny = 1
        dx = dy = 1000.0
        ext3d = np.zeros((1, 1, 1), dtype=np.float32)
        ssa3d = np.ones((1, 1, 1, 1), dtype=np.float32)
        apf3d = np.zeros((1, 1, 1, 1), dtype=np.int32)
        cf3d = np.ones((1, 1, 1, 1), dtype=np.float32)
        has_3d = False

    # phase-row compaction: keep only the rows this scene references
    used = np.unique(np.concatenate([[0], apf3d.ravel(), aer_apf.ravel()]))
    if used.size < table.n_pf:
        remap = np.zeros(table.n_pf, dtype=np.int32)
        remap[used] = np.arange(used.size, dtype=np.int32)
        table = table.take_rows(used)
        apf3d = remap[apf3d]
        aer_apf = remap[aer_apf]

    if pfpeak is not None and pfpeak > 0:
        # Pho_pfpeak: clamp working eval rows (1..) at pfpeak and spread the
        # clipped energy uniformly (keeps int P dmu = 2)
        pe = np.array(table.p_eval, dtype=np.float64)
        n_m = pe.shape[1]
        edges = np.empty(n_m + 1)
        mu_grid = np.linspace(-1.0, 1.0, n_m)
        edges[1:-1] = 0.5 * (mu_grid[1:] + mu_grid[:-1])
        edges[0], edges[-1] = -1.0, 1.0
        widths = np.diff(edges)
        clipped = np.maximum(pe[1:] - pfpeak, 0.0)
        resid = clipped @ widths
        pe[1:] = np.minimum(pe[1:], pfpeak) + resid[:, None] / 2.0
        table = dataclasses.replace(table, p_eval=pe.astype(np.float32))

    # scattering majorant per layer
    sig_maj = sig_ray + sig_aer.sum(axis=1)
    if has_3d:
        ext_max = np.max(ext3d, axis=(0, 1))
        sig_maj = sig_maj.copy()
        sig_maj[iz3l:iz3l + nz3] += ext_max
    sig_maj = np.maximum(sig_maj, 1e-12).astype(np.float32)

    # a Surface of either package (jsfc/psfc maps), or a scalar albedo
    sfc = surface if hasattr(surface, 'jsfc') \
        else sfc_lambertian(float(surface))

    sza = np.deg2rad(solar_zenith_angle)
    # photon azimuth of travel, radians from +x (east), counterclockwise
    phi_travel = np.deg2rad(270.0 - solar_azimuth_angle)

    leaves = dict(
        z_lev=np.asarray(atm.lev.altitude * 1000.0, dtype=np.float32),
        sig_ray=sig_ray, kabs=kabs, sig_maj=sig_maj, sig_aer=sig_aer,
        aer_ssa=aer_ssa.astype(np.float32), aer_apf=aer_apf.astype(np.int32),
        ext3d=ext3d, ssa3d=ssa3d, apf3d=apf3d, cf3d=cf3d,
        pt_mu=table.mu_sample,
        # rows [0, Npf) = working eval rows; [Npf, 2 Npf) = TMS rows
        pt_p=np.concatenate(
            [table.p_eval,
             table.p_tms if table.p_tms is not None else table.p_eval],
            axis=0),
        jsfc=np.asarray(sfc.jsfc, dtype=np.int32),
        psfc=np.asarray(sfc.psfc, dtype=np.float32),
        mu0=np.asarray(np.cos(sza), dtype=np.float32),
        phi0=np.asarray(phi_travel, dtype=np.float32),
    )
    static = SceneStatic(
        nz=nz, ng=ng, nx=nx, ny=ny, nz3=nz3, iz3l=iz3l,
        nxs=sfc.nx, nys=sfc.ny, dx=float(dx), dy=float(dy),
        has_3d=has_3d, has_aer1d=bool(aer_1ds), ipa=bool(ipa),
        ns3=int(ssa3d.shape[-1]),
        sfc_lambertian=bool(np.all(np.asarray(sfc.jsfc) == SFC_LAMBERTIAN)),
    )
    return leaves, static

#!/usr/bin/env python
"""OCO-2 O2 A-band radiance simulation on the PyTorch/CUDA port
(er3t_tpu_torch): projects/01_oco2_rad_sim.py with its runs on ``--device``
(the card unless ``cpu`` is asked for), writing to
projects/output_torch/01/ — twin of the reference's
projects/01_oco2_rad-sim.py.

Reference pipeline (the reference's projects/01_oco2_rad-sim.py:1518-1771):
main_pre (granule download + COT/CER retrieval at 250 m) -> main_sim
(cal_mca_rad: abs_oco_idl O2 A-band k-distribution, 2D surface, cld_gen_cop
cloud, MCARaTS 3D vs IPA) -> main_post (simulated vs OCO-2 L1B comparison).

Here the same pipeline runs in-framework: the O2 A-band k-distribution comes
from an IDL save when provided (--idl, er3t_tpu_torch.pre.abs_oco) or the
database-free synthetic generator; the ocean surface is typed Cox-Munk
sun glint (the reference's DSM type); 3D and IPA runs share one scene.

    python projects/01_oco2_rad_sim_torch.py --photons 1e6
    python projects/01_oco2_rad_sim_torch.py --l1b oco2_L1bScND_*.h5 \
           --idl o2a_v1.out --extent -60.5 -59.5 14.5 15.5
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from er3t_tpu_torch.pre.atm import atm_atmmod
from er3t_tpu_torch.pre.abs import abs_synthetic
from er3t_tpu_torch.pre.cld import cld_gen_cop
from er3t_tpu_torch.pre.pha import pha_mie_wc
from er3t_tpu_torch.pre.sfc import sfc_ocean
from er3t_tpu_torch.rtm import solver
from er3t_tpu_torch.util.logger import get_logger

LOG = get_logger()


def main_pre(args):
    """Granule -> along-track COT/CER maps (or a synthetic scene).

    The retrieved cloud map is re-registered before the 3D run with the
    reference's correction chain (cdata_cld_ipa,
    the reference's projects/01_oco2_rad-sim.py:1024-1100): parallax by
    (CTH - sfc) tan(VZA) along the sensor azimuth plus steering-wind
    advection over the imager-to-sensor time offset
    (er3t_tpu_torch.apps.cldpos.correct_cloud_map).
    """
    obs = None
    if args.l1b:
        from er3t_tpu_torch.sat.oco2 import oco2_rad_nadir
        obj = oco2_rad_nadir(args.l1b, extent=tuple(args.extent))
        spec = np.asarray(obj.data['rad']['data'])  # (Nsound*8, Nsamp) —
        #                                 the reader flattens the 8 across-
        #                                 track footprints; spectra stay
        # continuum radiance per footprint: bright-percentile over the
        # spectral samples (the reference uses the O2 A-band continuum
        # channels; a high percentile is the absorption-free level)
        rad = (np.nanpercentile(spec, 90, axis=-1)
               if spec.ndim == 2 and spec.shape[-1] > 8 else spec.ravel())
        ns = rad.size // 8
        obs = rad[:ns * 8].reshape(ns, 8)        # for main_post's
        #                                          per-footprint comparison
        LOG.framework(f'OCO-2 L1B: {ns} soundings x 8 footprints')
        # continuum-normalized reflectance -> COT first guess via the
        # IPA curve (reference cdata_cld_ipa, 01_oco2_rad-sim.py:1712-1737)
        atm = atm_atmmod(np.concatenate([np.arange(0, 3.0, 0.5),
                                 np.arange(3.0, 20.1, 1.0)]))
        from er3t_tpu_torch.apps.lut import func_ref_vs_cot
        curve = func_ref_vs_cot(atm, wavelength=args.wavelength,
                                solar_zenith_angle=args.sza,
                                photons=args.photons / 10,
                                device=args.device)
        mu0 = np.cos(np.deg2rad(args.sza))
        # pi L / (E_toa mu0): the curve's reflectance convention (its
        # .toa is the TOA irradiance in framework units — convert real
        # photon-count L1B radiances with sat.oco2.photon_to_radiance
        # first)
        ref = rad * np.pi / (curve.toa * mu0)
        n = min(args.nx * args.nx, ref.size)
        cot = np.zeros(args.nx * args.nx)
        cot[:n] = curve.get_cot_from_ref(np.clip(ref.ravel()[:n], 0, None))
        cot = cot.reshape(args.nx, args.nx)
    else:
        LOG.framework('no granule given; synthesizing a broken-cloud track')
        rng = np.random.default_rng(27)
        nx = args.nx
        cot = np.zeros((nx, nx))
        ii, jj = np.meshgrid(np.arange(nx), np.arange(nx), indexing='ij')
        for _ in range(10):
            i, j = rng.integers(4, nx - 4, 2)
            r = rng.integers(2, 7)
            cot[(ii - i) ** 2 + (jj - j) ** 2 <= r ** 2] = rng.uniform(3, 25)
    cer = np.where(cot > 0, 12.0, 0.0)
    cth = np.where(cot > 0, args.cth, 0.0)
    # per-mode registration (reference cdata_cld_ipa): the 3D run gets
    # parallax + wind; the IPA run keeps the apparent (parallax-biased)
    # positions and takes the wind correction only, since the IPA forward
    # model sees the same parallax the imager did
    maps = {'3d': (cot, cer, cth), 'ipa': (cot, cer, cth)}
    if args.vza or args.wind_u or args.wind_v:
        from er3t_tpu_torch.apps.cldpos import correct_cloud_map
        for mode in maps:
            c, e, h, _ = correct_cloud_map(
                cot, cer, cth, sfh_km=0.0, vza_deg=args.vza,
                vaa_deg=args.vaa, u10=args.wind_u, v10=args.wind_v,
                dt_s=args.dt, dx_km=args.dx, dy_km=args.dx, mode=mode)
            maps[mode] = (c, e, h)
        LOG.framework(
            f'cloud map re-registered (parallax vza={args.vza:.1f} '
            f'vaa={args.vaa:.1f} for the 3D run; wind '
            f'{args.wind_u:.1f},{args.wind_v:.1f} m/s over {args.dt:.0f} s '
            f'for both)')
    return maps, obs


def main_sim(maps, args):
    """3D + IPA O2 A-band radiance over a Cox-Munk ocean."""
    atm = atm_atmmod(np.concatenate([np.arange(0, 3.0, 0.5),
                                 np.arange(3.0, 20.1, 1.0)]))
    if args.idl:
        from er3t_tpu_torch.pre.abs_oco import abs_oco_idl
        ab = abs_oco_idl(args.wavelength, atm, args.idl)
        LOG.framework(f'abs_oco_idl: {ab.ng} g at {ab.wvl:.2f} nm')
    else:
        ab = abs_synthetic(args.wavelength, atm)
        LOG.framework(f'synthetic A-band k-distribution at {ab.wvl:.1f} nm')

    pha = pha_mie_wc(args.wavelength)
    sfc = sfc_ocean(wvl=args.wavelength, u10=args.u10)

    out = {}
    for mode in ('3d', 'ipa'):
        cot, cer, cth = maps[mode]
        cld = cld_gen_cop(cot, cer, np.where(cth > 0, cth, 0.0),
                          dx=args.dx, dy=args.dx, dz=0.5)
        res = solver.solve(
            atm=atm, abs_coef=ab, cld=cld, pha=pha, surface=sfc,
            target='radiance', solver=mode, forward_trunc_deg=20.0,
            tile_size=16, solar_zenith_angle=args.sza,
            solar_azimuth_angle=45.0, photons=args.photons, n_run=1,
            seed=11, device=args.device)
        out[mode] = res['rad'][..., 0] if res['rad'].ndim == 3 else res['rad']
        LOG.framework(f'{mode}: mean radiance {out[mode].mean():.4f}')
    return out


def main_post(cot, out, args, obs=None):
    """Per-footprint sim-vs-obs comparison (reference main_post,
    01_oco2_rad-sim.py:1773-...): OCO-2 samples 8 across-track footprints
    per sounding; the simulated image is sampled at the footprint columns
    and compared per footprint — against the L1B continuum radiance when a
    granule was given (``obs``), else 3D vs IPA footprint-by-footprint."""
    os.makedirs(args.outdir, exist_ok=True)
    track = out['3d'][:, out['3d'].shape[1] // 2]
    track_ipa = out['ipa'][:, out['ipa'].shape[1] // 2]
    # 8 across-track footprint columns centered mid-swath
    ny = out['3d'].shape[1]
    fp_cols = (ny // 2 - 4) + np.arange(8)
    fp_sim = out['3d'][:, fp_cols]               # (along-track, 8)
    fp_ipa = out['ipa'][:, fp_cols]
    fp = {'sim_3d': fp_sim, 'sim_ipa': fp_ipa, 'columns': fp_cols}
    if obs is not None:
        n = min(obs.shape[0], fp_sim.shape[0])
        fp['obs'] = obs[:n]
        with np.errstate(invalid='ignore', divide='ignore'):
            scale = np.nanmedian(obs[:n] / np.maximum(fp_sim[:n], 1e-30))
        fp['obs_over_sim_median'] = float(scale)
        LOG.framework(f'per-footprint obs/sim median = {scale:.3f} '
                      f'({n} soundings x 8 footprints)')
    try:
        import matplotlib
        matplotlib.use('Agg')
        import matplotlib.pyplot as plt
        fig, (a0, a1, a2) = plt.subplots(1, 3, figsize=(15, 4))
        im = a0.imshow(out['3d'].T, origin='lower', cmap='viridis')
        fig.colorbar(im, ax=a0, label='radiance')
        a0.set_title(f'O2 A-band 3D radiance ({args.wavelength:.1f} nm)')
        a1.plot(track, label='3D')
        a1.plot(track_ipa, label='IPA', ls='--')
        a1.set_xlabel('along-track pixel')
        a1.set_ylabel('radiance')
        a1.legend()
        a1.set_title('nadir track: 3D vs IPA')
        # per-footprint panel: obs vs sim when a granule was given, else
        # the 3D-vs-IPA footprint scatter (8 across-track footprints)
        ref_fp = fp.get('obs', fp_ipa)
        a2.plot([0, max(fp_sim.max(), 1e-9)], [0, max(fp_sim.max(), 1e-9)],
                'k-', lw=0.7)
        for k in range(8):
            n = min(ref_fp.shape[0], fp_sim.shape[0])
            a2.plot(fp_sim[:n, k], ref_fp[:n, k], '.', ms=3,
                    label=f'fp{k}' if k in (0, 7) else None)
        a2.set_xlabel('simulated 3D radiance')
        a2.set_ylabel('observed' if 'obs' in fp else 'IPA')
        a2.set_title('per-footprint comparison')
        a2.legend(fontsize=7)
        fig.tight_layout()
        fn = os.path.join(args.outdir, 'oco2_aband_rad.png')
        fig.savefig(fn, dpi=130)
        LOG.framework(f'saved {fn}')
    except Exception as e:                        # headless-safe
        LOG.framework(f'plotting skipped: {e}')
    np.savez(os.path.join(args.outdir, 'oco2_aband_rad.npz'),
             cot=cot, rad_3d=out['3d'], rad_ipa=out['ipa'], **{
                 f'fp_{k}': v for k, v in fp.items()
                 if isinstance(v, np.ndarray)})
    return track, track_ipa


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--l1b', default='', help='OCO-2 L1bScND granule (.h5)')
    ap.add_argument('--idl', default='', help='O2 A-band k-dist IDL save')
    ap.add_argument('--extent', nargs=4, type=float,
                    default=[-60.5, -59.5, 14.5, 15.5])
    ap.add_argument('--wavelength', type=float, default=768.5)
    ap.add_argument('--photons', type=float, default=1e6)
    ap.add_argument('--nx', type=int, default=64)
    ap.add_argument('--dx', type=float, default=0.25)
    ap.add_argument('--sza', type=float, default=30.0)
    ap.add_argument('--u10', type=float, default=5.0, help='wind speed m/s')
    ap.add_argument('--cth', type=float, default=2.5,
                    help='cloud-top height for the retrieved map [km]')
    ap.add_argument('--vza', type=float, default=0.0,
                    help='imager viewing zenith for parallax correction')
    ap.add_argument('--vaa', type=float, default=0.0,
                    help='imager viewing azimuth (deg clockwise from N)')
    ap.add_argument('--wind-u', type=float, default=0.0,
                    help='steering wind east [m/s] for advection correction')
    ap.add_argument('--wind-v', type=float, default=0.0,
                    help='steering wind north [m/s]')
    ap.add_argument('--dt', type=float, default=0.0,
                    help='imager-to-sensor time offset [s]')
    ap.add_argument('--outdir', default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), 'output_torch', '01'))
    ap.add_argument('--device', default='cuda',
                    help='torch device of the runs (cpu only when asked)')
    args = ap.parse_args()

    maps, obs = main_pre(args)
    out = main_sim(maps, args)
    main_post(maps['3d'][0], out, args, obs=obs)


if __name__ == '__main__':
    main()

#!/usr/bin/env python
"""Aircraft flight-track irradiance simulation on the PyTorch/CUDA port
(er3t_tpu_torch): projects/03_spns_flux_sim.py with its runs on
``--device`` (the card unless ``cpu`` is asked for), writing to
projects/output_torch/03/ — twin of the reference's
projects/03_spns_flux-sim.py.

Reference pipeline (the reference's projects/03_spns_flux-sim.py:440-622,
CAMP2Ex): Himawari/AHI cloud retrievals -> 3D cloud field -> MCARaTS flux
target -> downwelling/upwelling irradiance sampled along the P-3 flight
track at aircraft altitude, compared with the SPNS radiometer.

Here: AHI L2 granules feed ``cld_sat`` when given (--ahi); otherwise a
synthetic broken-cloud field stands in.  The solver runs the flux target
with per-column tallies for both 3D and IPA modes; the track is a
parametric path across the domain at a constant altitude.

    python projects/03_spns_flux_sim_torch.py --photons 1e6 --alt 5.0
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from er3t_tpu_torch.pre.atm import atm_atmmod
from er3t_tpu_torch.pre.abs import abs_synthetic
from er3t_tpu_torch.pre.cld import cld_sat
from er3t_tpu_torch.pre.pha import pha_mie_wc
from er3t_tpu_torch.rtm import solver
from er3t_tpu_torch.util.logger import get_logger

LOG = get_logger()


def main_pre(args):
    """AHI granule (or synthetic field) -> gridded cot/cer maps."""
    if args.ahi:
        from er3t_tpu_torch.sat.ahi import ahi_l2
        obj = ahi_l2([args.ahi], extent=tuple(args.extent),
                     nx=args.nx, ny=args.nx)
        cot = obj.data['cot_2d']['data']
        cer = np.where(cot > 0, obj.data['cer_2d']['data'], 0.0)
        LOG.framework(f'AHI granule gridded to {cot.shape}')
        return cot, cer
    LOG.framework('no AHI granule; synthesizing a cumulus field')
    rng = np.random.default_rng(5)
    nx = args.nx
    cot = np.zeros((nx, nx))
    ii, jj = np.meshgrid(np.arange(nx), np.arange(nx), indexing='ij')
    for _ in range(16):
        i, j = rng.integers(3, nx - 3, 2)
        r = rng.integers(2, 5)
        cot[(ii - i) ** 2 + (jj - j) ** 2 <= r ** 2] = rng.uniform(4, 30)
    cer = np.where(cot > 0, 10.0, 0.0)
    return cot, cer


def main_sim(cot, cer, args):
    """Per-column 3D + IPA fluxes at the flight wavelength."""
    atm = atm_atmmod(np.concatenate([np.arange(0, 3.0, 0.5),
                                     np.arange(3.0, 20.1, 1.0)]))
    ab = abs_synthetic(args.wavelength, atm)
    cld = cld_sat(cot_2d=cot, cer_2d=cer, dx=args.dx, dy=args.dx,
                  cth=2.0, cgt=1.0, dz=0.5)
    pha = pha_mie_wc(args.wavelength)

    out = {}
    for mode in ('3d', 'ipa'):
        res = solver.solve(
            atm=atm, abs_coef=ab, cld=cld, pha=pha, surface=0.06,
            target='flux', solver=mode, flux_per_column=True,
            solar_zenith_angle=args.sza, solar_azimuth_angle=45.0,
            photons=args.photons, n_run=1, seed=7, device=args.device)
        out[mode] = res
        LOG.framework(f"{mode}: TOA-down {res['f_down'][..., -1].mean():.4f} "
                      f"W/m2/nm; sfc-down {res['f_down'][..., 0].mean():.4f}")
    out['z_lev'] = atm.lev.altitude
    return out


def flight_track(nx, n_pts=200):
    """Parametric diagonal-with-wiggle track in grid coordinates."""
    t = np.linspace(0.0, 1.0, n_pts)
    fx = np.clip((0.1 + 0.8 * t) * nx, 0, nx - 1)
    fy = np.clip((0.2 + 0.6 * t + 0.08 * np.sin(6.28 * 3 * t)) * nx, 0, nx - 1)
    return fx.astype(int), fy.astype(int)


def main_post(out, args):
    os.makedirs(args.outdir, exist_ok=True)
    z_lev = out['z_lev']
    iz = int(np.argmin(np.abs(z_lev - args.alt)))
    nx = out['3d']['f_down'].shape[0]
    fx, fy = flight_track(nx)
    tracks = {}
    for mode in ('3d', 'ipa'):
        tracks[mode + '_down'] = out[mode]['f_down'][fx, fy, iz]
        tracks[mode + '_up'] = out[mode]['f_up'][fx, fy, iz]
    LOG.framework(f'track at z={z_lev[iz]:.1f} km: 3D f_down '
                  f'{tracks["3d_down"].mean():.4f} +/- {tracks["3d_down"].std():.4f}')
    try:
        import matplotlib
        matplotlib.use('Agg')
        import matplotlib.pyplot as plt
        fig, (a0, a1) = plt.subplots(1, 2, figsize=(11, 4))
        im = a0.imshow(out['3d']['f_down'][:, :, iz].T, origin='lower',
                       cmap='cividis')
        a0.plot(fx, fy, 'r-', lw=1)
        fig.colorbar(im, ax=a0, label='F_down [W/m2/nm]')
        a0.set_title(f'downwelling irradiance at {z_lev[iz]:.1f} km')
        a1.plot(tracks['3d_down'], label='3D F_down')
        a1.plot(tracks['ipa_down'], ls='--', label='IPA F_down')
        a1.plot(tracks['3d_up'], label='3D F_up')
        a1.set_xlabel('track sample')
        a1.set_ylabel('irradiance [W/m2/nm]')
        a1.legend()
        fig.tight_layout()
        fn = os.path.join(args.outdir, 'spns_track_flux.png')
        fig.savefig(fn, dpi=130)
        LOG.framework(f'saved {fn}')
    except Exception as e:
        LOG.framework(f'plotting skipped: {e}')
    np.savez(os.path.join(args.outdir, 'spns_track_flux.npz'), **tracks)
    return tracks


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--ahi', default='', help='AHI CLP L2 granule (.nc)')
    ap.add_argument('--extent', nargs=4, type=float,
                    default=[120.0, 122.0, 15.0, 17.0])
    ap.add_argument('--wavelength', type=float, default=532.0)
    ap.add_argument('--photons', type=float, default=1e6)
    ap.add_argument('--nx', type=int, default=48)
    ap.add_argument('--dx', type=float, default=0.5)
    ap.add_argument('--sza', type=float, default=25.0)
    ap.add_argument('--alt', type=float, default=5.0,
                    help='aircraft altitude [km]')
    ap.add_argument('--outdir', default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), 'output_torch', '03'))
    ap.add_argument('--device', default='cuda',
                    help='torch device of the runs (cpu only when asked)')
    args = ap.parse_args()

    cot, cer = main_pre(args)
    out = main_sim(cot, cer, args)
    main_post(out, args)


if __name__ == '__main__':
    main()

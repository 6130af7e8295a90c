#!/usr/bin/env python
"""Camera-imagery COT -> nadir radiance simulation on the PyTorch/CUDA port
(er3t_tpu_torch): projects/04_cam_nadir_rad_sim.py with its runs on
``--device`` (the card unless ``cpu`` is asked for), writing to
projects/output_torch/04/ — twin of the reference's
projects/04_cam_nadir_rad-sim.py.

Reference pipeline (the reference's projects/04_cam_nadir_rad-sim.py:341-742):
all-sky-camera red-channel imagery -> COT retrieval (IPA lookup curve, and a
CNN variant) -> 3D nadir radiance simulation at 600 nm -> radiance closure
against the input imagery.

Here the same closure runs in-framework: a 600 nm radiance image (given via
--image .npz with 'rad', or forward-simulated from a synthetic cumulus
truth) is inverted to COT with the IPA reflectance-vs-COT curve
(er3t_tpu_torch.apps.lut.func_ref_vs_cot — the reference's func_ref_vs_cot
twin),
the retrieved COT drives 3D and IPA nadir radiance sims, and main_post
reports the closure error.  The CNN retrieval variant of the reference is
a training exercise on top of the same LUT machinery (see
projects/05_cnn_les_factory_torch.py for the training-set generator).

    python projects/04_cam_nadir_rad_sim_torch.py --photons 1e6
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
from er3t_tpu_torch.rtm import solver
from er3t_tpu_torch.util.logger import get_logger

LOG = get_logger()


def _atm():
    return atm_atmmod(np.concatenate([np.arange(0, 3.0, 0.5),
                                      np.arange(3.0, 20.1, 1.0)]))


def _simulate(cot, cer, args, mode='3d', seed=13):
    atm = _atm()
    ab = abs_synthetic(args.wavelength, atm)
    cld = cld_gen_cop(cot, cer, np.where(cot > 0, 2.0, 0.0),
                      dx=args.dx, dy=args.dx, dz=0.5)
    pha = pha_mie_wc(args.wavelength)
    res = solver.solve(atm=atm, abs_coef=ab, cld=cld, pha=pha,
                       surface=args.albedo, target='radiance', solver=mode,
                       forward_trunc_deg=20.0, tile_size=16,
                       solar_zenith_angle=args.sza, solar_azimuth_angle=45.0,
                       photons=args.photons, n_run=1, seed=seed,
                       device=args.device)
    return res['rad'][..., 0] if res['rad'].ndim == 3 else res['rad']


def main_pre(args):
    """Radiance image -> retrieved COT map (IPA curve inversion)."""
    if args.image:
        rad_obs = np.load(args.image)['rad']
        LOG.framework(f'loaded camera image {rad_obs.shape}')
    else:
        LOG.framework('no image given; forward-simulating a synthetic truth')
        rng = np.random.default_rng(8)
        nx = args.nx
        cot_true = np.zeros((nx, nx))
        ii, jj = np.meshgrid(np.arange(nx), np.arange(nx), indexing='ij')
        for _ in range(12):
            i, j = rng.integers(3, nx - 3, 2)
            r = rng.integers(2, 6)
            cot_true[(ii - i) ** 2 + (jj - j) ** 2 <= r ** 2] = \
                rng.uniform(2, 30)
        cer_true = np.where(cot_true > 0, 10.0, 0.0)
        rad_obs = _simulate(cot_true, cer_true, args, mode='3d', seed=99)

    # Per-pixel IPA retrieval curve (reference func_ref_vs_cot_multi_pixel,
    # mca/util.py:218 — the variant the reference's camera pipeline uses:
    # small multi-pixel scenes per COT node, Nrun statistics, cubic
    # inversion); --fast-curve falls back to the single-IPA-scene variant
    atm = _atm()
    if getattr(args, 'fast_curve', False):
        from er3t_tpu_torch.apps.lut import func_ref_vs_cot
        curve = func_ref_vs_cot(atm, wavelength=args.wavelength, cer0=10.0,
                                solar_zenith_angle=args.sza,
                                surface_albedo=args.albedo,
                                photons=max(args.photons / 4, 2e5), seed=3,
                                device=args.device)
    else:
        from er3t_tpu_torch.apps.lut import func_ref_vs_cot_multi_pixel
        curve = func_ref_vs_cot_multi_pixel(
            np.concatenate([[0.0], np.logspace(-1, np.log10(60), 16)]),
            atm=atm, wavelength=args.wavelength, cer0=10.0,
            solar_zenith_angle=args.sza, surface_albedo=args.albedo,
            photons=max(args.photons / 8, 1e5), n_run=2, seed=3,
            device=args.device)
    ab = abs_synthetic(args.wavelength, atm)
    mu0 = np.cos(np.deg2rad(args.sza))
    toa = float(np.sum(ab.solar * ab.weight))
    ref_obs = np.pi * rad_obs / (toa * mu0)
    cot_ret = curve.get_cot_from_ref(ref_obs.ravel()).reshape(rad_obs.shape)
    # clear-sky mask at the curve's COT=0 reflectance (+MC-noise margin)
    ref_clear = float(curve.ref[0])
    cot_ret = np.where(ref_obs > 1.25 * ref_clear, cot_ret, 0.0)
    LOG.framework(f'retrieved COT: mean {cot_ret.mean():.2f}, '
                  f'cloud fraction {(cot_ret > 0.1).mean():.2f}')
    return rad_obs, cot_ret


def main_sim(cot_ret, args):
    cer = np.where(cot_ret > 0, 10.0, 0.0)
    out = {}
    for mode in ('3d', 'ipa'):
        out[mode] = _simulate(cot_ret, cer, args, mode=mode, seed=13)
        LOG.framework(f'{mode}: mean nadir radiance {out[mode].mean():.4f}')
    return out


def main_post(rad_obs, cot_ret, out, args):
    os.makedirs(args.outdir, exist_ok=True)
    err = (out['3d'].mean() - rad_obs.mean()) / max(rad_obs.mean(), 1e-12)
    LOG.framework(f'radiance closure (3D sim vs input image): {err:+.2%}')
    try:
        import matplotlib
        matplotlib.use('Agg')
        import matplotlib.pyplot as plt
        fig, axs = plt.subplots(1, 3, figsize=(14, 4))
        for ax, (arr, title) in zip(axs, [
                (rad_obs, 'input radiance (camera)'),
                (cot_ret, 'retrieved COT (IPA curve)'),
                (out['3d'], 'simulated nadir radiance (3D)')]):
            im = ax.imshow(arr.T, origin='lower', cmap='viridis')
            fig.colorbar(im, ax=ax)
            ax.set_title(title)
        fig.tight_layout()
        fn = os.path.join(args.outdir, 'cam_nadir_rad.png')
        fig.savefig(fn, dpi=130)
        LOG.framework(f'saved {fn}')
    except Exception as e:
        LOG.framework(f'plotting skipped: {e}')
    np.savez(os.path.join(args.outdir, 'cam_nadir_rad.npz'),
             rad_obs=rad_obs, cot_ret=cot_ret,
             rad_3d=out['3d'], rad_ipa=out['ipa'])
    return err


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--image', default='',
                    help='.npz with a 600 nm radiance image under key "rad"')
    ap.add_argument('--wavelength', type=float, default=600.0)
    ap.add_argument('--photons', type=float, default=1e6)
    ap.add_argument('--fast-curve', action='store_true',
                    help='single-IPA-scene retrieval curve (faster)')
    ap.add_argument('--nx', type=int, default=48)
    ap.add_argument('--dx', type=float, default=0.25)
    ap.add_argument('--sza', type=float, default=30.0)
    ap.add_argument('--albedo', type=float, default=0.05)
    ap.add_argument('--outdir', default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), 'output_torch', '04'))
    ap.add_argument('--device', default='cuda',
                    help='torch device of the runs (cpu only when asked)')
    args = ap.parse_args()

    rad_obs, cot_ret = main_pre(args)
    out = main_sim(cot_ret, args)
    main_post(rad_obs, cot_ret, out, args)


if __name__ == '__main__':
    main()

"""Sun-glint + Libera-ADM radiance examples on the PyTorch/CUDA port
(er3t_tpu_torch): examples/02_er3t_tpu_lrt_rad.py, the sun-glint solves on
``--device`` (the card unless ``cpu`` is asked for) — twins of the
reference's
``00_er3t_lrt.py`` radiance cases (example_rad_01_sun_glint /
example_rad_02_libera_adm, the reference's examples/00_er3t_lrt.py:488-766).

Case 1 (sun glint): TOA radiance at 532 nm over a wind-roughened ocean
(Cox-Munk BRDF, u10 = 1 m/s — the reference's ``brdf_cam u10 1``) versus
viewing azimuth at SZA=VZA=60: the glint lobe peaks in the forward
(anti-solar-azimuth) direction.  Engine: the MC solver's typed Cox-Munk
surface (pre/sfc.py sfc_ocean + rtm/brdf.py), one solve per azimuth.

Case 2 (Libera ADM, Gristey et al. 2023 fig. 8d role): TOA reflectance of a
COT=10 / CER=12 um liquid cloud versus viewing azimuth at VZA=45, at 555 nm
and integrated over the VIS band (350-700 nm) — the angular-distribution
model (anisotropy) curve.  Engine: the doubling-adding solver, which
returns all azimuths of a Fourier-mode expansion in one call.

Writes ``examples/output_torch/02_lrt_rad.png`` (``plot``).

Usage: python examples/02_er3t_tpu_torch_lrt_rad.py [--fast] [--device cpu]
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from er3t_tpu_torch.apps.spectral import _layers          # layer builder
from er3t_tpu_torch.pre.abs import abs_synthetic
from er3t_tpu_torch.pre.atm import atm_atmmod
from er3t_tpu_torch.pre.sfc import sfc_ocean
from er3t_tpu_torch.rtm import solver
from er3t_tpu_torch.rtm.oned import solve_plane_parallel
from er3t_tpu_torch.rtm.out import spectral_factors

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   'output_torch')


def sun_glint(wvl0=532.0, sza0=60.0, saa0=0.0, vza0=60.0, vaa=None,
              photons=6e4, fast=False, device='cuda'):
    atm = atm_atmmod(np.linspace(0, 20, 11))
    ab = abs_synthetic(wvl0, atm)
    sfc = sfc_ocean(wvl=wvl0, u10=1.0, nx=1, ny=1)
    if vaa is None:
        vaa = np.arange(0.0, 361.0, 30.0 if fast else 15.0)
    rad = np.zeros(vaa.size)
    for i, v in enumerate(vaa):
        res = solver.solve(atm=atm, abs_coef=ab, surface=sfc,
                           target='radiance', solar_zenith_angle=sza0,
                           solar_azimuth_angle=saa0,
                           sensor_zenith_angle=vza0,
                           sensor_azimuth_angle=float(v),
                           photons=photons, n_run=1, seed=11 + i,
                           batch=1 << 12, device=device)
        rad[i] = float(np.mean(res['rad']))
        print(f'#   glint vaa={v:5.1f}: rad {rad[i]:.4g}', flush=True)
    return vaa, rad


def libera_adm(sza0=60.0, saa0=0.0, vza0=45.0, cot0=10.0, cer0=12.0,
               fast=False):
    atm = atm_atmmod(np.linspace(0, 20, 21))
    vaa = np.arange(0.0, 361.0, 5.0)
    wvl = np.arange(350.0, 701.0, 50.0 if fast else 10.0)
    mu0 = float(np.cos(np.deg2rad(sza0)))
    muv = float(np.cos(np.deg2rad(vza0)))
    dphi = np.deg2rad(vaa - saa0)
    cld = dict(cloud_base=0.5, cloud_top=1.0, cloud_optical_thickness=cot0,
               cloud_effective_radius=cer0)
    rad = np.zeros((wvl.size, vaa.size))
    toa = np.zeros(wvl.size)
    for i, w in enumerate(wvl):
        ab = abs_synthetic(float(w), atm)
        factors, toa_i = spectral_factors(ab, nz_out=1)
        toa[i] = toa_i * mu0
        for g in range(ab.ng):
            tau, ssa, mom = _layers(atm, ab, g, float(w), cld, None, 96)
            r = solve_plane_parallel(tau, ssa, mom, mu0, muv, dphi,
                                     surface_albedo=0.03,
                                     n_streams=8 if fast else 16)
            rad[i] += factors[0][g] * np.atleast_1d(r)
        print(f'#   adm {w:5.0f} nm done', flush=True)
    ref = np.pi * rad / toa[:, None]
    i555 = int(np.abs(wvl - 555.0).argmin())
    band = rad.sum(axis=0) / max(wvl.size, 1)
    adm_vis = band / band.mean()
    return vaa, ref[i555], adm_vis, wvl


def plot(vaa_g, rad_g, vaa_a, ref555, adm_vis):
    """Draw both cases into ``OUT``/02_lrt_rad.png; returns the file
    name."""
    os.makedirs(OUT, exist_ok=True)
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(11, 4.6))
    ax1 = fig.add_subplot(121, projection='polar')
    ax1.plot(np.deg2rad(vaa_g), rad_g, 'r-', lw=1.2)
    ax1.scatter([np.deg2rad(0.0)], [max(rad_g) * 1.1], s=250, c='orange')
    ax1.set_theta_zero_location('N')
    ax1.set_theta_direction(-1)
    ax1.set_title('sun glint: 532 nm, SZA=VZA=60$^\\circ$, Cox-Munk u10=1')

    ax2 = fig.add_subplot(122, projection='polar')
    ax2.plot(np.deg2rad(vaa_a), ref555, 'C0', label='reflectance 555 nm')
    ax2.plot(np.deg2rad(vaa_a), adm_vis, 'C1',
             label='VIS-band anisotropy (ADM)')
    ax2.set_theta_zero_location('N')
    ax2.set_theta_direction(-1)
    ax2.set_title('Libera ADM: COT=10, VZA=45$^\\circ$')
    ax2.legend(loc='lower left', fontsize=7)

    fig.tight_layout()
    fn = os.path.join(OUT, '02_lrt_rad.png')
    fig.savefig(fn, dpi=130)
    return fn


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--fast', action='store_true')
    ap.add_argument('--device', default='cuda',
                    help='torch device of the solves (cpu only when asked)')
    args = ap.parse_args()

    print('# case 1: sun glint (Cox-Munk u10=1) ...', flush=True)
    vaa_g, rad_g = sun_glint(fast=args.fast, device=args.device)
    print('# case 2: Libera ADM (COT=10, VZA=45) ...', flush=True)
    vaa_a, ref555, adm_vis, wvl = libera_adm(fast=args.fast)
    print(f'# wrote {plot(vaa_g, rad_g, vaa_a, ref555, adm_vis)}')


if __name__ == '__main__':
    main()

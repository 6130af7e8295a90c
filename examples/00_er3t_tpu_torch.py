#!/usr/bin/env python
"""Canonical end-to-end examples on the PyTorch/CUDA port (er3t_tpu_torch):
cases 01-06 of examples/00_er3t_tpu.py, with the same scenes and solve
arguments, run on ``--device`` (the card unless ``cpu`` is asked for):

  01  clear-sky flux profile (IPA)
  02  LES-cloud 3D flux fields
  03  + 1D aerosol layer
  04  + 3D aerosol field
  05  LES-cloud nadir radiance with Mie phase (the headline workload)
  06  synthetic hemispherical-cloud radiance

All data is generated in-framework: the LES scene falls back to a synthetic
broken-cloud field when no LES netCDF is given (the reference's les.nc is a
separate download).  Images go to examples/output_torch/.  Each case
function returns its solve result.  Run:

    python examples/00_er3t_tpu_torch.py 01 05 --photons 1e6
    python examples/00_er3t_tpu_torch.py 01 --photons 3e4 --device cpu
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from er3t_tpu_torch.pre.atm import atm_atmmod
from er3t_tpu_torch.pre.abs import abs_16g
from er3t_tpu_torch.pre.aer import aer_gen
from er3t_tpu_torch.pre.cld import cld_gen_hem, cld_les
from er3t_tpu_torch.pre.pha import pha_mie_wc
from er3t_tpu_torch.rtm import solver
from er3t_tpu_torch.util.logger import get_logger
from er3t_tpu_torch.vis import plot_flux_profile, quicklook_radiance

LOG = get_logger()
OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   'output_torch')


def _atm_cloudres():
    levels = np.concatenate([np.arange(0, 3.0, 0.5), np.arange(3.0, 20.1, 1.0)])
    return atm_atmmod(levels)


def _les_or_synthetic(fname_les=None, coarsen=(1, 1, 25)):
    if fname_les and os.path.exists(fname_les):
        return cld_les(fname_les, coarsen=coarsen)
    LOG.framework('no LES file; generating synthetic broken-cloud field')
    return cld_gen_hem(nx=480, ny=480, nz=4, dx=0.1, dy=0.1, dz=0.5,
                       cloud_frac_tgt=0.25, radii=(0.5, 1.0, 2.0),
                       cot_scale=15.0, cloud_base=0.5, seed=7)


def example_01_flux_clear_sky(photons, fname_les=None, device='cuda'):
    atm = atm_atmmod(np.linspace(0, 20, 21))
    ab = abs_16g(650.0, atm)
    res = solver.solve(atm=atm, abs_coef=ab, surface=0.03, target='flux',
                       solar_zenith_angle=30.0, photons=photons, n_run=3,
                       device=device)
    plot_flux_profile(res.data, atm.lev.altitude,
                      fname=f'{OUT}/01_flux_clear_sky.png',
                      title='Clear-sky flux profile, 650 nm')
    LOG.framework('01: sfc f_down=%.3f W/m2/nm, TOA f_up=%.3f',
                  float(np.squeeze(res["f_down"])[0]),
                  float(np.squeeze(res["f_up"])[-1]))
    return res


def _flux_les(photons, fname_les, aer_1ds=(), aer_3ds=(), tag='02',
              device='cuda'):
    atm = _atm_cloudres()
    ab = abs_16g(650.0, atm)
    cld = _les_or_synthetic(fname_les)
    res = solver.solve(atm=atm, abs_coef=ab, cld=cld, aer_1ds=aer_1ds,
                       aer_3ds=aer_3ds, surface=0.03, target='flux',
                       solar_zenith_angle=30.0, photons=photons, n_run=3,
                       device=device)
    quicklook_radiance(np.squeeze(res['f_up'])[..., -1],
                       fname=f'{OUT}/{tag}_fup_toa.png',
                       title=f'{tag}: TOA upwelling flux')
    LOG.framework('%s: domain-mean TOA f_up=%.3f W/m2/nm', tag,
                  float(np.squeeze(res['f_up'])[..., -1].mean()))
    return res


def example_02_flux_les_cloud_3d(photons, fname_les=None, device='cuda'):
    return _flux_les(photons, fname_les, tag='02', device=device)


def example_03_flux_with_aerosol_1d(photons, fname_les=None, device='cuda'):
    aer = aer_gen(aod=0.4, ssa=0.9, asy=0.7, z_bottom=3.0, z_top=5.0)
    return _flux_les(photons, fname_les, aer_1ds=[aer], tag='03',
                     device=device)


def example_04_flux_with_aerosol_3d(photons, fname_les=None, device='cuda'):
    cld = _les_or_synthetic(fname_les)
    aod2d = 0.4 * (1.0 + 0.5 * np.sin(np.linspace(0, 4 * np.pi, cld.nx)))[:, None] \
        * np.ones((1, cld.ny))
    aer = aer_gen(aod=0.0, ssa=0.9, asy=0.7, aod_2d=aod2d, nz=cld.nz)
    return _flux_les(photons, fname_les, aer_3ds=[aer], tag='04',
                     device=device)


def example_05_rad_les_cloud_3d(photons, fname_les=None, device='cuda'):
    atm = _atm_cloudres()
    ab = abs_16g(650.0, atm)
    cld = _les_or_synthetic(fname_les)
    pha = pha_mie_wc(650.0)
    res = solver.solve(atm=atm, abs_coef=ab, cld=cld, pha=pha, surface=0.03,
                       target='radiance', solar_zenith_angle=30.0,
                       solar_azimuth_angle=45.0, photons=photons, n_run=3,
                       forward_trunc_deg=5.0, device=device)
    quicklook_radiance(res['rad'], fname=f'{OUT}/05_rad_les.png',
                       title='Nadir radiance, 650 nm (Mie)')
    LOG.framework('05: radiance mean=%.4f max=%.4f W/m2/nm/sr',
                  res['rad'].mean(), res['rad'].max())
    return res


def example_06_rad_cld_gen_hem(photons, fname_les=None, device='cuda'):
    atm = _atm_cloudres()
    ab = abs_16g(650.0, atm)
    cld = cld_gen_hem(nx=200, ny=200, nz=4, dx=0.1, dy=0.1, dz=0.5,
                      cloud_frac_tgt=0.3, radii=(0.4, 0.8, 1.6),
                      w2h_ratio=1.5, cot_scale=25.0, cloud_base=0.8, seed=3)
    pha = pha_mie_wc(650.0)
    res = solver.solve(atm=atm, abs_coef=ab, cld=cld, pha=pha, surface=0.03,
                       target='radiance', solar_zenith_angle=45.0,
                       solar_azimuth_angle=0.0, photons=photons, n_run=3,
                       forward_trunc_deg=5.0, device=device)
    quicklook_radiance(res['rad'], fname=f'{OUT}/06_rad_hem.png',
                       title='Hemispherical-cloud nadir radiance')
    LOG.framework('06: radiance mean=%.4f', res['rad'].mean())
    return res


EXAMPLES = {
    '01': example_01_flux_clear_sky,
    '02': example_02_flux_les_cloud_3d,
    '03': example_03_flux_with_aerosol_1d,
    '04': example_04_flux_with_aerosol_3d,
    '05': example_05_rad_les_cloud_3d,
    '06': example_06_rad_cld_gen_hem,
}


def main():
    p = argparse.ArgumentParser(description=__doc__)
    # no default list here: Python 3.12's argparse checks a list default of
    # nargs='*' against the choices as one value and rejects it
    p.add_argument('cases', nargs='*', choices=list(EXAMPLES),
                   help='cases to run (default: 01)')
    p.add_argument('--photons', type=float, default=1e6)
    p.add_argument('--les', default=None, help='optional LES netCDF path')
    p.add_argument('--device', default='cuda',
                   help='torch device of the runs (cpu only when asked)')
    args = p.parse_args()
    os.makedirs(OUT, exist_ok=True)
    for case in args.cases or ['01']:
        LOG.tic(case)
        EXAMPLES[case](args.photons, args.les, device=args.device)
        LOG.toc(case, n_items=args.photons, unit='photons')


if __name__ == '__main__':
    main()

#!/usr/bin/env python
"""Satellite-granule radiance simulation on the PyTorch/CUDA port
(er3t_tpu_torch): projects/02_sat_rad_sim.py with its runs on ``--device``
(the card unless ``cpu`` is asked for), writing to
projects/output_torch/02/ — twin of the reference's
projects/02_modis_rad-sim.py.

Pipeline: main_pre (granule -> gridded cot/cer/surface) -> main_sim (3D and
IPA radiance at 650 nm) -> main_post (simulated vs observed comparison).

Works with MODIS (pyhdf) or VIIRS (h5py) cloud products; with no granule it
demonstrates the pipeline on a synthetic retrieval field so the workflow is
always runnable.

    python projects/02_sat_rad_sim_torch.py --cldprop CLDPROP_L2...nc \
           --extent -60.5 -59.5 14.5 15.5 --photons 1e7
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from er3t_tpu_torch.pre.abs import abs_synthetic
from er3t_tpu_torch.pre.atm import atm_atmmod
from er3t_tpu_torch.pre.cld import cld_sat
from er3t_tpu_torch.pre.pha import pha_mie_wc
from er3t_tpu_torch.rtm import solver
from er3t_tpu_torch.util.logger import get_logger
from er3t_tpu_torch.vis import compare_data_2d, quicklook_radiance

LOG = get_logger()


def main_pre(args):
    """Granule -> gridded cloud retrieval maps."""
    if args.cldprop:
        from er3t_tpu_torch.sat.viirs import viirs_cldprop_l2
        obj = viirs_cldprop_l2([args.cldprop], extent=tuple(args.extent),
                               nx=args.nx, ny=args.nx)
        return obj
    LOG.framework('no granule given; synthesizing a retrieval field')
    rng = np.random.default_rng(2)
    nx = args.nx
    cot = np.zeros((nx, nx))
    for _ in range(14):
        i, j = rng.integers(4, nx - 4, 2)
        r = rng.integers(2, 6)
        ii, jj = np.meshgrid(np.arange(nx), np.arange(nx), indexing='ij')
        cot[(ii - i) ** 2 + (jj - j) ** 2 <= r ** 2] = rng.uniform(5, 40)

    class _Obj:
        data = {
            'cot_2d': {'data': cot, 'name': 'COT', 'units': 'N/A'},
            'cer_2d': {'data': np.where(cot > 0, 12.0, 0.0),
                       'name': 'CER', 'units': 'um'},
        }
    return _Obj()


def main_sim(sat_obj, args):
    cld = cld_sat(sat_obj, dx=0.25, dy=0.25, cth=args.cth, cgt=1.0, dz=0.5)
    levels = np.concatenate([np.arange(0, 3.0, 0.5), np.arange(3.0, 20.1, 1.0)])
    atm = atm_atmmod(levels)
    ab = abs_synthetic(args.wavelength, atm)
    pha = pha_mie_wc(args.wavelength)
    out = {}
    for mode in ('3d', 'ipa'):
        res = solver.solve(atm=atm, abs_coef=ab, cld=cld, pha=pha,
                           surface=args.albedo, target='radiance', solver=mode,
                           solar_zenith_angle=args.sza,
                           solar_azimuth_angle=args.saa,
                           photons=args.photons, n_run=3,
                           forward_trunc_deg=5.0, device=args.device)
        out[mode] = res
        LOG.framework('%s: mean radiance %.4f W/m2/nm/sr', mode,
                      res['rad'].mean())
    return cld, out


def main_post(cld, results, outdir):
    os.makedirs(outdir, exist_ok=True)
    quicklook_radiance(results['3d']['rad'], fname=f'{outdir}/rad_3d.png',
                       title='3D radiance')
    quicklook_radiance(results['ipa']['rad'], fname=f'{outdir}/rad_ipa.png',
                       title='IPA radiance')
    compare_data_2d(results['ipa']['rad'], results['3d']['rad'],
                    labels=('IPA', '3D'), fname=f'{outdir}/ipa_vs_3d.png')
    diff = results['3d']['rad'] - results['ipa']['rad']
    LOG.framework('3D-IPA bias: %.4f (cloudy pixels: %.4f)', diff.mean(),
                  diff[cld.cloud_mask_2d].mean())


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument('--cldprop', default=None, help='cloud-product granule')
    p.add_argument('--extent', nargs=4, type=float,
                   default=[-60.5, -59.5, 14.5, 15.5])
    p.add_argument('--nx', type=int, default=64)
    p.add_argument('--wavelength', type=float, default=650.0)
    p.add_argument('--sza', type=float, default=30.0)
    p.add_argument('--saa', type=float, default=45.0)
    p.add_argument('--cth', type=float, default=2.0)
    p.add_argument('--albedo', type=float, default=0.03)
    p.add_argument('--photons', type=float, default=1e6)
    p.add_argument('--outdir', default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), 'output_torch', '02'))
    p.add_argument('--device', default='cuda',
                   help='torch device of the runs (cpu only when asked)')
    args = p.parse_args()

    sat = main_pre(args)
    cld, results = main_sim(sat, args)
    main_post(cld, results, args.outdir)


if __name__ == '__main__':
    main()

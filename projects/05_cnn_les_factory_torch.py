#!/usr/bin/env python
"""CNN training-set factory on the PyTorch/CUDA port (er3t_tpu_torch):
projects/05_cnn_les_factory.py with its runs on ``--device`` (the card
unless ``cpu`` is asked for), writing to projects/output_torch/05/ — twin
of the reference's projects/05_cnn-les_rad-sim.py.

The reference builds CNN training data for radiance->COT retrievals: an
IPA COT<->radiance lookup curve, LES scenes at several coarsenings, 3D
radiance simulations, and 64x64 tile crops pairing true COT fields with
simulated radiance (reference docstring, projects/05:1-26).

Self-contained version: synthetic broken-cloud scenes stand in for the LES
snapshots (pass --les for real ones), the IPA curve comes from
apps.lut.func_ref_vs_cot, and tiles are written to an .npz archive.
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from er3t_tpu_torch.apps.lut import func_ref_vs_cot
from er3t_tpu_torch.pre.abs import abs_synthetic
from er3t_tpu_torch.pre.atm import atm_atmmod
from er3t_tpu_torch.pre.cld import cld_gen_hem, cld_les
from er3t_tpu_torch.pre.pha import pha_mie_wc
from er3t_tpu_torch.rtm import solver
from er3t_tpu_torch.util.logger import get_logger

LOG = get_logger()


def make_scene(seed, coarsen=1, fname_les=None):
    if fname_les:
        return cld_les(fname_les, coarsen=(coarsen, coarsen, 25))
    nx = 480 // coarsen
    cld = cld_gen_hem(nx=nx, ny=nx, nz=4, dx=0.1 * coarsen, dy=0.1 * coarsen,
                      dz=0.5, cloud_frac_tgt=0.3, radii=(0.5, 1.0, 2.0),
                      cot_scale=20.0, cloud_base=0.5, seed=seed)
    return cld


def tiles(cot_2d, rad_2d, size=64, threshold=0.05):
    """Crop aligned (COT, radiance) tiles with enough cloud in them
    (reference tile selection, projects/05 run_mca_coarse_case)."""
    nx, ny = cot_2d.shape
    out = []
    for i in range(0, nx - size + 1, size):
        for j in range(0, ny - size + 1, size):
            c = cot_2d[i:i + size, j:j + size]
            r = rad_2d[i:i + size, j:j + size]
            if (c > 0).mean() >= threshold:
                out.append((c, r))
    return out


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument('--photons', type=float, default=2e6)
    p.add_argument('--scenes', type=int, default=2)
    p.add_argument('--coarsen', type=int, nargs='+', default=[1, 2])
    p.add_argument('--les', default=None)
    p.add_argument('--out', default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), 'output_torch', '05',
        'cnn_les_training.npz'))
    p.add_argument('--device', default='cuda',
                   help='torch device of the runs (cpu only when asked)')
    args = p.parse_args()

    levels = np.concatenate([np.arange(0, 3.0, 0.5), np.arange(3.0, 20.1, 1.0)])
    atm = atm_atmmod(levels)
    ab = abs_synthetic(650.0, atm)
    pha = pha_mie_wc(650.0)

    LOG.framework('building IPA COT<->radiance curve')
    curve = func_ref_vs_cot(atm, wavelength=650.0,
                            photons=max(args.photons / 4, 1e5),
                            device=args.device)

    all_cot, all_rad = [], []
    for seed in range(args.scenes):
        for cf in args.coarsen:
            LOG.tic('scene')
            cld = make_scene(seed, coarsen=cf, fname_les=args.les)
            res = solver.solve(atm=atm, abs_coef=ab, cld=cld, pha=pha,
                               surface=0.03, target='radiance',
                               solar_zenith_angle=30.0,
                               solar_azimuth_angle=45.0,
                               photons=args.photons, n_run=1, seed=seed,
                               forward_trunc_deg=5.0, device=args.device)
            # 64x64-PIXEL tiles at every coarsening (the reference mixes
            # coarsenings at constant tile pixel size — a coarse tile just
            # covers a larger footprint; projects/05 run_mca_coarse_case)
            for c, r in tiles(cld.cot_2d, res['rad'], size=64):
                all_cot.append(c)
                all_rad.append(r)
            LOG.toc('scene', n_items=args.photons, unit='photons')

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    np.savez_compressed(args.out,
                        cot=np.stack(all_cot) if all_cot else np.zeros((0,)),
                        rad=np.stack(all_rad) if all_rad else np.zeros((0,)),
                        ipa_cot=curve.cot, ipa_ref=curve.ref,
                        ipa_ref_2s=curve.ref_2s)
    LOG.framework('wrote %d tiles to %s', len(all_cot), args.out)


if __name__ == '__main__':
    main()

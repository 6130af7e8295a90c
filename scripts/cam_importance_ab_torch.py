"""Camera launch-importance A/B (port of scripts/cam_importance_ab.py:1-67):
the per-pixel variance of the ground fisheye camera's image at a fixed
photon budget, uniform launch against the 50/50 camera-centred
wrapped-Gaussian mixture (SolverConfig.cam_importance_sigma), several
seeds.

The scene is the source's (:33-43): 32 x 32 columns of 0.5 km, its own
levels, a Henyey-Greenstein cloud (no Mie table), surface albedo 0.1; a
16-pixel camera at the centre with ``cam_qmax``; sigma 0, 1, 2 and 4 km,
each at ``seeds`` seeds of ``photons`` photons at 2^12 lanes.  The source
ran on the CPU; this runs on the card unless ``--device cpu``.  The
variance ratio between sigmas is physics, so it should repeat whatever
the device.

python scripts/cam_importance_ab_torch.py [photons] [seeds] [qmax]
    [--device cpu]
"""
import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bench_torch import card  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('photons', nargs='?', type=float, default=100_000)
    ap.add_argument('seeds', nargs='?', type=int, default=8)
    ap.add_argument('qmax', nargs='?', type=float, default=85.0)
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args()
    dev = card(args.device)
    from er3t_tpu_torch.pre.abs import abs_synthetic
    from er3t_tpu_torch.pre.atm import atm_atmmod
    from er3t_tpu_torch.pre.cld import cld_gen_hem
    from er3t_tpu_torch.rtm.scene import build_scene
    from er3t_tpu_torch.rtm.mc import SolverConfig
    from er3t_tpu_torch.rtm.mc_flight import run_transport_flight

    n_ph = int(args.photons)
    n_seed = args.seeds
    qmax = args.qmax

    atm = atm_atmmod(np.concatenate([np.arange(0, 5.0, 0.5),
                                     np.arange(5.0, 20.1, 1.0)]))
    ab = abs_synthetic(650.0, atm)
    # 16x16 km broken-cloud sky over a central camera: most of the domain
    # is far from the camera's effective footprint
    cld = cld_gen_hem(nx=32, ny=32, nz=3, dx=0.5, dy=0.5, dz=0.5,
                      cloud_frac_tgt=0.3, radii=(1.0, 2.0),
                      cot_scale=8.0, cloud_base=1.0, seed=5)
    scn, st = build_scene(atm, ab, cld=cld, surface=0.1,
                          solar_zenith_angle=40.0, solar_azimuth_angle=0.0,
                          forward_trunc_deg=20.0, device=dev)

    for sig in (0.0, 1.0, 2.0, 4.0):
        cfg = SolverConfig(target='radiance', batch=1 << 12,
                           sensor_type='camera', cam_npix=16, cam_qmax=qmax,
                           cam_importance_sigma=sig, n_scat_max=400)
        imgs = []
        t0 = time.time()
        for s in range(n_seed):
            tal = run_transport_flight(scn, st, cfg, n_ph, 100 + s, dev)
            imgs.append((tal.rad.cpu().numpy() @ ab.weight)
                        / int(tal.n_launched))
        wall = time.time() - t0
        imgs = np.stack(imgs)
        mean = imgs.mean(axis=0)
        var = imgs.var(axis=0, ddof=1)
        # fisheye-active pixels only
        act = mean > 0
        print(f'sigma={sig:.1f}: mean={mean[act].mean():.5e}  '
              f'pixvar={var[act].mean():.4e}  '
              f'rel={var[act].mean():.3e}  wall={wall:.0f}s', flush=True)


if __name__ == '__main__':
    main()

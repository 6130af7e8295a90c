"""Interleaved A/B on the card: phase-table bins x truncation (port of
scripts/tpu_r5_sweep.py:1-119).

* bins: 2048 (production) against 1024 and 512.  The source expected its
  phase-pair kernel's cost to scale with the table rows; on the card the
  kernel is a dependent gather of two table entries a lane, a small part
  of a host-bound step, so this asks whether fewer bins move ms/step at
  all, and what they do to the mean.
* truncation: t20 against t25/t30/t35 with TMS rows.  Deeper truncation
  removes scattering events and weakens the majorant (fewer steps a
  photon); first-order local estimates stay exact (TMS rows), only
  order >= 2 is approximated.

The Mie table and the cloud are made once, then seven scenes through
build_scene(..., phase_bins=); configs interleaved across rounds.  Each
round records photons/s, steps and the domain-mean radiance (the bias
gauge against t20/2048 across seeds).

`python -u scripts/r5_sweep_torch.py [photons_per_chunk] [rounds]
[--warm 5e4] [--device cpu]`
"""
import argparse
import os
import sys
import time
from collections import defaultdict

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bench_torch import card, devices, gases, sync  # noqa: E402

CONFIGS = [
    ('t20_b2048', 20.0, None),     # production base
    ('t20_b1024', 20.0, 1024),
    ('t20_b512', 20.0, 512),
    ('t25_b2048', 25.0, None),
    ('t30_b2048', 30.0, None),
    ('t35_b2048', 35.0, None),
    ('t30_b1024', 30.0, 1024),     # combined candidate
]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('photons', nargs='?', type=float, default=4_000_000)
    ap.add_argument('rounds', nargs='?', type=int, default=4)
    ap.add_argument('--warm', type=float, default=50_000)
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args()
    dev = card(args.device)
    print('devices:', devices(dev), flush=True)

    from er3t_tpu_torch.pre.cld import cld_gen_hem
    from er3t_tpu_torch.pre.pha import pha_mie_wc
    from er3t_tpu_torch.rtm.scene import build_scene
    from er3t_tpu_torch.rtm.mc import SolverConfig
    from er3t_tpu_torch.rtm.mc_flight import run_transport_flight
    from er3t_tpu_torch.rtm.out import spectral_factors

    chunk = int(args.photons)
    rounds = args.rounds

    atm, ab = gases()
    cld = cld_gen_hem(nx=480, ny=480, nz=4, dx=0.1, dy=0.1, dz=0.5,
                      cloud_frac_tgt=0.25, radii=(0.5, 1.0, 2.0),
                      cot_scale=15.0, cloud_base=0.5, seed=7)
    pha = pha_mie_wc(650.0)           # Mie once, tables per config

    scenes = {}
    for name, trunc, bins in CONFIGS:
        scenes[name] = build_scene(
            atm, ab, cld=cld, pha=pha, surface=0.03,
            solar_zenith_angle=30.0, solar_azimuth_angle=45.0,
            forward_trunc_deg=trunc, phase_bins=bins, device=dev)
        print(f'built {name}', flush=True)

    cfg = SolverConfig(target='radiance', batch=1 << 17, n_scat_max=600,
                       tile_size=16, use_pallas=True, qmc_launch=True)
    factors, _ = spectral_factors(ab, nz_out=1)
    rad_w = factors[0]

    def run(name, n, seed):
        scene, st = scenes[name]
        sync(dev)
        t0 = time.time()
        tal = run_transport_flight(scene, st, cfg, n, seed, dev, rad_w=rad_w)
        img = tal.rad.cpu().numpy()               # on the host: the run is done
        sync(dev)
        dt = time.time() - t0
        return (int(tal.n_launched) / dt, int(tal.n_steps),
                float(img.sum() / max(int(tal.n_launched), 1)), dt)

    for name, _, _ in CONFIGS:
        t0 = time.time()
        run(name, int(args.warm), 0)
        print(f'warm {name}: {time.time()-t0:.1f}s', flush=True)

    res = defaultdict(list)
    for r in range(rounds):
        for name, _, _ in CONFIGS:
            rate, steps, mean, dt = run(name, chunk, 10 + r)
            res[name].append((rate, steps, mean))
            print(f'r{r} {name}: {rate/1e6:.3f}M ph/s  steps={steps}  '
                  f'mean={mean:.6e}  ({dt:.1f}s)', flush=True)

    print('\n== summary (median rate | median steps | mean rad +- seed sd) ==')
    base_mean = np.mean([m for _, _, m in res['t20_b2048']])
    for name, _, _ in CONFIGS:
        rates = [x[0] for x in res[name]]
        steps = [x[1] for x in res[name]]
        means = [x[2] for x in res[name]]
        print(f'{name}: {np.median(rates)/1e6:.3f}M ph/s  '
              f'steps={int(np.median(steps))}  '
              f'mean={np.mean(means):.6e} +- {np.std(means):.2e}  '
              f'vs_base={np.mean(means)/base_mean - 1:+.3%}', flush=True)


if __name__ == '__main__':
    main()

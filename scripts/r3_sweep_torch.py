"""Batch x tile sweep of the production radiance config and per-column flux
baselines on the card (port of scripts/tpu_r3_sweep.py:1-70).

At pinned steps (max_events) on the bench scene at 20 degrees of
truncation: six radiance configs (tile 8/16/32 x batch 2^17/2^18, with
use_pallas and rad_w) and four flux configs (per-column kx 4 and 8 with
flux_w, kx 4 with use_pallas, and the domain average); 3 rounds,
interleaved.  Prints ms/step, photons launched a step and the photons/s
they imply.

`python -u scripts/r3_sweep_torch.py [--steps 300] [--device cpu]`
"""
import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from bench_torch import card, devices, gases, sync  # noqa: E402
from profile_ablate_torch import build  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--steps', type=int, default=300)
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args()
    dev = card(args.device)
    print('devices:', devices(dev), flush=True)
    from er3t_tpu_torch.rtm.mc import SolverConfig
    from er3t_tpu_torch.rtm.mc_flight import run_transport_flight
    from er3t_tpu_torch.rtm.out import spectral_factors

    n_steps = args.steps
    scene, st = build(device=dev)
    _, ab = gases()
    rw = spectral_factors(ab, nz_out=1)[0][0]
    fw = spectral_factors(ab, nz_out=st.nz + 1)[0]

    # ---- radiance: tile x batch sweep with use_pallas and rad_w ----
    rad_cfgs = []
    for tile in (8, 16, 32):
        for b_log in (17, 18):
            rad_cfgs.append((f'rad-t{tile}-b{b_log}',
                             SolverConfig(target='radiance', batch=1 << b_log,
                                          n_scat_max=600, tile_size=tile,
                                          max_events=n_steps, use_pallas=True),
                             rw, None))
    # ---- flux per-column baselines ----
    flux_base = dict(target='flux', batch=1 << 17, n_scat_max=600,
                     tile_size=16, max_events=n_steps, flux_per_column=True)
    flux_cfgs = [
        ('flux-kx4      ', SolverConfig(**flux_base, flux_kcross=4), None, fw),
        ('flux-kx8      ', SolverConfig(**flux_base, flux_kcross=8), None, fw),
        ('flux-kx4-pal  ', SolverConfig(**flux_base, flux_kcross=4,
                                        use_pallas=True), None, fw),
        ('flux-domavg   ', SolverConfig(**{**flux_base,
                                           'flux_per_column': False}), None, None),
    ]
    configs = rad_cfgs + flux_cfgs
    res = {n: [] for n, *_ in configs}
    la = {}
    for rnd in range(3):
        for name, cfg, rad_w, flux_w in configs:
            sync(dev)
            t0 = time.time()
            tal = run_transport_flight(scene, st, cfg, 1 << 30, rnd, dev,
                                       rad_w=rad_w, flux_w=flux_w)
            _ = (tal.rad if cfg.target == 'radiance' else tal.flux).cpu()
            sync(dev)
            dt = time.time() - t0
            steps = int(tal.n_steps)
            res[name].append(dt / max(steps, 1) * 1000)
            la[name] = int(tal.n_launched) / max(steps, 1)
            print(f'r{rnd} {name}: {dt:6.2f}s = {dt/max(steps,1)*1e3:6.2f} ms/step '
                  f'launched={int(tal.n_launched)/1e6:.2f}M ({la[name]:.0f}/step)',
                  flush=True)
    print('\nmedian ms/step | photons/step | ph/s estimate:')
    for name in res:
        m = np.median(res[name])
        print(f'  {name}: {m:6.2f} ms/step  {la[name]:7.0f}/step  '
              f'{la[name]/m*1000/1e6:5.2f}M ph/s')


if __name__ == '__main__':
    main()

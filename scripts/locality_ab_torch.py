"""Interleaved A/B on the card: gather-locality levers (port of
scripts/tpu_locality_ab.py:1-86).

Measures ms/step at a pinned step count for the production radiance config
with rad_w with (a) coherent stratified launch (SolverConfig.launch_coherent),
(b) periodic lane re-sort by voxel column (sort_every), and (c) both; plus
the per-column flux config with the same levers.
`python -u scripts/locality_ab_torch.py [steps] [--device cpu]`
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
    ap.add_argument('steps', nargs='?', type=int, default=300)
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
    B = 1 << 17
    rb = dict(target='radiance', batch=B, n_scat_max=600, tile_size=16,
              max_events=n_steps, use_pallas=True)
    fb = dict(target='flux', batch=B, n_scat_max=600, tile_size=16,
              max_events=n_steps, flux_per_column=True, flux_kcross=4)
    configs = [
        ('rad-base     ', SolverConfig(**rb), rw, None),
        ('rad-coh      ', SolverConfig(**rb, launch_coherent=True), rw, None),
        ('rad-sort8    ', SolverConfig(**rb, launch_coherent=True,
                                       sort_every=8), rw, None),
        ('rad-sort16   ', SolverConfig(**rb, launch_coherent=True,
                                       sort_every=16), rw, None),
        ('rad-sort4    ', SolverConfig(**rb, launch_coherent=True,
                                       sort_every=4), rw, None),
        ('flux-base    ', SolverConfig(**fb), None, fw),
        ('flux-coh     ', SolverConfig(**fb, launch_coherent=True), None, fw),
        ('flux-sort8   ', SolverConfig(**fb, launch_coherent=True,
                                       sort_every=8), None, fw),
        ('flux-sort4   ', SolverConfig(**fb, launch_coherent=True,
                                       sort_every=4), None, fw),
    ]
    res = {n: [] for n, *_ in configs}
    la = {}
    for rnd in range(3):
        for name, cfg, w, f in configs:
            t0 = time.time()
            tal = run_transport_flight(scene, st, cfg, 1 << 30, rnd, dev,
                                       rad_w=w, flux_w=f)
            _ = tal.rad[:1, :1].cpu(), tal.flux[:1, :1, :1].cpu()
            sync(dev)
            dt = time.time() - t0
            steps = int(tal.n_steps)
            res[name].append(dt / steps * 1000)
            la[name] = int(tal.n_launched) / steps
            print(f'r{rnd} {name}: {dt:6.2f}s = {dt/steps*1e3:6.2f} ms/step '
                  f'launched={int(tal.n_launched)/1e6:.1f}M '
                  f'({la[name]:.0f}/step)', flush=True)
    print('\nmedian ms/step | photons/step | ph/s estimate:')
    for name in res:
        m = np.median(res[name])
        print(f'  {name}: {m:6.2f} ms/step  {la[name]:8.0f}/step  '
              f'{la[name]/m*1000/1e6:5.2f}M ph/s')


if __name__ == '__main__':
    main()

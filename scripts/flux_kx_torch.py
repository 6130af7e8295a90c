"""Per-column flux kx sweep on the card (port of scripts/tpu_flux_kx.py:1-63).

The crossing-count clamp trades tally rows (kx per lane-iteration) against
extra clamp iterations; this finds the sweet spot at 480x480.
`python -u scripts/flux_kx_torch.py [steps] [--device cpu]`
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
    fw = spectral_factors(ab, nz_out=st.nz + 1)[0]
    base = dict(target='flux', batch=1 << 17, n_scat_max=600, tile_size=16,
                max_events=n_steps, flux_per_column=True)
    configs = [(f'kx{k}', SolverConfig(**base, flux_kcross=k))
               for k in (2, 3, 4, 6)]
    configs.append(('domavg', SolverConfig(**{**base,
                                              'flux_per_column': False})))
    res = {n: [] for n, *_ in configs}
    la = {}
    for rnd in range(3):
        for name, cfg in configs:
            t0 = time.time()
            tal = run_transport_flight(scene, st, cfg, 1 << 30, rnd, dev,
                                       flux_w=fw if cfg.flux_per_column
                                       else None)
            _ = tal.flux[:1, :1, :1].cpu()
            sync(dev)
            dt = time.time() - t0
            res[name].append(dt / n_steps * 1000)
            la[name] = int(tal.n_launched) / n_steps
            print(f'r{rnd} {name}: {dt:6.2f}s = {dt/n_steps*1e3:6.2f} ms/step '
                  f'({la[name]:.0f}/step)', flush=True)
    print('\nmedian ms/step | ph/s estimate:')
    for name in res:
        m = np.median(res[name])
        print(f'  {name}: {m:6.2f} ms/step  {la[name]/m*1000/1e6:5.2f}M ph/s')


if __name__ == '__main__':
    main()

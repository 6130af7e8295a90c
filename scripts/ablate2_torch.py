"""Ablation profile of the production radiance config with rad_w on the
card (port of scripts/tpu_ablate2.py:1-77).

The follow-up to profile_ablate_torch.py under the production config:
use_pallas (which the port ignores: its phase-pair kernel is on every path)
and rad_w (scalar deposits).  The reference's ``use_pallas=False`` on the
phase-ablated rows is kept as written.
`python -u scripts/ablate2_torch.py [steps] [--device cpu]`
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
    scene1, st1 = build(ng=1, device=dev)
    rw = spectral_factors(gases()[1], nz_out=1)[0][0]
    rw1 = spectral_factors(gases(ng=1)[1], nz_out=1)[0][0]
    B = 1 << 17
    base = dict(target='radiance', batch=B, n_scat_max=600, tile_size=16,
                max_events=n_steps, use_pallas=True)
    configs = [
        ('full        ', scene, st, SolverConfig(**base), rw),
        ('no-deposit  ', scene, st, SolverConfig(**base, ablate='deposit'), rw),
        ('no-vox      ', scene, st, SolverConfig(**base, ablate='vox'), rw),
        ('no-phase    ', scene, st,
         SolverConfig(**{**base, 'use_pallas': False}, ablate='phase'), rw),
        ('tile0       ', scene, st,
         SolverConfig(**{**base, 'tile_size': 0}), rw),
        ('ng1         ', scene1, st1, SolverConfig(**base), rw1),
        ('floor       ', scene, st,
         SolverConfig(**{**base, 'use_pallas': False},
                      ablate='vox,phase,deposit'), rw),
    ]
    res = {n: [] for n, *_ in configs}
    for rnd in range(3):
        for name, scn, stt, cfg, w in configs:
            t0 = time.time()
            tal = run_transport_flight(scn, stt, cfg, 1 << 30, rnd, dev,
                                       rad_w=w)
            _ = tal.rad[:1, :1].cpu()
            sync(dev)
            dt = time.time() - t0
            res[name].append(dt / n_steps * 1000)
            print(f'r{rnd} {name}: {dt:6.2f}s = {dt/n_steps*1e3:6.2f} ms/step '
                  f'launched={int(tal.n_launched)/1e6:.1f}M', flush=True)
    print('\nmedian ms/step (B=131072, pallas+srad):')
    full = np.median(res['full        '])
    for name in res:
        m = np.median(res[name])
        print(f'  {name}: {m:6.2f} ms/step   delta vs full {full - m:+6.2f}')


if __name__ == '__main__':
    main()

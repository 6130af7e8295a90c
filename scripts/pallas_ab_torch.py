"""Interleaved A/B on the card: use_pallas x in-step radiance contraction
(port of scripts/tpu_pallas_ab.py:1-70).

Pins the loop at a fixed step count (max_events, as profile_ablate_torch
does) and compares ms/step of four configs on the bench scene at 20
degrees of truncation: neither, rad_w (scalar image deposits), use_pallas,
and both; 3 rounds, interleaved; each run's image mean per photon.  On
the card ``use_pallas`` is ignored (the phase-pair kernel runs in every
config), so only the rad_w halves differ: per-g deposits into an
(nx, ny, 16) image against scalar deposits into an (nx, ny) one.

`python -u scripts/pallas_ab_torch.py [steps] [--device cpu]`
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
    B = 1 << 17
    base = dict(target='radiance', batch=B, n_scat_max=600, tile_size=16,
                max_events=n_steps)
    configs = [
        ('xla         ', SolverConfig(**base), None),
        ('scalar-rad  ', SolverConfig(**base), rw),
        ('pallas      ', SolverConfig(**base, use_pallas=True), None),
        ('pallas+srad ', SolverConfig(**base, use_pallas=True), rw),
    ]
    res = {n: [] for n, *_ in configs}
    ref = {}
    for rnd in range(3):
        for name, cfg, rad_w in configs:
            sync(dev)
            t0 = time.time()
            tal = run_transport_flight(scene, st, cfg, 1 << 30, rnd, dev,
                                       rad_w=rad_w)
            img = tal.rad.cpu().numpy()
            sync(dev)
            dt = time.time() - t0
            res[name].append(dt / n_steps * 1000)
            s = float((img @ rw if img.shape[-1] > 1 else img[..., 0]).sum()) \
                / max(int(tal.n_launched), 1)
            ref[name] = s
            print(f'r{rnd} {name}: {dt:6.2f}s = {dt/n_steps*1e3:6.2f} ms/step '
                  f'launched={int(tal.n_launched)/1e6:.1f}M mean={s:.4e}',
                  flush=True)
    print('\nmedian ms/step (B=131072):')
    for name in res:
        print(f'  {name}: {np.median(res[name]):6.2f} ms/step  mean={ref[name]:.4e}')


if __name__ == '__main__':
    main()

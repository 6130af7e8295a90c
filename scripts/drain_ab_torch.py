"""Drain-compaction A/B on the card (port of scripts/tpu_drain_ab.py:1-101).

Configs: truncation {t20, t25} x drain_compact {off, on}, interleaved
across rounds (thermal and clock drift cancel).  4M-photon chunks hit the
drain tail hard; production 8-32M chunks amortize less often but pay the
same tail per call.

`python -u scripts/drain_ab_torch.py [photons] [rounds] [--device cpu]`
"""
import argparse
import os
import sys
import time
from collections import defaultdict

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bench_torch import card, devices, scene_inputs, sync  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('photons', nargs='?', type=float, default=4_000_000)
    ap.add_argument('rounds', nargs='?', type=int, default=6)
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args()
    dev = card(args.device)
    print('devices:', devices(dev), flush=True)

    from er3t_tpu_torch.rtm.scene import build_scene
    from er3t_tpu_torch.rtm.mc import SolverConfig
    from er3t_tpu_torch.rtm.mc_flight import run_transport_flight
    from er3t_tpu_torch.rtm.out import spectral_factors

    chunk = int(args.photons)
    rounds = args.rounds

    atm, ab, kw = scene_inputs()
    scenes = {}
    for tr in (20.0, 25.0):
        scenes[tr] = build_scene(atm, ab, **{**kw, 'forward_trunc_deg': tr},
                                 device=dev)
    factors, _ = spectral_factors(ab, nz_out=1)
    rad_w = factors[0]

    CONFIGS = [(f't{tr:.0f}_dc{int(dc)}', tr, dc)
               for tr in (20.0, 25.0) for dc in (False, True)]

    def cfg_for(dc):
        return SolverConfig(target='radiance', batch=1 << 17, n_scat_max=600,
                            tile_size=16, use_pallas=True, qmc_launch=True,
                            drain_compact=dc)

    def run(tr, dc, n, seed):
        scene, st = scenes[tr]
        sync(dev)
        t0 = time.time()
        tal = run_transport_flight(scene, st, cfg_for(dc), n, seed, dev,
                                   rad_w=rad_w)
        img = tal.rad.cpu().numpy()
        sync(dev)
        dt = time.time() - t0
        return (int(tal.n_launched) / dt, int(tal.n_steps),
                float(img.sum() / max(int(tal.n_launched), 1)), dt)

    for name, tr, dc in CONFIGS:
        t0 = time.time()
        run(tr, dc, 50_000, 0)
        print(f'warm {name}: {time.time()-t0:.1f}s', flush=True)

    res = defaultdict(list)
    for r in range(rounds):
        for name, tr, dc in CONFIGS:
            rate, steps, mean, dt = run(tr, dc, chunk, 10 + r)
            res[name].append((rate, steps, mean))
            print(f'r{r} {name}: {rate/1e6:.3f}M ph/s  steps={steps}  '
                  f'mean={mean:.6e}  ({dt:.1f}s)', flush=True)

    print('\n== summary ==')
    for name, tr, dc in CONFIGS:
        rates = sorted(x[0] for x in res[name])
        means = [x[2] for x in res[name]]
        print(f'{name}: median {np.median(rates)/1e6:.3f}M  '
              f'min {rates[0]/1e6:.3f}M  max {rates[-1]/1e6:.3f}M  '
              f'mean={np.mean(means):.6e} +- {np.std(means):.2e}', flush=True)


if __name__ == '__main__':
    main()

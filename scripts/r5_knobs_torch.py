"""Residual-knob A/B on the card: batch width x tile size at t25 + drain
compaction (port of scripts/tpu_r5_knobs.py:1-88).

With the drain tail compacted, the B=2^17 and tile16 that the reference
tuned may not suit this card.  Interleaved rounds.

`python -u scripts/r5_knobs_torch.py [photons] [rounds] [--device cpu]`
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
    ap.add_argument('photons', nargs='?', type=float, default=8_000_000)
    ap.add_argument('rounds', nargs='?', type=int, default=4)
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

    atm, ab, kw = scene_inputs(forward_trunc_deg=25.0)
    scene, st = build_scene(atm, ab, **kw, device=dev)
    factors, _ = spectral_factors(ab, nz_out=1)
    rad_w = factors[0]

    CONFIGS = [('b17_t16', 1 << 17, 16), ('b18_t16', 1 << 18, 16),
               ('b16_t16', 1 << 16, 16), ('b17_t24', 1 << 17, 24),
               ('b17_t32', 1 << 17, 32)]

    def run(name, batch, tile, n, seed):
        cfg = SolverConfig(target='radiance', batch=batch, n_scat_max=600,
                           tile_size=tile, use_pallas=True, qmc_launch=True)
        sync(dev)
        t0 = time.time()
        tal = run_transport_flight(scene, st, cfg, n, seed, dev, rad_w=rad_w)
        tal.rad.cpu()
        sync(dev)
        dt = time.time() - t0
        return int(tal.n_launched) / dt, int(tal.n_steps), dt

    for name, b, t in CONFIGS:
        t0 = time.time()
        run(name, b, t, 100_000, 0)
        print(f'warm {name}: {time.time()-t0:.1f}s', flush=True)

    res = defaultdict(list)
    for r in range(rounds):
        for name, b, t in CONFIGS:
            rate, steps, dt = run(name, b, t, chunk, 10 + r)
            res[name].append(rate)
            print(f'r{r} {name}: {rate/1e6:.3f}M ph/s ({dt:.1f}s, {steps} steps)',
                  flush=True)

    print('\n== summary ==')
    for name, _, _ in CONFIGS:
        rr = sorted(res[name])
        print(f'{name}: median {np.median(rr)/1e6:.3f}M  '
              f'range {rr[0]/1e6:.2f}-{rr[-1]/1e6:.2f}M', flush=True)


if __name__ == '__main__':
    main()

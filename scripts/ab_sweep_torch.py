"""Interleaved A/B on the card: truncation x tile_size (port of
scripts/tpu_ab_sweep.py:1-86).

Five (truncation, tile) configs on the bench scene at 5 and 20 degrees of
forward truncation; a 50k warm-up run each, then 3 rounds of 2e6 photons
with the configs interleaved, so that clock and host drift fall on every
config alike.  Asks what tiles and truncation buy in steps and photons/s
on the card.

`python -u scripts/ab_sweep_torch.py [--photons 2e6] [--warm 5e4]
[--rounds 3] [--device cpu]` (the options cut the budget; their defaults
are the source's)
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bench_torch import card, devices, scene_inputs, sync  # noqa: E402


def build(trunc, device='cuda'):
    """The bench scene at ``trunc`` degrees of forward truncation
    (scripts/tpu_ab_sweep.py:17-32): (scene, static) on ``device``."""
    from er3t_tpu_torch.rtm.scene import build_scene
    atm, ab, kw = scene_inputs(forward_trunc_deg=trunc)
    return build_scene(atm, ab, **kw, device=device)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--photons', type=float, default=2_000_000)
    ap.add_argument('--warm', type=float, default=50_000)
    ap.add_argument('--rounds', type=int, default=3)
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args()
    dev = card(args.device)
    print('devices:', devices(dev), flush=True)

    from er3t_tpu_torch.rtm.mc import SolverConfig
    from er3t_tpu_torch.rtm.mc_flight import run_transport_flight

    scenes = {t: build(t, dev) for t in (5.0, 20.0)}
    configs = [(5.0, 0), (20.0, 0), (20.0, 16), (20.0, 32), (20.0, 64)]
    chunk = int(args.photons)

    # warm every config first
    for trunc, ts in configs:
        scene, st = scenes[trunc]
        cfg = SolverConfig(target='radiance', batch=1 << 17, n_scat_max=600,
                           tile_size=ts)
        t0 = time.time()
        tal = run_transport_flight(scene, st, cfg, int(args.warm), 0, dev)
        tal.rad.cpu()
        print(f'warm t{trunc:.0f}/tile{ts}: {time.time()-t0:.1f}s', flush=True)

    acc = {c: [0, 0.0, 0] for c in configs}   # photons, wall, steps
    for rnd in range(args.rounds):
        for trunc, ts in configs:
            scene, st = scenes[trunc]
            cfg = SolverConfig(target='radiance', batch=1 << 17,
                               n_scat_max=600, tile_size=ts)
            sync(dev)
            t0 = time.time()
            tal = run_transport_flight(scene, st, cfg, chunk, 10 + rnd, dev)
            tal.rad.cpu()
            sync(dev)
            dt = time.time() - t0
            a = acc[(trunc, ts)]
            a[0] += int(tal.n_launched)
            a[1] += dt
            a[2] += int(tal.n_steps)
            print(f'r{rnd} t{trunc:.0f}/tile{ts:2d}: {int(tal.n_launched)/dt/1e6:.3f}M ph/s '
                  f'steps={int(tal.n_steps)} ({dt/int(tal.n_steps)*1e3:.1f} ms/step)',
                  flush=True)

    print('--- totals ---')
    for c, (n, w, s) in acc.items():
        print(f't{c[0]:.0f}/tile{c[1]:2d}: {n/w/1e6:.3f}M ph/s  '
              f'{w/s*1e3:.1f} ms/step  {s} steps')


if __name__ == '__main__':
    main()

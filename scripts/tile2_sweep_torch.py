"""Second A/B on the card: tile granularity {8,12,16,24} and chunk size
{2M,8M} (port of scripts/tpu_tile2_sweep.py:1-48).

On bench_torch's scene (the bench scene at 25 degrees of forward
truncation, as bench.py builds it now); tiles 8/12/16/24 at 2e6 photons a
chunk and 16 at 8e6, a 50k warm-up run each, then 2 rounds, interleaved.
Asks whether finer tiles (fewer steps, more majorant kernels) or larger
chunks (fewer drain tails a photon) pay on the card.

`python -u scripts/tile2_sweep_torch.py [--scale 1] [--warm 5e4]
[--rounds 2] [--device cpu]` (``--scale`` multiplies every chunk; the
defaults are the source's)
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bench_torch import build, card, devices, sync  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--scale', type=float, default=1.0)
    ap.add_argument('--warm', type=float, default=50_000)
    ap.add_argument('--rounds', type=int, default=2)
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args()
    dev = card(args.device)
    print('devices:', devices(dev), flush=True)

    from er3t_tpu_torch.rtm.mc import SolverConfig
    from er3t_tpu_torch.rtm.mc_flight import run_transport_flight

    ab, scene, st = build(dev)       # bench.py's scene: t25
    cases = [(8, 2), (12, 2), (16, 2), (24, 2), (16, 8)]
    for ts, ch in cases:
        cfg = SolverConfig(target='radiance', batch=1 << 17, n_scat_max=600,
                           tile_size=ts)
        t0 = time.time()
        tal = run_transport_flight(scene, st, cfg, int(args.warm), 0, dev)
        tal.rad.cpu()
        print(f'warm tile{ts}: {time.time()-t0:.1f}s', flush=True)
    for rnd in range(args.rounds):
        for ts, ch in cases:
            cfg = SolverConfig(target='radiance', batch=1 << 17,
                               n_scat_max=600, tile_size=ts)
            chunk = int(ch * 1_000_000 * args.scale)
            sync(dev)
            t0 = time.time()
            tal = run_transport_flight(scene, st, cfg, chunk, 21 + rnd, dev)
            tal.rad.cpu()
            sync(dev)
            dt = time.time() - t0
            print(f'r{rnd} tile{ts:2d}/chunk{ch}M: '
                  f'{int(tal.n_launched)/dt/1e6:.3f}M ph/s  '
                  f'steps={int(tal.n_steps)}  '
                  f'{dt/int(tal.n_steps)*1e3:.1f} ms/step', flush=True)


if __name__ == '__main__':
    main()

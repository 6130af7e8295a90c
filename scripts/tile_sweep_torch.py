"""Sweep on the card: bench-scene throughput vs SolverConfig.tile_size (port
of scripts/tpu_tile_sweep.py:1-51).

`python -u scripts/tile_sweep_torch.py [tile ...] [--device cpu]`.
One chunk per tile size after a small warm-up run.
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bench_torch import build, card, devices, sync  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('tiles', nargs='*', type=int)
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args()
    dev = card(args.device)
    print('devices:', devices(dev), flush=True)

    from er3t_tpu_torch.rtm.mc import SolverConfig
    from er3t_tpu_torch.rtm.mc_flight import run_transport_flight

    ab, scene, st = build(dev)
    tiles = args.tiles or [0, 16, 32, 64]
    chunk = 4_000_000
    for ts in tiles:
        cfg = SolverConfig(target='radiance', batch=1 << 17, n_scat_max=600,
                           tile_size=ts)
        t0 = time.time()
        tal = run_transport_flight(scene, st, cfg, 100_000, 0, dev)
        tal.rad.cpu()
        print(f'tile={ts:3d} compile+warm {time.time()-t0:.1f}s', flush=True)
        sync(dev)
        t0 = time.time()
        tal = run_transport_flight(scene, st, cfg, chunk, 1, dev)
        rad = tal.rad.cpu().numpy()
        sync(dev)
        dt = time.time() - t0
        n = int(tal.n_launched)
        print(f'tile={ts:3d}  {n/dt/1e6:.2f}M ph/s  steps={int(tal.n_steps)}'
              f'  wall={dt:.1f}s  mean_rad={float((rad @ ab.weight).mean()):.4e}',
              flush=True)


if __name__ == '__main__':
    main()

"""Ablation profile of the port's flight kernel on the card (port of
scripts/tpu_profile_ablate.py:1-82).

Costs each gather/scatter site by difference: ms/step at a FIXED iteration
count (max_events pins the loop's step count; a huge photon budget keeps
every lane active, so each step does full work).  Interleaved rounds
cancel thermal and clock drift.  The ablated sites are
``SolverConfig.ablate``'s; under ``'phase'`` the phase-pair kernel is not
launched.  `python -u scripts/profile_ablate_torch.py [steps] [--device cpu]`
"""
import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bench_torch import card, devices, scene_inputs, sync  # noqa: E402


def build(ng=16, device='cuda'):
    """The bench scene at 20-degree truncation with ``ng`` g-points
    (scripts/tpu_profile_ablate.py:20-34): (scene, static) on ``device``."""
    from er3t_tpu_torch.rtm.scene import build_scene
    atm, ab, kw = scene_inputs(ng=ng, forward_trunc_deg=20.0)
    return build_scene(atm, ab, **kw, device=device)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('steps', nargs='?', type=int, default=300)
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args()
    dev = card(args.device)
    print('devices:', devices(dev), flush=True)
    from er3t_tpu_torch.rtm.mc import SolverConfig
    from er3t_tpu_torch.rtm.mc_flight import run_transport_flight

    n_steps = args.steps
    scene, st = build(device=dev)
    scene1, st1 = build(ng=1, device=dev)
    B = 1 << 17
    base = dict(target='radiance', batch=B, n_scat_max=600, tile_size=16,
                max_events=n_steps)
    configs = [
        ('full        ', scene, st, SolverConfig(**base)),
        ('no-deposit  ', scene, st, SolverConfig(**base, ablate='deposit')),
        ('no-phase    ', scene, st, SolverConfig(**base, ablate='phase')),
        ('no-vox      ', scene, st, SolverConfig(**base, ablate='vox')),
        ('floor(all)  ', scene, st, SolverConfig(**base,
                                                 ablate='vox,phase,deposit')),
        ('tile0       ', scene, st, SolverConfig(**{**base, 'tile_size': 0})),
        ('ng1         ', scene1, st1, SolverConfig(**base)),
    ]
    res = {n: [] for n, *_ in configs}
    for rnd in range(3):
        for name, scn, stt, cfg in configs:
            t0 = time.time()
            tal = run_transport_flight(scn, stt, cfg, 1 << 30, rnd, dev)
            _ = tal.rad[:1, :1].cpu()
            sync(dev)
            dt = time.time() - t0
            res[name].append(dt / n_steps * 1000)
            print(f'r{rnd} {name}: {dt:6.2f}s = {dt/n_steps*1e3:6.2f} ms/step '
                  f'launched={int(tal.n_launched)/1e6:.1f}M', flush=True)
    print('\nmedian ms/step (B=131072):')
    full = np.median(res['full        '])
    for name in res:
        m = np.median(res[name])
        print(f'  {name}: {m:6.2f} ms/step   delta vs full {full - m:+6.2f}')


if __name__ == '__main__':
    main()

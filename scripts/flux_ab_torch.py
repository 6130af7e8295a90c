"""Interleaved A/B on the card: the per-column flux crossing-count clamp
(port of scripts/tpu_flux_ab.py:1-91).

The per-column 480x480 flux tally takes B x (Nz+1) rows a step without
the clamp; the crossing-count clamp (SolverConfig.flux_kcross) bounds the
scatter to kx rows a lane a step.  Five configs on the bench scene at 20
degrees of truncation: kx 4 and 8 with the in-step spectral contraction
(flux_w), kx 4 and kx 0 without it, and the domain average; 3 rounds,
interleaved.  Each run's surface down-flux (``sfc_dn``) is reduced on the
host in float64 NumPy exactly as the source reduces it: the contracted
tally over the factors' sum, the per-g tally through the g weights.

`python -u scripts/flux_ab_torch.py [photons] [--rounds 3] [--device cpu]`
"""
import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bench_torch import card, devices, scene_inputs, sync  # noqa: E402


def build(device='cuda'):
    """The bench scene at 20 degrees of truncation
    (scripts/tpu_flux_ab.py:20-35): (gases, scene, static) on ``device``."""
    from er3t_tpu_torch.rtm.scene import build_scene
    atm, ab, kw = scene_inputs(forward_trunc_deg=20.0)
    return ab, *build_scene(atm, ab, **kw, device=device)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('photons', nargs='?', type=float, default=2_000_000)
    ap.add_argument('--rounds', type=int, default=3)
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args()
    dev = card(args.device)
    print('devices:', devices(dev), flush=True)

    from er3t_tpu_torch.rtm.mc import SolverConfig
    from er3t_tpu_torch.rtm.mc_flight import run_transport_flight
    from er3t_tpu_torch.rtm.out import spectral_factors

    n_phot = int(args.photons)
    ab, scene, st = build(dev)
    fw, _ = spectral_factors(ab, nz_out=st.nz + 1)
    configs = [('scalar-kx4', dict(flux_kcross=4), True),
               ('scalar-kx8', dict(flux_kcross=8), True),
               ('kx4', dict(flux_kcross=4), False),
               ('kx0-legacy', dict(flux_kcross=0), False),
               ('domavg', dict(flux_kcross=0, flux_per_column=False), False)]
    results = {k: [] for k, _, _ in configs}
    sfc = {}
    for rnd in range(args.rounds):
        for name, kw, use_fw in configs:
            cfg = SolverConfig(target='flux', batch=1 << 17, n_scat_max=600,
                               tile_size=16,
                               **{**dict(flux_per_column=True), **kw})
            sync(dev)
            t0 = time.time()
            tal = run_transport_flight(scene, st, cfg, n_phot, rnd, dev,
                                       flux_w=fw if use_fw else None)
            flux = tal.flux.cpu().numpy()   # on the host: the run is done
            sync(dev)
            dt = time.time() - t0
            n = int(tal.n_launched)
            rate = n / dt
            results[name].append(rate)
            if flux.shape[-1] == 1:     # scalar (factor-contracted) tally
                f = flux[..., 0] / fw.sum(axis=1)[None, None, :, None]
            else:
                f = flux @ ab.weight
            ncol = f.shape[0] * f.shape[1]
            sfc[name] = (f[:, :, 0, 0].mean() + f[:, :, 0, 1].mean()) / n * ncol
            print(f'r{rnd} {name:12s}: {n/1e6:.1f}M ph in {dt:6.2f}s = '
                  f'{rate/1e6:6.3f}M ph/s  steps={int(tal.n_steps):5d} '
                  f'sfc_dn={sfc[name]:.4f}', flush=True)
    print('\nmedian ph/s by config:')
    for name, _, _ in configs:
        med = np.median(results[name])
        print(f'  {name:12s}: {med/1e6:6.3f}M ph/s   sfc_dn={sfc[name]:.4f}')


if __name__ == '__main__':
    main()

"""Per-pixel variance budget + per-knob A/B on the bench scene on the card
(port of scripts/tpu_var_budget.py:1-144).

For each candidate config it measures:

* rate (photons/s, median over repeats; the first repeat is left out),
* per-photon pixel variance of the spectrally-contracted image
  (mean over pixels, and split over cloudy/clear columns),
* effective noise-matched throughput vs the base config
  = rate * var(base)/var(cfg).

Also runs the biased 'firstdep' diagnostic (first-order deposits dropped) to
expose how much of the pixel variance is first-order sampling noise.  A
repeat that fails raises (the reference prints it and goes on).

Usage: python -u scripts/var_budget_torch.py [--repeats 12] [--photons 2e6]
           [--configs a,b] [--device cpu]
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bench_torch import build, card, scene_inputs, sync  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--repeats', type=int, default=12)
    ap.add_argument('--photons', type=float, default=2e6)
    ap.add_argument('--configs', type=str, default='')
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args()
    dev = card(args.device)

    from er3t_tpu_torch.rtm.scene import build_scene
    from er3t_tpu_torch.rtm.mc import SolverConfig
    from er3t_tpu_torch.rtm.mc_flight import run_transport_flight
    from er3t_tpu_torch.rtm.out import spectral_factors

    ab, scene, st = build(dev)
    factors, _ = spectral_factors(ab, nz_out=1)
    rad_w = factors[0]

    # pfpeak scene: rebuild with the clamp
    def build_pfpeak(pk):
        atm, ab2, kw = scene_inputs(forward_trunc_deg=20.0, pfpeak=pk)
        return build_scene(atm, ab2, **kw, device=dev)

    base = dict(target='radiance', batch=1 << 17, n_scat_max=600,
                tile_size=16, use_pallas=True)
    cloud_mask = scene.ext3d.sum(dim=2).cpu().numpy() > 0   # (480,480)

    CONFIGS = {
        'base':     (SolverConfig(**base), scene, st),
        'pfpeak30': (SolverConfig(**base), *build_pfpeak(30.0)),
        'qmc':      (SolverConfig(**base, qmc_launch=True), scene, st),
        'cf05':     (SolverConfig(**base, cf_dtau=0.5), scene, st),
        'split05':  (SolverConfig(**base, split_wmax=0.5), scene, st),
        'firstdep': (SolverConfig(**base, ablate='firstdep'), scene, st),
        'rr03':     (SolverConfig(**base, rr_value=0.03), scene, st),
        'rr05':     (SolverConfig(**base, rr_value=0.05), scene, st),
        'rr10':     (SolverConfig(**base, rr_value=0.10), scene, st),
        'rr05qmc':  (SolverConfig(**base, rr_value=0.05, qmc_launch=True),
                     scene, st),
    }
    if args.configs:
        names = args.configs.split(',')
        CONFIGS = {k: CONFIGS[k] for k in names}

    n = int(args.photons)
    out = {}
    for name, (cfg, sc, stc) in CONFIGS.items():
        imgs, rates = [], []
        t_comp = time.time()
        for k in range(args.repeats):
            sync(dev)
            t0 = time.time()
            tal = run_transport_flight(sc, stc, cfg, n, 500 + k, dev,
                                       rad_w=rad_w)
            img = tal.rad.cpu().numpy()[:, :, 0]
            n_l = int(tal.n_launched)
            sync(dev)
            dt = time.time() - t0
            imgs.append(img / max(n_l, 1))
            if k > 0:               # the first repeat builds and warms up
                rates.append(n_l / dt)
            print(f'#   {name} rep {k}: {dt:.1f}s '
                  f'{n_l / dt / 1e6:.2f}M ph/s', flush=True)
        if len(imgs) < 4:
            print(f'# {name}: too few repeats, skipped', flush=True)
            continue
        arr = np.stack(imgs)
        v = arr.var(axis=0, ddof=1) * n          # per-photon pixel variance
        mean_img = arr.mean(axis=0)
        out[name] = {
            'rate_med': float(np.median(rates)) if rates else 0.0,
            'var_mean': float(v.mean()),
            'var_cloudy': float(v[cloud_mask].mean()),
            'var_clear': float(v[~cloud_mask].mean()),
            'mean_rad': float(mean_img.mean()),
            'mean_cloudy': float(mean_img[cloud_mask].mean()),
            'mean_clear': float(mean_img[~cloud_mask].mean()),
            'repeats': len(imgs),
            'wall': round(time.time() - t_comp, 1),
        }
        print(f'# {name}: rate {out[name]["rate_med"]/1e6:.2f}M  '
              f'var {v.mean():.4g} (cloudy {out[name]["var_cloudy"]:.4g} '
              f'clear {out[name]["var_clear"]:.4g})  '
              f'mean {mean_img.mean():.5g}', flush=True)

    if 'base' in out:
        v0, r0 = out['base']['var_mean'], out['base']['rate_med']
        for name, d in out.items():
            if d['var_mean'] > 0 and d['rate_med'] > 0:
                d['eff_vs_base'] = round(
                    (d['rate_med'] / r0) * (v0 / d['var_mean']), 3)
    print(json.dumps(out, indent=1))


if __name__ == '__main__':
    main()

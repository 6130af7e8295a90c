"""Weak-scaling record of the port's dist layer: photons/s and algorithmic
work against rank count (port of scripts/cpu_scaling_bench.py:1-139).

Runs the bench-like broken-cloud radiance workload (96 x 96 columns of
0.1 km) over 1/2/4/8 ranks for both distribution strategies:

* ``photon``  -- replicated scene, one photon stream a rank
  (er3t_tpu_torch/dist/photon.py);
* ``decomp``  -- x-slab domain decomposition with photon migration
  between slabs (er3t_tpu_torch/dist/decomp.py).

The ranks come from ``make_mesh``: with ``--device cpu`` all n on the
CPU; with ``--device cuda`` (the default) rank r on visible card r mod
count, so that on a one-card machine every rank shares the card.  Ranks
held in one process run one after the other.

Two efficiency numbers a point:

* wall-clock photons/s (weak scaling: photons = n * base).  CAVEAT: ranks
  that share a card, or the CPU's cores, run in turn, so wall-clock
  efficiency beyond the number of cards measures that sharing, not the
  algorithm; it is reported for completeness only.
* algorithmic work a photon = lane iterations (Tallies.lane_iters, summed
  over ranks) / photons launched.  Drain compaction shrinks the drain
  batch, so steps * batch would overcount the photon-parallel tail.  With
  ms/step set by the batch (a step costs about the same however full),
  the ratio of work a photon at n = 1 and at n = N is the
  device-independent weak-scaling efficiency: it captures migration
  rounds, frozen-lane idling and drain tails, everything but the transfer
  itself.

Usage: python scripts/scaling_bench_torch.py [--base-photons 150000]
    [--device cpu]
Slab-width study (production-width slabs):
    python scripts/scaling_bench_torch.py --nx 768 --ny 48 \\
        --strategies decomp --devices 1,2,4,8 --base-photons 40000
    => 768/384/192/96-column slabs at n=1/2/4/8.
"""

import argparse
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bench_torch import card, gases, sync  # noqa: E402


def build_scene_mid(nx=96, ny=96, trunc=20.0, device='cuda'):
    """The bench scene's cloud, gases and geometry on ``nx`` x ``ny``
    columns of 0.1 km (scripts/cpu_scaling_bench.py:49-66): (gases,
    scene, static), the scene on ``device``."""
    from er3t_tpu_torch.pre.cld import cld_gen_hem
    from er3t_tpu_torch.pre.pha import pha_mie_wc
    from er3t_tpu_torch.rtm.scene import build_scene

    atm, ab = gases()
    cld = cld_gen_hem(nx=nx, ny=ny, nz=4, dx=0.1, dy=0.1, dz=0.5,
                      cloud_frac_tgt=0.25, radii=(0.5, 1.0, 2.0),
                      cot_scale=15.0, cloud_base=0.5, seed=7)
    pha = pha_mie_wc(650.0)
    scene, st = build_scene(atm, ab, cld=cld, pha=pha, surface=0.03,
                            solar_zenith_angle=30.0, solar_azimuth_angle=45.0,
                            forward_trunc_deg=trunc, device=device)
    return ab, scene, st


def rank_devices(dev, n):
    """The ``device`` argument of ``make_mesh`` for n ranks: 'cpu', or rank
    r on visible card r mod count (repeats share a card)."""
    dev = torch.device(dev)
    if dev.type != 'cuda':
        return str(dev)
    count = torch.cuda.device_count()
    return [torch.device('cuda', r % count) for r in range(n)]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--base-photons', type=int, default=150_000)
    ap.add_argument('--batch', type=int, default=1 << 12)
    ap.add_argument('--reps', type=int, default=2)
    ap.add_argument('--nx', type=int, default=96)
    ap.add_argument('--ny', type=int, default=96)
    ap.add_argument('--strategies', default='photon,decomp')
    ap.add_argument('--devices', default='1,2,4,8')
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args()
    dev = card(args.device)

    from er3t_tpu_torch.dist.decomp import transport_decomp
    from er3t_tpu_torch.dist.mesh import make_mesh
    from er3t_tpu_torch.dist.photon import transport_photon_parallel
    from er3t_tpu_torch.rtm.mc import SolverConfig
    from er3t_tpu_torch.rtm.out import spectral_factors

    ab, scene, st = build_scene_mid(nx=args.nx, ny=args.ny, device=dev)
    factors, _ = spectral_factors(ab, nz_out=1)
    rad_w = factors[0]
    cfg = SolverConfig(target='radiance', batch=args.batch, n_scat_max=600,
                       tile_size=8)

    results = {}
    for strat in args.strategies.split(','):
        rows = []
        for n in [int(v) for v in args.devices.split(',')]:
            mesh = make_mesh(n, decomp=(n if strat == 'decomp' else 1),
                             device=rank_devices(dev, n))
            n_ph = args.base_photons * n
            best_dt, tal = None, None
            for rep in range(args.reps + 1):      # rep 0 = warm-up
                sync(dev)
                t0 = time.time()
                if strat == 'photon':
                    tal = transport_photon_parallel(scene, st, cfg, n_ph,
                                                    mesh, seed=3 + rep,
                                                    rad_w=rad_w)
                else:
                    tal = transport_decomp(scene, st, cfg, n_ph, mesh,
                                           seed=3 + rep, rad_w=rad_w)
                n_l = int(tal.n_launched)
                _ = tal.rad.cpu()
                sync(dev)
                dt = time.time() - t0
                if rep > 0:
                    best_dt = dt if best_dt is None else min(best_dt, dt)
            steps_total = int(tal.n_steps)        # summed over ranks
            # true lane-iteration work (drain compaction shrinks the
            # batch in the tail; steps*batch would overcount it)
            work = int(tal.lane_iters) / max(n_l, 1)
            rows.append({'n_dev': n, 'photons': n_ph, 'launched': n_l,
                         'wall_s': round(best_dt, 2),
                         'photons_per_s': round(n_l / best_dt, 1),
                         'steps_total': steps_total,
                         'slab_cols': st.nx // n if strat == 'decomp' else st.nx,
                         'work_per_photon': round(work, 2)})
            print(f'# {strat} n={n}: {n_l} ph in {best_dt:.1f}s '
                  f'({n_l / best_dt / 1e3:.1f}k ph/s), '
                  f'work/photon {work:.1f} lane-iters', flush=True)
        w0 = rows[0]['work_per_photon']
        r0 = rows[0]['photons_per_s']
        for r in rows:
            r['alg_efficiency'] = round(w0 / r['work_per_photon'], 3)
            r['wallclock_efficiency'] = round(
                r['photons_per_s'] / (r0 * r['n_dev']), 3)
        results[strat] = rows
    print(json.dumps(results, indent=1))
    return results


if __name__ == '__main__':
    main()

"""Phase-table size A/B on the card: tables of 2048 x 2048 bins against
8192 x 4096 (port of scripts/tpu_isolate_ab.py:1-72).

Four configs at pinned steps (max_events; a huge photon budget keeps every
lane busy), rad_w on, 3 rounds, interleaved: small tables with the
Lambertian flag, small tables with use_pallas off, small tables with the
flag cleared, and large tables.  The source isolated a slowdown of its
phase-pair kernel and of a Lambertian fast path.  On the card only the
table size differs between the runs: the flight step gates nothing on
``sfc_lambertian`` (the reference removed that fast path,
er3t_tpu/rtm/mc_flight.py:1232-1237) and ignores ``use_pallas`` (the
phase-pair kernel runs either way), so the first three configs make the
same run.  All four are kept, so that the runs are the source's; the
large tables run the phase-pair kernel on pt_p (4, 4096) and pt_mu
(2, 8192).

The tables are resized by patching ``er3t_tpu_torch.rtm.scene.
build_phase_table`` around profile_ablate_torch's build, restored after.

`python -u scripts/isolate_ab_torch.py [steps] [--device cpu]`
"""
import argparse
import dataclasses
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from bench_torch import card, devices, gases, sync  # noqa: E402


def build(n_u, n_m, device='cuda'):
    """profile_ablate_torch's scene (t20, 16 g-points) with phase tables
    of ``n_u`` quantiles and ``n_m`` bins: (scene, static)."""
    import er3t_tpu_torch.pre.pha as P
    import er3t_tpu_torch.rtm.scene as S
    orig = P.build_phase_table
    S.build_phase_table = lambda *a, **k: orig(*a, **{**k, 'n_u': n_u,
                                                      'n_m': n_m})
    try:
        from profile_ablate_torch import build as b
        return b(device=device)
    finally:
        S.build_phase_table = orig


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
    sc_s, st_s = build(2048, 2048, dev)     # small tables
    sc_l, st_l = build(8192, 4096, dev)     # large tables
    st_s_nolam = dataclasses.replace(st_s, sfc_lambertian=False)
    _, ab = gases()
    rw = spectral_factors(ab, nz_out=1)[0][0]
    cfg = SolverConfig(target='radiance', batch=1 << 17, n_scat_max=600,
                       tile_size=16, max_events=n_steps, use_pallas=True)
    cfg_x = dataclasses.replace(cfg, use_pallas=False)
    configs = [
        ('small+lam+pal ', sc_s, st_s, cfg),
        ('small+lam+xla ', sc_s, st_s, cfg_x),
        ('small-lam+pal ', sc_s, st_s_nolam, cfg),
        ('big+lam+pal   ', sc_l, st_l, cfg),
    ]
    res = {n: [] for n, *_ in configs}
    for rnd in range(3):
        for name, scn, stt, cf in configs:
            sync(dev)
            t0 = time.time()
            tal = run_transport_flight(scn, stt, cf, 1 << 30, rnd, dev,
                                       rad_w=rw)
            _ = tal.rad[:1, :1].cpu()
            sync(dev)
            dt = time.time() - t0
            res[name].append(dt / n_steps * 1000)
            print(f'r{rnd} {name}: {dt:6.2f}s = {dt/n_steps*1e3:6.2f} ms/step '
                  f'launched={int(tal.n_launched)/1e6:.1f}M', flush=True)
    print('\nmedian ms/step:')
    for name in res:
        print(f'  {name}: {np.median(res[name]):6.2f} ms/step')


if __name__ == '__main__':
    main()

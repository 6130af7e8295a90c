"""Instrumented decomposed transport: per-superstep population diagnostics
(port of scripts/debug_decomp_drain.py:1-181).

Steps the ranks of a decomposed run by hand, a superstep at a time, and
prints each rank's lanes after the superstep's two migration swaps: active
in its slab, roaming above the deck top, frozen out of its slab below it,
photons launched and the largest scattering order of the live lanes (the
first 5 rounds and every 10th), every live lane at rounds 80, 100 and 120
(STUCK), and the round at which the run drained.

It keeps no copy of the dist layer: the ranks are
``dist.decomp.rank_kernels`` (each rank's FlightKernel on its
``shard_scene`` slab with its x offset and spawn reserve, its generator
and launch offset), a step is ``rtm.mc_flight.flight_step``, and the swaps
are ``dist.decomp.migrate_dir`` itself, with transport_decomp's window
(B / 4), spawn reserve (min(window / 2, B / 8)), roaming rule and deck
top.  Defaults as the source's: 4 ranks, 4e4 photons, the 96 x 96 scene
of scaling_bench_torch, 2^10 lanes, tile 8, 16 steps a superstep, seed 0;
the ranks share the card (or the CPU with ``--device cpu``).

Usage: python scripts/debug_decomp_drain_torch.py [n_dev] [photons]
    [--device cpu]
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from bench_torch import card  # noqa: E402
from scaling_bench_torch import build_scene_mid, rank_devices  # noqa: E402

K_SUPER = 16
MAX_ROUNDS = 400


def _host(cs, field):
    return np.stack([getattr(c, field).cpu().numpy() for c in cs])


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('n_dev', nargs='?', type=int, default=4)
    ap.add_argument('photons', nargs='?', type=float, default=40000)
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args()
    dev = card(args.device)

    from er3t_tpu_torch.dist import decomp as D
    from er3t_tpu_torch.dist.mesh import make_mesh
    from er3t_tpu_torch.rtm.mc import SolverConfig
    from er3t_tpu_torch.rtm.mc_flight import flight_step
    from er3t_tpu_torch.rtm.out import spectral_factors

    n_dev = args.n_dev
    n_photon = int(args.photons)
    ab, scene, st = build_scene_mid(96, 96, device=dev)
    factors, _ = spectral_factors(ab, nz_out=1)
    cfg = SolverConfig(target='radiance', batch=1 << 10, n_scat_max=600,
                       tile_size=8)
    mesh = make_mesh(n_dev, decomp=n_dev, device=rank_devices(dev, n_dev))
    B = cfg.batch
    n_per = n_photon // n_dev
    M = B // 4
    reserve = min(M // 2, B // 8)
    ranks = D.rank_kernels(scene, st, cfg, mesh, n_per, 0, rad_w=factors[0],
                           spawn_reserve=reserve)
    cs = [kern.carry0(B) for kern, *_ in ranks]
    k0 = ranks[0][0]
    roam, lx_loc, zd_top = k0.roam, k0.lx_loc, k0.zd_hi

    rows_out, drained = [], None
    for r in range(MAX_ROUNDS):
        for k, (kern, gen, q_off) in enumerate(ranks):
            for _ in range(K_SUPER):
                cs[k] = flight_step(kern, gen, cs[k], q_off)
        for right in (True, False):
            cs = D.migrate_dir(mesh, cs, M, lx_loc, zd_top, roam, right)
        if r % 10 == 0 or r < 5:
            al, x, z = _host(cs, 'alive'), _host(cs, 'x'), _host(cs, 'z')
            ns, la = _host(cs, 'nscat'), _host(cs, 'launched')
            rows, rec = [], dict(r=r, act=[], roam=[], froz=[], launched=[],
                                 max_nscat=[])
            for d in range(n_dev):
                in_slab = (x[d] >= d * lx_loc) & (x[d] < (d + 1) * lx_loc)
                roaming = al[d] & ~in_slab & (z[d] > zd_top)
                froz = al[d] & ~in_slab & (z[d] <= zd_top)
                act = al[d] & in_slab
                mx = int(ns[d][al[d]].max()) if al[d].any() else 0
                for key, v in (('act', act.sum()), ('roam', roaming.sum()),
                               ('froz', froz.sum()), ('launched', la[d]),
                               ('max_nscat', mx)):
                    rec[key].append(int(v))
                rows.append(f'd{d}: act {act.sum():4d} roam {roaming.sum():4d} '
                            f'froz {froz.sum():4d} launched {la[d]:6d} '
                            f'max_nscat {mx}')
            rows_out.append(rec)
            print(f'r={r:3d} | ' + ' | '.join(rows), flush=True)
        if r in (80, 100, 120):
            al = _host(cs, 'alive').reshape(-1)
            f = {k: _host(cs, k).reshape(-1)
                 for k in ('x', 'y', 'z', 'ux', 'uy', 'uz', 'nscat', 'wsc')}
            for i in np.where(al)[0]:
                d = i // B
                print(f'  STUCK lane dev={d} x={float(f["x"][i]):.2f} '
                      f'y={float(f["y"][i]):.2f} '
                      f'z={float(f["z"][i]):.3f} '
                      f'ux={float(f["ux"][i]):.5f} '
                      f'uy={float(f["uy"][i]):.5f} '
                      f'uz={float(f["uz"][i]):.6f} '
                      f'nscat={int(f["nscat"][i])} '
                      f'wsc={float(f["wsc"][i]):.3e}', flush=True)
        if not _host(cs, 'alive').any() and \
                _host(cs, 'launched').sum() >= n_photon - n_dev:
            print(f'drained at round {r}')
            drained = r
            break
    return dict(drained=drained, rounds=r + 1, rows=rows_out,
                rank_steps=[c.step for c in cs],
                launched=[int(c.launched) for c in cs])


if __name__ == '__main__':
    main()

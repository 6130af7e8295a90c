"""Does sorting scatter indices pay on the card?  (port of
scripts/tpu_sorted_scatter.py:1-77)

In-loop marginal costs, over a loop of 50 steps that draws (indices,
weights) from a seeded torch.Generator, of: ``torch.sort`` alone, an
unsorted ``index_add_``, and ``argsort`` + an ``index_add_`` of the
sorted indices, each against the loop that only draws and sums; for the
radiance image's shape (2^17 rows into 230 400) and the per-column flux
tally's (2^19 rows into 24 192 000, 97 MB, past the 50 MB L2).  The
sorted and unsorted loops add the same weights, so their tallies' sums
must agree (``match``, rtol 1e-4); the script raises if they do not.
Times are device times from CUDA events (er3t_tpu_torch.probes.
gather_probe.device_ms), the best of 3; with ``--device cpu`` wall clock
instead, and ``--scale`` shrinks both shapes.

`python -u scripts/sorted_scatter_torch.py [--scale 1] [--device cpu]`
"""
import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from bench_torch import card, devices  # noqa: E402
from gather_probe4_torch import elapsed_ms  # noqa: E402

SHAPES = [(1 << 17, 230_400, 'image'), (1 << 19, 24_192_000, 'flux')]
STEPS = 50


def b_base(tal, acc, idx, w):
    return tal, acc + idx.sum() + w.sum()


def b_unsorted(tal, acc, idx, w):
    return tal.index_add_(0, idx, w), acc


def b_sortonly(tal, acc, idx, w):
    si = torch.sort(idx).values
    return tal, acc + si[0].to(torch.float32) + w.sum()


def b_sorted(tal, acc, idx, w):
    order = torch.argsort(idx)
    return tal.index_add_(0, idx[order], w[order]), acc


def loop(body, n_upd, n_tal, dev, k=STEPS, seed=0):
    """``k`` steps of ``body`` on a zeroed tally, the (indices, weights) of
    each drawn from a generator seeded ``seed``; returns (tally, the
    tally's sum + the accumulator)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    tal = torch.zeros(n_tal, dtype=torch.float32, device=dev)
    acc = torch.zeros((), dtype=torch.float32, device=dev)
    for _ in range(k):
        idx = torch.randint(0, n_tal, (n_upd,), generator=gen, device=dev)
        w = torch.rand((n_upd,), generator=gen, device=dev)
        tal, acc = body(tal, acc, idx, w)
    return tal, tal.sum() + acc


def bench(body, n_upd, n_tal, dev, reps=3):
    """The best of ``reps`` times of the loop, in ms a step, and its
    result."""
    out = []
    for _ in range(reps):
        out.append(elapsed_ms(lambda: loop(body, n_upd, n_tal, dev), dev, n=1)
                   / STEPS)
    return min(out), float(loop(body, n_upd, n_tal, dev)[1])


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--scale', type=float, default=1.0)
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args()
    dev = card(args.device)
    print('devices:', devices(dev), flush=True)

    out = {}
    for n_upd, n_tal, tag in SHAPES:
        n_upd = max(int(n_upd * args.scale), 16)
        n_tal = max(int(n_tal * args.scale), 16)
        t0, _ = bench(b_base, n_upd, n_tal, dev)
        t1, r1 = bench(b_unsorted, n_upd, n_tal, dev)
        t2, _ = bench(b_sortonly, n_upd, n_tal, dev)
        t3, r3 = bench(b_sorted, n_upd, n_tal, dev)
        match = bool(np.allclose(r1, r3, rtol=1e-4))
        print(f'{tag} (N={n_upd}, tally={n_tal}):')
        print(f'  rng/base      : {t0:6.2f} ms/iter')
        print(f'  scatter       : {t1 - t0:6.2f} ms/iter marginal')
        print(f'  sort alone    : {t2 - t0:6.2f} ms/iter marginal')
        print(f'  sort+scatter  : {t3 - t0:6.2f} ms/iter marginal '
              f'(match={match})', flush=True)
        out[tag] = dict(base=t0, scatter=t1 - t0, sort=t2 - t0,
                        sort_scatter=t3 - t0, match=match, unsorted=r1,
                        sorted=r3)
        if not match:
            raise AssertionError(f'{tag}: sorted tally sum {r3} != unsorted '
                                 f'{r1} (rtol 1e-4)')
    return out


if __name__ == '__main__':
    main()

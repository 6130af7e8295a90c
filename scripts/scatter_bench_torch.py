"""Microbenchmark on the card: scatter-add shapes of the per-column flux
tally (port of scripts/tpu_scatter_bench.py:1-85).

What does an ``index_add_`` cost scale with: rows, elements, or the
tally's size?  Seven shapes, N = 2^17 * 4 = 524288 update rows (B lanes
at kx = 4):

* ``rows128``: N, N/4 and N/16 rows of 128 f32 into a (4 233 600, 128)
  tally (480*480*49*3/8 rows; 2.17 GB, on the card);
* ``scalar``: N and 4N scalars into the flat 33.9M-element tally
  (135 MB, past the 50 MB L2);
* ``window16``: N windows of 16 f32 at column ``isub * 16`` of a row of
  the 128-wide tally.  The source scatters them with a 16-wide
  ``lax.scatter_add`` window; here they are ``index_add_`` on the
  (4 233 600 * 8, 16) view of the same tally at row ``8 * i + isub``,
  the same elements;
* ``smalltal``: N rows of 128 into a 66 150-row (34 MB) tally.

Every tally is updated in place, as the port's tallies are.  Times are
device times from CUDA events around 5 back-to-back calls after one
(er3t_tpu_torch.probes.gather_probe.device_ms); with ``--device cpu``
wall clock instead, and ``--scale`` shrinks N and the tallies.

`python -u scripts/scatter_bench_torch.py [--scale 1] [--device cpu]`
"""
import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from bench_torch import card, devices  # noqa: E402
from gather_probe4_torch import elapsed_ms  # noqa: E402

N = 524_288                      # B=2^17 * kx=4 update rows
NROW_PACKED = 4_233_600          # 480*480*49*3/8
NROW_SMALL = 66_150


def s_rows(t, i, u):
    return t.index_add_(0, i, u)


def s_window16(t, i, isub, u):
    return t.view(-1, 16).index_add_(0, i * 8 + isub, u)


def cases(dev, n=N, nrow_packed=NROW_PACKED, nrow_small=NROW_SMALL, seed=0):
    """The seven (name, function, arguments) of the benchmark; every
    function adds into its first argument in place and returns it."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    nrow_flat = nrow_packed * 8

    def randint(hi, size):
        return torch.randint(0, hi, (size,), generator=gen, device=dev)
    idx = randint(nrow_packed, n)
    idx_flat = randint(nrow_flat, n)
    sub = randint(8, n)
    upd128 = torch.ones((n, 128), dtype=torch.float32, device=dev)
    upd16 = torch.ones((n, 16), dtype=torch.float32, device=dev)
    upd1 = torch.ones((n,), dtype=torch.float32, device=dev)
    tal128 = torch.zeros((nrow_packed, 128), dtype=torch.float32, device=dev)
    tal_flat = torch.zeros((nrow_flat,), dtype=torch.float32, device=dev)
    return [
        ('rows128  N   ', s_rows, (tal128, idx, upd128)),
        ('rows128  N/4 ', s_rows, (tal128, idx[:n // 4], upd128[:n // 4])),
        ('rows128  N/16', s_rows, (tal128, idx[:n // 16], upd128[:n // 16])),
        ('scalar   N   ', s_rows, (tal_flat, idx_flat, upd1)),
        ('scalar   4N  ', s_rows, (torch.zeros((nrow_flat,), dtype=torch.float32,
                                               device=dev),
                                   idx_flat.repeat(4),
                                   torch.ones((4 * n,), dtype=torch.float32,
                                              device=dev))),
        ('window16 N   ', s_window16, (tal128, idx, sub, upd16)),
        ('smalltal r128', s_rows, (torch.zeros((nrow_small, 128),
                                               dtype=torch.float32, device=dev),
                                   idx % nrow_small, upd128)),
    ]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--scale', type=float, default=1.0)
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args()
    dev = card(args.device)
    print('devices:', devices(dev), flush=True)
    sizes = {k: max(int(v * args.scale), 16) for k, v in
             (('n', N), ('nrow_packed', NROW_PACKED),
              ('nrow_small', NROW_SMALL))}
    out = {}
    for name, fn, fargs in cases(dev, **sizes):
        try:
            ms = elapsed_ms(lambda: fn(*fargs), dev)
            n_upd = fargs[1].shape[0]
            out[name] = ms
            print(f'{name}: {ms:8.2f} ms  '
                  f'({ms/n_upd*1e6:7.1f} ns/row)', flush=True)
        except Exception as e:
            print(f'{name}: FAILED {type(e).__name__}: {e}', flush=True)
    return out


if __name__ == '__main__':
    main()

"""Scatter probe on the card: in-loop scatter-add cost against tally size
(port of scripts/tpu_gather_probe4.py:1-83).

The port's tallies are ``index_add_`` (er3t_tpu_torch/rtm/mc_flight.py:
808, 811, 867, 1090): the image deposit adds B rows a step, the per-column
flux tally kx rows a lane.  This measures the marginal cost of a (B,)
scalar ``index_add_`` inside a loop of K steps into tallies of 2^18, 2^20
and 2^22 f32 (1, 4 and 16 MB: inside the H100's 50 MB L2) and of
480*480*21*3 f32 (58 MB, the per-column flux tally: past it), plus the
(B, 4) variant (the flux kx = 4 shape) into 58 MB and 4 MB.  Each probe
runs the "on" loop (draw, scatter, accumulate) and the "off" loop (draw,
accumulate) from one seeded torch.Generator; their difference over K is
the scatter's cost an iteration.  Times are device times from CUDA events
around back-to-back calls (er3t_tpu_torch.probes.gather_probe.device_ms,
5 calls); with ``--device cpu`` wall clock instead.  One JSON line a
probe, with the source's keys.

`python -u scripts/gather_probe4_torch.py [--device cpu]`
"""
import argparse
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bench_torch import card  # noqa: E402

B = 1 << 17
K = 30
TALLIES = (1 << 18, 1 << 20, 1 << 22, 480 * 480 * 21 * 3)


def report(name, **kw):
    print(json.dumps({'probe': name, **kw}), flush=True)


def elapsed_ms(fn, dev, n=5):
    """Time of one call of ``fn`` [ms]: on the card its device time over
    ``n`` back-to-back calls (gather_probe.device_ms); on the CPU the
    median wall time of ``n`` calls after one."""
    if torch.device(dev).type == 'cuda':
        from er3t_tpu_torch.probes import gather_probe
        return gather_probe.device_ms(fn, n=n)
    fn()
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return sorted(ts)[n // 2] * 1e3


def scatter_loop(n_tal, rows_per_lane, dev, on, seed=1, keep=None):
    """The probe's loop: K steps of (B, rows_per_lane) uniforms from a
    generator seeded ``seed``, each scattered (``on``) into an ``n_tal``
    f32 tally at ``u * (n_tal - 1)``; returns (tally, accumulator).
    ``keep``: a list that receives each step's (indices, values)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    tal = torch.zeros(n_tal, dtype=torch.float32, device=dev)
    acc = torch.zeros(B, dtype=torch.float32, device=dev)
    for _ in range(K):
        u = torch.rand((B, rows_per_lane), generator=gen, device=dev)
        if on:
            idx = (u * (n_tal - 1)).to(torch.int64).reshape(-1)
            tal.index_add_(0, idx, u.reshape(-1))
            if keep is not None:
                keep.append((idx, u.reshape(-1)))
        acc += u[:, 0]
    return tal, acc


def inloop_scatter(tag, n_tal, dev, rows_per_lane=1):
    try:
        def run(on):
            tal, acc = scatter_loop(n_tal, rows_per_lane, dev, on)
            return tal[0] + acc[0]
        t_on = elapsed_ms(lambda: run(True), dev)
        t_off = elapsed_ms(lambda: run(False), dev)
        rec = dict(n_tal=n_tal, rows_per_lane=rows_per_lane,
                   ms_per_iter=round((t_on - t_off) / K, 4),
                   ns_per_row=round((t_on - t_off) / K
                                    / (B * rows_per_lane) * 1e6, 2))
    except Exception as e:
        rec = dict(error=str(e)[:200])
    report(tag, **rec)
    return rec


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args()
    dev = card(args.device)
    kind = (torch.cuda.get_device_name(dev) if dev.type == 'cuda'
            else str(dev))
    report('device', kind=kind)
    out = {}
    for n_tal in TALLIES:
        out[f'scatter1_{n_tal}'] = inloop_scatter(f'scatter1_{n_tal}',
                                                  n_tal, dev)
    out['scatter4_flux'] = inloop_scatter('scatter4_flux', TALLIES[-1], dev,
                                          rows_per_lane=4)
    out['scatter4_1M'] = inloop_scatter('scatter4_1M', 1 << 20, dev,
                                        rows_per_lane=4)
    return out


if __name__ == '__main__':
    main()

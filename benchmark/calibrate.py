"""The readings that the limits of ``correct`` are set from, for one cell,
in one process on the card.

    python benchmark/calibrate.py --workload rad_les.run1e6 --requests 4,5 \\
        --seeds 11,12,13 --control-seeds 21,22,23 --cap-fault 3 \\
        --out cal.jsonl

Every run's window sends the same requests, so the program's window of
the largest of ``--requests`` runs once, and each of ``--seeds`` draws a
reference against it, as a run with that ``--seed`` checks it, once for
each window length of ``--requests``.  For each of ``--control-seeds``:
the control, the reference computed in bfloat16 (the precision below the
float32 that the configuration states), put in the program's place with
the same photons, against the float32 reference.  ``--cap-fault k``: the
program's window once more with every flight's step cap cut to a k-th
(photons dropped in flight), against the first seed's reference.  One
JSON line per reading, with every number compared.  The benchmark's runs
never run this.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def control_images(prep, seed, n_requests):
    """The bfloat16 reference in the program's place: ``n_requests``
    fields of the request's photons each."""
    import torch

    from benchmark.lib import harness
    imgs, _ = harness.reference(prep, seed + 7, dtype=torch.bfloat16,
                                n_photons=prep.n_asked * n_requests,
                                batches=n_requests)
    return imgs


def cap_cut(prep, k):
    """Plant the fault: every flight's step cap at a ``k``-th of its
    default, ``(n // batch + 2) * 400``."""
    orig = prep.solver.run_transport_flight

    def capped(scene, static, cfg, n_photon, *a, **kw):
        cap = (int(n_photon) // cfg.batch + 2) * 400 // k
        return orig(scene, static, dataclasses.replace(cfg, max_events=cap),
                    n_photon, *a, **kw)
    prep.solver.run_transport_flight = capped
    return orig


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--requests', required=True,
                   help='window lengths in requests, comma-separated')
    p.add_argument('--seeds', default='')
    p.add_argument('--control-seeds', default='')
    p.add_argument('--cap-fault', type=int, default=0)
    p.add_argument('--device', default='cuda')
    p.add_argument('--out', default=None)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from run import _environment
    _environment()
    import torch

    from benchmark.lib import harness, manifest
    from benchmark.lib.trace import Shims
    if args.device == 'cuda' and not torch.cuda.is_available():
        print('calibrate: no CUDA device', file=sys.stderr)
        return 2
    cell = manifest.load_cell(ROOT, args.workload)
    lengths = sorted(int(r) for r in args.requests.split(','))
    seeds = [int(s) for s in args.seeds.split(',') if s]
    out = open(args.out, 'a') if args.out else None

    def emit(kind, seed, n_req, t, rows, extra=None):
        line = json.dumps(dict(
            {'workload': args.workload, 'kind': kind, 'seed': seed,
             'requests': n_req, 'correct': all(v <= lim for _, v, lim in rows),
             's': time.perf_counter() - t,
             'values': {k: v for k, v, _ in rows}}, **(extra or {})))
        print(line, flush=True)
        if out:
            out.write(line + '\n')
            out.flush()

    prep = harness.prepare(cell, args.device)
    harness.warm_up(prep)

    def program_window():
        with Shims(prep.solver, prep.flight) as shims:
            reqs, _ = harness.window(prep, shims, n_requests=lengths[-1])
        return reqs

    t = time.perf_counter()
    reqs = program_window()
    print(json.dumps({'program_s': time.perf_counter() - t,
                      'steps': [r.steps for r in reqs],
                      'cut': [r.n_cut for r in reqs],
                      'wall_s': [r.wall_s for r in reqs]}), flush=True)
    for seed in seeds:
        t = time.perf_counter()
        ref, n_b = harness.reference(prep, seed)
        for n in lengths:
            _, rows = harness.judge_requests(prep, reqs[:n], ref, n_b)
            emit('program', seed, n, t, rows)
    for seed in (int(s) for s in args.control_seeds.split(',') if s):
        t = time.perf_counter()
        images = control_images(prep, seed, lengths[-1])
        ref, n_b = harness.reference(prep, seed)
        for n in lengths:
            _, rows = harness.judge(
                prep, {k: v[:n] for k, v in images.items()},
                prep.n_asked * n, 0, 0, ref, n_b)
            emit('control', seed, n, t, rows)
    if args.cap_fault:
        t = time.perf_counter()
        orig = cap_cut(prep, args.cap_fault)
        try:
            reqs = program_window()
        finally:
            prep.solver.run_transport_flight = orig
        ref, n_b = harness.reference(prep, seeds[0])
        for n in lengths:
            _, rows = harness.judge_requests(prep, reqs[:n], ref, n_b)
            emit(f'cap_fault_{args.cap_fault}', seeds[0], n, t, rows,
                 {'steps': [r.steps for r in reqs[:n]]})
    if out:
        out.close()
    return 0


if __name__ == '__main__':
    sys.exit(main())

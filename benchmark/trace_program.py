"""A cell's windows with the program's own tracing
(``er3t_tpu_torch.util.trace``) on or off, and one profiled request with
it on, in one process on the card.

    python benchmark/trace_program.py --workload rad_les.run1e6 \\
        --seconds 51 --tracing 010101 --out spans.json

Set-up runs traced (for ``setup.mie_s``).  Then one window of ``--seconds``
for each character of ``--tracing`` (``1``: the program's tracing on,
``0``: off), each inside the benchmark's timing shims as in a ``--trace 1``
run, so ``step.ms`` and ``solver.host_ms_per_request`` read alike in both
kinds and their difference is the cost of the program's tracing.  A window
traced adds the numbers of :func:`benchmark.lib.spans.window_metrics`.
Last, one request outside the windows, traced and profiled over the
traffic's slice of steps: the existing device metrics from
:func:`benchmark.lib.trace.reduce_trace` and the slice put down to the
program's spans by :func:`benchmark.lib.spans.reduce_spans`.  Prints one
JSON object as the last line (and writes it to ``--out``).  No ``correct``
check: ``benchmark/run.py`` makes it.  The benchmark's runs never run
this.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent

# the existing per-layer metrics that a window gives without the profiler
WINDOW_METRICS = ('solver.host_ms_per_request', 'step.ms',
                  'flight.lane_iters_per_photon', 'flight.drain_step_pct',
                  'flight.idle_lane_pct', 'photons_per_s')
TRACE_METRICS = ('step.launches', 'kernels.device_ms_per_step',
                 'device.idle_pct', 'phase_pair_roofline')


def _record(requests):
    return types.SimpleNamespace(
        requests=requests, window_s=requests[-1].end - requests[0].start,
        photons=sum(r.n_launched - r.n_cut for r in requests))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seconds', type=float, default=51.0)
    p.add_argument('--tracing', default='01',
                   help="one window a character: '1' traced, '0' not")
    p.add_argument('--device', default='cuda')
    p.add_argument('--out', default=None)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark.run import _environment
    _environment()
    import torch

    from benchmark.frozen import measure
    from benchmark.lib import harness, manifest, spans
    from benchmark.lib.trace import Shims, reduce_trace
    from er3t_tpu_torch.util import trace
    on_card = torch.device(args.device).type == 'cuda'
    if on_card and not torch.cuda.is_available():
        print('trace_program: no CUDA device', file=sys.stderr)
        return 2
    cell = manifest.load_cell(ROOT, args.workload)
    read = {m: manifest.metric_reader(ROOT, m)
            for m in WINDOW_METRICS + TRACE_METRICS}

    trace.reset()
    trace.enable()
    prep = harness.prepare(cell, args.device)
    harness.warm_up(prep)
    setup_rep = trace.report()
    out = {'workload': args.workload,
           'card': measure.card_line() if on_card else 'cpu',
           'setup_s': time.perf_counter() - T0,
           'setup_spans': setup_rep['spans'], 'windows': []}
    fd, path = tempfile.mkstemp(suffix='.json', prefix='bench_trace_')
    os.close(fd)
    try:
        for flag in args.tracing:
            trace.reset()
            trace.enable(flag == '1')
            with Shims(prep.solver, prep.flight, trace_path=path) as shims:
                reqs, _ = harness.window(prep, shims, seconds=args.seconds)
            rec = _record(reqs)
            w = {'tracing': flag == '1', 'requests': len(reqs),
                 'steps': [r.steps for r in reqs],
                 'metrics': {m: read[m](rec) for m in WINDOW_METRICS}}
            if flag == '1':
                rep = trace.report()
                w['spans'] = spans.window_metrics(rep, setup_rep)
                w['span_totals'] = rep['spans']
                w['counters'] = rep['counters']
            out['windows'].append(w)
            print(json.dumps(w), flush=True)

        # one profiled request, traced
        trace.reset()
        trace.enable()
        tc = cell.traffic
        with Shims(prep.solver, prep.flight, tc['profile_start'],
                   tc['profile_steps'], path) as shims:
            shims.arm()
            prep.solver.solve(**prep.kw, seed=harness._fixed_seed(
                prep, harness._TRACED))
            harness._sync(args.device)
        trace.enable(False)
        if shims.traced:
            with open(path) as f:
                events = json.load(f).get('traceEvents', [])
            k1_bound_s = (measure.bound(measure.pair_cost(*shims.k1_args))[0]
                          if shims.k1_args is not None else None)
            tr = reduce_trace(path)
            out['profile'] = {'spans': spans.reduce_spans(events)}
            if tr is not None:         # None where no device op ran
                rec = types.SimpleNamespace(trace=tr, k1_bound_s=k1_bound_s)
                out['profile'].update(
                    metrics={m: read[m](rec) for m in TRACE_METRICS},
                    breakdown={'device_ops': tr['device_ops'],
                               'idle_gaps': tr['idle_gaps']},
                    busy_s=tr['busy_s'], window_s=tr['window_s'])
    finally:
        if os.path.exists(path):
            os.remove(path)
    line = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + '\n')
    print(line, flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())

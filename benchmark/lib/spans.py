"""The program's own spans and counters (``er3t_tpu_torch.util.trace``),
read from the benchmark's side.

:func:`window_metrics` turns the program's ``trace.report()`` of a window
(and of set-up) into per-layer numbers.  :func:`reduce_spans` reads the
Chrome trace of a profiled slice that ran with the program's tracing on,
where each program span is a ``user_annotation`` on the device trace's
clock: it labels each idle gap of the device with the innermost program
span open on the host as the gap began, names each device operation
``<span that launched it> | <kernel>`` (the launch found through its
runtime call's correlation id), and sums launches, host time and device
time a step for each phase of the step (``step.*``).

``benchmark/run.py`` does not turn the program's tracing on, so nothing
here is one of its metrics yet; ``benchmark/trace_program.py`` runs a cell
with it on.
"""

from __future__ import annotations

import bisect

from .trace import LOOP_LABEL, STEP_LABEL

__all__ = ['window_metrics', 'reduce_spans']

_DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')
_LAUNCH_CATS = ('cuda_runtime', 'cuda_driver')
_OUTCOMES = ('real', 'null', 'surface', 'toa', 'stopped')


def _mean(xs):
    return sum(xs) / len(xs) if xs else None


def window_metrics(rep, setup_rep=None):
    """Per-layer numbers of a window from the program's ``trace.report()``
    ``rep`` (every request in it a window request) and of set-up from
    ``setup_rep``; ``None`` for each number with nothing to read."""
    spans, ctr = rep['spans'], rep['counters']

    def per_request(name):
        return _mean([r['spans'].get(name, {}).get('total_ms', 0.0)
                      for r in rep['requests']])

    def total(name):
        return spans.get(name, {}).get('total_ms')

    steps = spans.get('flight.step', {}).get('count', 0)
    out = {'solve.scene_ms_per_request': per_request('solve.scene'),
           'solve.to_host_ms_per_request': per_request('solve.to_host'),
           'solve.reduce_ms_per_request': per_request('solve.reduce'),
           'step.issue_ms': total('flight.step') / steps if steps else None,
           'flight.read_wait_ms_per_step': (
               total('flight.read.wait') / steps
               if steps and 'flight.read.wait' in spans else None)}
    slots = ctr.get('flight.lane_slots')
    out['flight.idle_lane_pct'] = (100.0 * ctr['flight.idle_lanes'] / slots
                                   if slots else None)
    oc = [ctr.get('flight.iter_outcome.' + k) for k in _OUTCOMES]
    out['flight.null_iter_pct'] = (100.0 * oc[1] / sum(oc)
                                   if None not in oc and sum(oc) else None)
    out['setup.mie_s'] = (
        None if setup_rep is None else
        setup_rep['spans'].get('pre.mie', {}).get('total_ms', 0.0) * 1e-3)
    # the parts of the existing lumps, a step and a request
    for name in ('flight.deviates', 'flight.read', 'flight.compact'):
        out[name + '_ms_per_step'] = (total(name) or 0.0) / steps \
            if steps else None
    out['solve.flight_ms_per_request'] = per_request('solve.flight')
    out['solve.self_ms_per_request'] = _mean(
        [r['spans'].get('solve', {}).get('self_ms', 0.0)
         for r in rep['requests']])
    return out


def _strip(name):
    for p in ('void ', 'at::native::'):
        if name.startswith(p):
            name = name[len(p):]
    return name


def _innermost(spans):
    """(starts, labels): the innermost of the nested ``spans`` ((start,
    end, name)) open from ``starts[i]`` to the next start, ``None`` where
    none is (a child that outlasts its parent by rounding is cut to it)."""
    starts, labels, stack = [], [], []

    def mark(t):
        starts.append(t)
        labels.append(stack[-1][2] if stack else None)

    for a, b, name in sorted(spans, key=lambda s: (s[0], -s[1])):
        while stack and stack[-1][1] <= a:
            mark(stack.pop()[1])
        if stack:
            b = min(b, stack[-1][1])
        stack.append((a, b, name))
        mark(a)
    while stack:
        mark(stack.pop()[1])
    return starts, labels


def _label(seg, t):
    i = bisect.bisect_right(seg[0], t) - 1
    return seg[1][i] if i >= 0 else None


def reduce_spans(events, step_name='bench.step'):
    """Summary of the Chrome trace events ``events`` of a profiled slice
    (seconds and milliseconds as named): ``idle_gaps`` (idle time by the
    program span open on the host as each gap began; where none was, the
    labels of :func:`benchmark.lib.trace.reduce_trace`), ``idle_under_spans
    _pct``, ``device_ops`` (the ten largest by device time, named ``<span>
    | <kernel>``), ``launches_by_span`` (device operations a step by the
    span that launched them), ``launches_under_spans_pct``, and
    ``step_phases`` (for each ``step.*`` phase: launches, host ms and
    device ms a step).  ``None`` where the slice has no step or no device
    operation."""
    evs = [e for e in events if e.get('ph') == 'X']
    steps = sorted((e['ts'], e['ts'] + e.get('dur', 0.0)) for e in evs
                   if e.get('cat') == 'user_annotation'
                   and e.get('name') == step_name)
    dev = sorted((e for e in evs if e.get('cat') in _DEVICE_CATS),
                 key=lambda e: e['ts'])
    if not steps or not dev:
        return None
    prog = [e for e in evs if e.get('cat') == 'user_annotation'
            and not e.get('name', '').startswith('bench.')]
    seg = _innermost([(e['ts'], e['ts'] + e.get('dur', 0.0), e['name'])
                      for e in prog])
    launch_at = {e['args']['correlation']: e['ts'] for e in evs
                 if e.get('cat') in _LAUNCH_CATS
                 and 'correlation' in e.get('args', {})}

    n = len(steps)
    by_name, by_span, dev_ms = {}, {}, {}
    for e in dev:
        t = launch_at.get(e.get('args', {}).get('correlation'))
        sp = _label(seg, t) if t is not None else None
        d = e.get('dur', 0.0)
        key = f"{sp or '-'} | {_strip(e['name'])}"
        by_name[key] = by_name.get(key, 0.0) + d
        by_span[sp] = by_span.get(sp, 0) + 1
        dev_ms[sp] = dev_ms.get(sp, 0.0) + d

    # the slice: from the first step's issue to the end of the device work
    t_lo, t_hi = steps[0][0], max(e['ts'] + e.get('dur', 0.0) for e in dev)
    idle, cur = {}, t_lo
    starts = [s for s, _ in steps]
    for e in dev:
        a, b = max(e['ts'], t_lo), min(e['ts'] + e.get('dur', 0.0), t_hi)
        if b <= cur:
            continue
        if a > cur:
            label = _label(seg, cur)
            if label is None:
                i = bisect.bisect_right(starts, cur) - 1
                label = (STEP_LABEL if i >= 0 and cur < steps[i][1]
                         else LOOP_LABEL)
            idle[label] = idle.get(label, 0.0) + (a - cur)
        cur = b
    host = {}
    for e in prog:
        host[e['name']] = host.get(e['name'], 0.0) + e.get('dur', 0.0)
    fallback = idle.get(STEP_LABEL, 0.0) + idle.get(LOOP_LABEL, 0.0)
    all_idle = sum(idle.values())
    us = 1e-6
    return dict(
        n_steps=n, n_device_ops=len(dev),
        host_step_ms=_mean([b - a for a, b in steps]) * 1e-3,
        idle_gaps=sorted(([k, v * us] for k, v in idle.items()),
                         key=lambda r: -r[1]),
        idle_under_spans_pct=(100.0 * (1.0 - fallback / all_idle)
                              if all_idle else None),
        device_ops=sorted(([k, v * us] for k, v in by_name.items()),
                          key=lambda r: -r[1])[:10],
        launches_by_span={k or '-': v / n for k, v in sorted(
            by_span.items(), key=lambda kv: -kv[1])},
        launches_under_spans_pct=100.0 * (1.0 - by_span.get(None, 0)
                                          / len(dev)),
        step_phases={k: {'launches': by_span.get(k, 0) / n,
                         'host_ms': host[k] * 1e-3 / n,
                         'device_ms': dev_ms.get(k, 0.0) * 1e-3 / n}
                     for k in sorted(host) if k.startswith('step.')})

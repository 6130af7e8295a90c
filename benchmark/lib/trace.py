"""The run's spans, counters and device trace, taken from the benchmark's
side.

:class:`Shims` wraps the port's functions for the window and restores them
after.  In every run:

* ``solver.run_transport_flight`` (as ``solve`` calls it): the call gets a
  ``stats`` dict, and its tallies' counters and the photons still in
  flight at its step cap (``stats['in_flight']``) are kept.

In a ``--trace 1`` run (a ``trace_path`` given) besides:

* ``run_transport_flight``'s wall time is taken, ending in a synchronize;
* ``FlightKernel.step``: counted, under the span ``bench.step``; once
  :meth:`Shims.arm` is called, the profiler runs over a bounded slice of
  the steps that follow (``start`` to ``start + steps``), at the full
  batch of the request it is armed for;
* the phase-pair kernel's entry in ``mc_flight``: the arguments of the
  first call of the slice are kept, for the kernel's bytes and operations.

:func:`reduce_trace` reads the profiler's Chrome trace: kernel and copy
times, the device's busy time over the slice, and its idle gaps labelled
by what the host was doing when each began: issuing a step (inside
``bench.step``) or in the flight's loop between steps.
"""

from __future__ import annotations

import bisect
import json
import os
import time

import torch

__all__ = ['Shims', 'reduce_trace']

# what the host was doing when a gap began: the slice lies inside one
# flight, so outside a step the host is in the flight's loop
STEP_LABEL = 'step issue'
LOOP_LABEL = 'flight loop: per-step read-back, deviates'

_DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


class Shims:
    def __init__(self, solver_mod, flight_mod, start=0, steps=0,
                 trace_path=None):
        self.solver, self.flight = solver_mod, flight_mod
        self.start, self.steps = int(start), int(steps)
        self.trace_path = trace_path
        self.timed = trace_path is not None
        self.flights = []          # one dict per run_transport_flight call
        self.n_step = 0
        self.k1_args = None
        self.prof = None
        self.armed = False
        self.traced = False

    def arm(self):
        """Profile the slice of the next request (the profiler's tracer,
        once started, slows every later launch: so only after the
        window)."""
        self.armed, self.n_step = True, 0

    def __enter__(self):
        self._orig = (self.solver.run_transport_flight,
                      self.flight.FlightKernel.step, self.flight.phase_pair)
        orig_run, orig_step, orig_pair = self._orig
        shim = self

        def run_transport_flight(*a, **kw):
            stats = {}
            kw['stats'] = stats
            t0 = time.perf_counter()
            tal = orig_run(*a, **kw)
            if shim.timed:
                _sync()
            shim.flights.append(dict(
                wall_s=time.perf_counter() - t0, stats=stats,
                in_flight=int(stats['in_flight']),
                n_steps=int(tal.n_steps), lane_iters=float(tal.lane_iters),
                n_launched=int(tal.n_launched)))
            return tal

        def step(kern, c, *a, **kw):
            shim.n_step += 1
            if shim.armed and shim.n_step == shim.start \
                    and shim.prof is None:
                shim._start_profiler()
            with torch.profiler.record_function('bench.step'):
                out = orig_step(kern, c, *a, **kw)
            if shim.prof is not None and not shim.traced \
                    and shim.n_step == shim.start + shim.steps - 1:
                shim._stop_profiler()
            return out

        def phase_pair(*a):
            if shim.prof is not None and not shim.traced \
                    and shim.k1_args is None:
                shim.k1_args = a
            return orig_pair(*a)

        self.solver.run_transport_flight = run_transport_flight
        if self.timed:
            self.flight.FlightKernel.step = step
            self.flight.phase_pair = phase_pair
        return self

    def __exit__(self, *exc):
        if self.prof is not None and not self.traced:
            self._stop_profiler()
        (self.solver.run_transport_flight, self.flight.FlightKernel.step,
         self.flight.phase_pair) = self._orig
        return False

    def _start_profiler(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.start()

    def _stop_profiler(self):
        _sync()
        self.prof.stop()
        self.prof.export_chrome_trace(self.trace_path)
        self.traced = True


def _intervals(events):
    return sorted((e['ts'], e['ts'] + e.get('dur', 0.0)) for e in events)


def reduce_trace(path, k1_name='phase_pair'):
    """Summary of the Chrome trace at ``path`` (deleted after): seconds
    throughout."""
    with open(path) as f:
        tr = json.load(f)
    os.remove(path)
    evs = [e for e in tr.get('traceEvents', []) if e.get('ph') == 'X']
    dev = [e for e in evs if e.get('cat') in _DEVICE_CATS]
    steps = _intervals(e for e in evs if e.get('cat') == 'user_annotation'
                       and e.get('name') == 'bench.step')
    if not dev or not steps:
        return None
    kern = [e for e in dev if e.get('cat') == 'kernel']
    by_name = {}
    for e in dev:
        by_name[e['name']] = by_name.get(e['name'], 0.0) + e.get('dur', 0.0)
    k1 = [e.get('dur', 0.0) for e in kern if k1_name in e['name']]
    # the slice: from the first step's issue to the end of the device work
    t_lo = steps[0][0]
    t_hi = max(b for _, b in _intervals(dev))
    busy, gaps, cur = 0.0, [], t_lo
    for a, b in _intervals(dev):
        a, b = max(a, t_lo), min(b, t_hi)
        if b <= cur:
            continue
        if a > cur:
            gaps.append((cur, a))
            cur = a
        busy += b - cur
        cur = b
    idle = {}
    starts = [s for s, _ in steps]
    for a, b in gaps:
        i = bisect.bisect_right(starts, a) - 1
        label = STEP_LABEL if i >= 0 and a < steps[i][1] else LOOP_LABEL
        idle[label] = idle.get(label, 0.0) + (b - a)
    us = 1e-6
    return dict(
        window_s=(t_hi - t_lo) * us, busy_s=busy * us, n_steps=len(steps),
        n_kernels=len(kern),
        kernel_s=sum(e.get('dur', 0.0) for e in kern) * us,
        k1_mean_s=(sum(k1) / len(k1) * us) if k1 else None,
        device_ops=sorted(([n, t * us] for n, t in by_name.items()),
                          key=lambda r: -r[1])[:10],
        idle_gaps=sorted(([n, t * us] for n, t in idle.items()),
                         key=lambda r: -r[1])[:10])

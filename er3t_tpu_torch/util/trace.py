"""The port's spans and counters, off by default.

    from er3t_tpu_torch.util import trace
    trace.enable()
    ...                      # solve(...) and the rest, as usual
    rep = trace.report()     # per request and in total
    trace.reset()

Off, :func:`span` is one flag test that returns a shared no-op, and
:func:`phase` and :func:`count` return at once: the hot path reads no clock,
records no CUDA event and keeps no device counter.  On, a span takes the
host's ``time.perf_counter_ns`` (the clock of a caller's request walls) as
it opens and closes, and records its name, its parent span and its request:
the sequence number of the enclosing ``span(..., request=True)``, which
:func:`~er3t_tpu_torch.rtm.solver.solve` opens once a call.  While
``torch.profiler`` runs, each span also enters
``torch.profiler.record_function`` under its own name, so it appears in the
profiler's Chrome trace on the device trace's clock.  Spans and counts are
kept in memory and summed only by :func:`report`.

The spans, from the request down (``solve.*`` in ``rtm/solver.py``,
``flight.*`` in ``rtm/mc_flight.py`` and ``rtm/mc.py``, ``step.*`` in
``FlightKernel.step``, ``pre.mie`` in ``pre/pha.py``)::

    solve                      one call of solve: a request
      solve.scene              build_scene
      solve.flight             a chunk's transport run (flight, marching or
                               a mesh's runner)
        flight.deviates        the step's deviates
        flight.step            one FlightKernel.step (or marching step)
          step.split, step.respawn, step.move, step.collide,
          step.estimate, step.turn, step.roulette, or in their place
          step.post (the second half as one kernel)
                               (on the card: only while capturing)
          flight.graph.capture   one captured half of a replayed step
        flight.read            the loop's per-step read-back:
          flight.read.wait       until the device has done the queued work
          flight.read.copy       the two numbers to the host
        flight.compact         a drain stage's compaction
      solve.to_host            the summed tallies to the host
      solve.reduce             the physical reductions, mean and std
    pre.mie                    the Mie tables of pha_mie_wc (set-up)

Counters: ``flight.lane_slots`` and ``flight.idle_lanes`` (lane slots of
the flight steps, and those with no live photon) and
``flight.iter_outcome.<class>`` (each active lane iteration of a flight
step as ``real``, ``null`` collision, ``surface`` hit, ``toa`` escape or
``stopped`` short of its end at a crossing or slab clamp) and
``flight.graph.captures``, ``flight.graph.replays`` and
``flight.graph.eager_steps`` (the CUDA graphs captured, the steps replayed
from them, the steps run eagerly while replaying) and
``flight.post.fused_steps`` (the steps whose second half ran as one
kernel); see
:func:`~er3t_tpu_torch.rtm.mc_flight.transport_flight`.

Memory grows with the spans recorded (about a dozen a flight step), until
:func:`reset`.
"""

from __future__ import annotations

import time

import torch

__all__ = ['enable', 'enabled', 'reset', 'span', 'phase', 'count', 'report']

_on = False
_clock = time.perf_counter_ns

# a span: [name, start_ns, end_ns, parent index, request, record_function,
# is a phase]
_NAME, _START, _END, _PARENT, _REQUEST, _RF, _PHASE = range(7)


class _Log:
    def __init__(self):
        self.spans = []         # every span opened, in order
        self.stack = []         # indices of the open spans
        self.counts = []        # (name, n, request)
        self.n_requests = 0
        self.request = None     # the current request's number


_log = _Log()


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


def enable(on=True):
    """Turn tracing on (or off, with ``on=False``)."""
    global _on
    _on = bool(on)


def enabled():
    """Whether tracing is on."""
    return _on


def reset():
    """Forget every span, counter and request number recorded so far."""
    global _log
    _log = _Log()


def _open(name, is_phase=False):
    rf = None
    if torch._C._autograd._profiler_enabled():
        rf = torch.profiler.record_function(name)
        rf.__enter__()
    log = _log
    i = len(log.spans)
    log.spans.append([name, _clock(), None,
                      log.stack[-1] if log.stack else None, log.request, rf,
                      is_phase])
    log.stack.append(i)
    return log, i


def _close(log, i):
    """Close span ``i`` of ``log`` and every span still open inside it."""
    if i not in log.stack:
        return
    t = _clock()
    while log.stack:
        j = log.stack.pop()
        rec = log.spans[j]
        rec[_END] = t
        if rec[_RF] is not None:
            rec[_RF].__exit__(None, None, None)
            rec[_RF] = None
        if j == i:
            break


class _Span:
    __slots__ = ('name', 'request', 'log', 'i', 'prev')

    def __init__(self, name, request):
        self.name, self.request = name, request

    def __enter__(self):
        if self.request:
            _log.n_requests += 1
            self.prev, _log.request = _log.request, _log.n_requests
        self.log, self.i = _open(self.name)
        return self

    def __exit__(self, *exc):
        _close(self.log, self.i)
        if self.request:
            self.log.request = self.prev
        return False


def span(name, request=False):
    """A context manager timing ``name``; ``request=True`` opens a new
    request, which every span and count inside it belongs to."""
    if not _on:
        return _NO_SPAN
    return _Span(name, request)


def phase(name):
    """Close the phase open in the innermost span, if any, and open the
    phase ``name`` (none for ``None``): the boundaries of one long body.
    The enclosing span's end closes its last phase."""
    if not _on:
        return
    log = _log
    if log.stack and log.spans[log.stack[-1]][_PHASE]:
        _close(log, log.stack[-1])
    if name is not None:
        _open(name, is_phase=True)


def count(name, n):
    """Add ``n`` to the counter ``name``."""
    if _on:
        _log.counts.append((name, n, _log.request))


def _sum(spans, child_ns, counts):
    out = {}
    for i, rec in spans:
        d = rec[_END] - rec[_START]
        s = out.setdefault(rec[_NAME], {'count': 0, 'total_ms': 0.0,
                                        'self_ms': 0.0})
        s['count'] += 1
        s['total_ms'] += d * 1e-6
        s['self_ms'] += (d - child_ns.get(i, 0)) * 1e-6
    ctr = {}
    for name, n, _ in counts:
        ctr[name] = ctr.get(name, 0) + n
    return {'spans': out, 'counters': ctr}


def report():
    """The closed spans and the counters, in total and per request:
    ``{'spans': {name: {'count', 'total_ms', 'self_ms'}}, 'counters':
    {name: n}, 'requests': [{'request': k, 'spans': ..., 'counters': ...}]}``
    (requests in order; spans and counts outside every request are in the
    totals only).  A span's self time is its time less its children's."""
    log = _log
    closed = [(i, r) for i, r in enumerate(log.spans) if r[_END] is not None]
    child_ns = {}
    for _, r in closed:
        if r[_PARENT] is not None:
            child_ns[r[_PARENT]] = (child_ns.get(r[_PARENT], 0)
                                    + r[_END] - r[_START])
    rep = _sum(closed, child_ns, log.counts)
    rep['requests'] = [
        dict(request=k, **_sum([(i, r) for i, r in closed
                                if r[_REQUEST] == k], child_ns,
                               [c for c in log.counts if c[2] == k]))
        for k in sorted({r[_REQUEST] for _, r in closed} - {None})]
    return rep

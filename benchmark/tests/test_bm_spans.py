"""The readers of the program's own counters and spans on known inputs:
``flight.idle_lane_pct`` (and nothing from a program without the
counters), the numbers of a window's ``trace.report()``, and a made-up
profiled slice put down to the program's spans."""

import types

import pytest

from benchmark.lib import manifest, spans
from benchmark.lib.trace import LOOP_LABEL, STEP_LABEL

from conftest import ROOT


def _run(*stats):
    flights = [{'stats': s} for s in stats]
    return types.SimpleNamespace(requests=[
        types.SimpleNamespace(flights=flights[:1]),
        types.SimpleNamespace(flights=flights[1:])])


def test_idle_lane_pct_and_nothing_without_the_counters():
    read = manifest.metric_reader(ROOT, 'flight.idle_lane_pct')
    got = read(_run({'lane_slots': 100, 'idle_lanes': 30},
                    {'lane_slots': 300, 'idle_lanes': 10}))
    assert got == pytest.approx(10.0)
    # a program without the lane counters
    assert read(_run({'stage_steps': [3], 'in_flight': 0},
                     {'stage_steps': [4], 'in_flight': 0})) is None


def _span(total, count=1, self_ms=None):
    return {'count': count, 'total_ms': total,
            'self_ms': total if self_ms is None else self_ms}


def test_window_metrics_of_a_report():
    req = [{'request': k, 'counters': {}, 'spans': {
        'solve': _span(1000.0 + k, self_ms=5.0),
        'solve.scene': _span(10.0 * k), 'solve.to_host': _span(4.0),
        'solve.reduce': _span(30.0, 2), 'solve.flight': _span(900.0)}}
        for k in (1, 2)]
    rep = {'requests': req, 'spans': {
        'flight.step': _span(800.0, 100), 'flight.read.wait': _span(5.0, 102),
        'flight.read': _span(20.0, 102), 'flight.deviates': _span(40.0, 100),
        'flight.compact': _span(2.0, 2)},
        'counters': {'flight.lane_slots': 1000, 'flight.idle_lanes': 250,
                     'flight.iter_outcome.real': 300,
                     'flight.iter_outcome.null': 150,
                     'flight.iter_outcome.surface': 100,
                     'flight.iter_outcome.toa': 100,
                     'flight.iter_outcome.stopped': 100}}
    setup = {'spans': {'pre.mie': _span(4500.0)}}
    m = spans.window_metrics(rep, setup)
    assert m['solve.scene_ms_per_request'] == 15.0
    assert m['solve.to_host_ms_per_request'] == 4.0
    assert m['solve.reduce_ms_per_request'] == 30.0
    assert m['step.issue_ms'] == 8.0
    assert m['flight.read_wait_ms_per_step'] == 0.05
    assert m['flight.idle_lane_pct'] == 25.0
    assert m['flight.null_iter_pct'] == 20.0
    assert m['setup.mie_s'] == 4.5
    assert m['flight.read_ms_per_step'] == 0.2
    assert m['solve.self_ms_per_request'] == 5.0
    # a cell without Mie tables; a report with nothing traced
    assert spans.window_metrics(rep, {'spans': {}})['setup.mie_s'] == 0.0
    empty = spans.window_metrics({'requests': [], 'spans': {},
                                  'counters': {}})
    assert all(v is None for v in empty.values())


def _x(cat, name, ts, dur, corr=None):
    e = dict(ph='X', cat=cat, name=name, ts=ts, dur=dur)
    if corr is not None:
        e['args'] = {'correlation': corr}
    return e


def test_slice_put_down_to_program_spans():
    """Two steps (0-20, 40-60 us) with phases step.move and step.collide,
    a read between them; kernels launched from each, a fill whose launch
    is not in the trace, and a gap that begins outside every program
    span."""
    ev = [_x('user_annotation', 'bench.step', 0, 20),
          _x('user_annotation', 'bench.step', 40, 20),
          _x('user_annotation', 'step.move', 0, 10),
          _x('user_annotation', 'step.collide', 10, 10),
          _x('user_annotation', 'flight.read', 25, 8),
          _x('user_annotation', 'flight.read.wait', 25, 6),
          _x('user_annotation', 'step.move', 40, 12),
          _x('user_annotation', 'step.collide', 52, 8),
          _x('cuda_runtime', 'cudaLaunchKernel', 1, 1, corr=1),
          _x('cuda_runtime', 'cudaLaunchKernel', 11, 1, corr=2),
          _x('cuda_runtime', 'cudaMemcpyAsync', 32, 1, corr=3),
          _x('cuda_runtime', 'cudaLaunchKernel', 41, 1, corr=4),
          _x('cuda_runtime', 'cudaLaunchKernel', 53, 1, corr=5),
          _x('kernel', 'void at::native::add_kernel', 2, 5, corr=1),
          _x('kernel', 'phase_pair_kernel', 12, 6, corr=2),
          _x('gpu_memcpy', 'Memcpy DtoH', 33, 1, corr=3),
          _x('gpu_memset', 'Memset (Device)', 34, 1, corr=9),
          _x('kernel', 'void at::native::add_kernel', 45, 4, corr=4),
          _x('kernel', 'phase_pair_kernel', 58, 6, corr=5)]
    r = spans.reduce_spans(ev)
    assert r['n_steps'] == 2 and r['n_device_ops'] == 6
    assert r['host_step_ms'] == pytest.approx(0.02)
    gaps = {k: v * 1e6 for k, v in r['idle_gaps']}
    # 0-2 and 7-12 in move; 18-33 from collide (the read begins later);
    # 35-45 begins in the loop, outside every span; 49-58 in move
    assert gaps == pytest.approx({'step.move': 2 + 5 + 9,
                                  'step.collide': 15, LOOP_LABEL: 10})
    assert STEP_LABEL not in gaps
    assert r['idle_under_spans_pct'] == pytest.approx(100 * 31 / 41)
    ops = dict(r['device_ops'])
    assert ops['step.move | add_kernel'] == pytest.approx(9e-6)
    assert ops['step.collide | phase_pair_kernel'] == pytest.approx(12e-6)
    assert ops['flight.read | Memcpy DtoH'] == pytest.approx(1e-6)
    assert ops['- | Memset (Device)'] == pytest.approx(1e-6)
    assert r['launches_by_span'] == {'step.move': 1.0, 'step.collide': 1.0,
                                     'flight.read': 0.5, '-': 0.5}
    assert r['launches_under_spans_pct'] == pytest.approx(100 * 5 / 6)
    ph = r['step_phases']
    assert set(ph) == {'step.move', 'step.collide'}
    assert ph['step.move'] == pytest.approx(
        {'launches': 1.0, 'host_ms': 0.011, 'device_ms': 0.0045})
    assert ph['step.collide']['device_ms'] == pytest.approx(0.006)
    assert spans.reduce_spans([]) is None

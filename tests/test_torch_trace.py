"""The port's spans and counters (er3t_tpu_torch.util.trace) on a tiny
broken-cloud scene: span nesting, self time and requests; nothing recorded
and nothing in a profiler's trace with tracing off; the loop's spans and
counters against brute-force counts of the same flight; and tallies equal
bit for bit with tracing on and off."""

import json

import numpy as np
import pytest
import torch

from er3t_tpu_torch.pre.abs import abs_synthetic
from er3t_tpu_torch.pre.atm import atm_atmmod
from er3t_tpu_torch.pre.cld import cld_gen_hem
from er3t_tpu_torch.rtm import mc_flight, solver
from er3t_tpu_torch.rtm.mc import SolverConfig
from er3t_tpu_torch.rtm.out import spectral_factors
from er3t_tpu_torch.rtm.scene import build_scene
from er3t_tpu_torch.util import trace

torch.set_num_threads(2)
B = 2048                  # drains to one stage of 256 lanes
STEP_PHASES = {'step.respawn', 'step.move', 'step.collide', 'step.estimate',
               'step.turn', 'step.roulette'}


@pytest.fixture
def tracing():
    """Tracing on, from a clean record; off and cleared after."""
    trace.reset()
    trace.enable()
    yield
    trace.enable(False)
    trace.reset()


@pytest.fixture(scope='module')
def case():
    atm = atm_atmmod(np.array([0.0, 0.5, 1.0, 1.5, 3.0, 6.0, 10.0, 20.0]))
    ab = abs_synthetic(650.0, atm, ng=2)
    cld = cld_gen_hem(nx=12, ny=12, nz=2, dx=0.2, dy=0.2, dz=0.5,
                      cloud_frac_tgt=0.3, radii=(0.3,), cot_scale=12.0,
                      cloud_base=0.5, seed=3)
    kw = dict(atm=atm, abs_coef=ab, cld=cld, surface=0.05,
              solar_zenith_angle=30.0, solar_azimuth_angle=45.0)
    scene, st = build_scene(**kw, device='cpu')
    return kw, scene, st


def _flight(case, target, photons=1200, stats=None, max_events=0):
    _, scene, st = case
    cfg = SolverConfig(target=target, batch=B, tile_size=4, qmc_launch=True,
                       flux_per_column=True, flux_kcross=4,
                       max_events=max_events)
    ab = case[0]['abs_coef']
    kw = ({'rad_w': spectral_factors(ab, nz_out=1)[0][0]}
          if target == 'radiance'
          else {'flux_w': spectral_factors(ab, nz_out=st.nz + 1)[0]})
    return mc_flight.run_transport_flight(scene, st, cfg, photons, 11,
                                          'cpu', stats=stats, **kw)


@pytest.fixture(scope='module', params=['radiance', 'flux'])
def traced(request, case):
    """One flight with tracing off and the same flight traced, the traced
    one with each step's live lanes counted by brute force from the
    carries (lanes alive before the step, plus the photons it launched)
    and the phase-pair lookups counted."""
    target = request.param
    trace.enable(False)
    off = _flight(case, target)
    per_step, k1 = [], [0]
    step, pair = mc_flight.FlightKernel.step, mc_flight.phase_pair

    def counting_step(kern, c, *a, **kw):
        out = step(kern, c, *a, **kw)
        per_step.append((c.alive.numel(), int(c.alive.sum()),
                         int(out.launched - c.launched)))
        return out

    def counting_pair(*a):
        k1[0] += 1
        return pair(*a)

    stats = {}
    trace.reset()
    trace.enable()
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(mc_flight.FlightKernel, 'step', counting_step)
            mp.setattr(mc_flight, 'phase_pair', counting_pair)
            on = _flight(case, target, stats=stats)
        rep = trace.report()
    finally:
        trace.enable(False)
        trace.reset()
    return dict(target=target, off=off, on=on, stats=stats, rep=rep,
                per_step=per_step, k1=k1[0])


def test_spans_nest_with_self_time_and_requests(tracing, monkeypatch):
    ticks = iter(range(0, 10 ** 6, 10))
    monkeypatch.setattr(trace, '_clock', lambda: next(ticks) * 10 ** 6)
    with trace.span('pre.mie'):                 # 0 .. 10 ms, no request
        pass
    for _ in range(2):
        with trace.span('solve', request=True):
            with trace.span('solve.flight'):
                trace.phase('step.move')
                trace.phase('step.turn')        # closes step.move
                trace.count('flight.lane_slots', 5)
            with trace.span('solve.reduce'):
                pass
    trace.phase('step.move')                    # outside any span
    trace.phase(None)
    rep = trace.report()
    # the first request (ms): solve 20..100, flight 30..70 (move 40..50,
    # turn 60..70, closed with it), reduce 80..90
    req = rep['requests']
    assert [r['request'] for r in req] == [1, 2]
    for r in req:
        s = r['spans']
        assert s['solve'] == {'count': 1, 'total_ms': 80.0, 'self_ms': 30.0}
        assert s['solve.flight'] == {'count': 1, 'total_ms': 40.0,
                                     'self_ms': 20.0}
        assert s['step.move']['total_ms'] == 10.0
        assert s['step.turn']['total_ms'] == 10.0
        assert s['solve.reduce']['self_ms'] == 10.0
        assert r['counters'] == {'flight.lane_slots': 5}
    assert rep['spans']['solve']['count'] == 2
    assert rep['spans']['step.move']['count'] == 3
    assert rep['spans']['pre.mie']['total_ms'] == 10.0
    assert 'pre.mie' not in req[0]['spans']
    assert rep['counters'] == {'flight.lane_slots': 10}


def test_solve_spans_each_request(case, tracing):
    kw = case[0]
    for seed in (1, 2):
        solver.solve(**kw, target='flux', photons=200, n_run=1, batch=256,
                     seed=seed, device='cpu')
    req = trace.report()['requests']
    assert [r['request'] for r in req] == [1, 2]
    for r in req:
        s = r['spans']
        assert {k: s[k]['count'] for k in ('solve', 'solve.scene',
                                           'solve.flight', 'solve.to_host')} \
            == dict.fromkeys(('solve', 'solve.scene', 'solve.flight',
                              'solve.to_host'), 1)
        assert s['solve.reduce']['count'] == 2
        assert s['flight.step']['count'] > 0
        inner = sum(s[k]['total_ms'] for k in ('solve.scene', 'solve.flight',
                                               'solve.to_host',
                                               'solve.reduce'))
        assert inner <= s['solve']['total_ms']
        assert s['solve']['self_ms'] == pytest.approx(
            s['solve']['total_ms'] - inner)


@pytest.mark.parametrize('on', [False, True])
def test_spans_reach_a_profile_only_when_on(case, tmp_path, on):
    trace.reset()
    trace.enable(on)
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            _flight(case, 'radiance', photons=300, max_events=2)
        rep = trace.report()
    finally:
        trace.enable(False)
        trace.reset()
    path = tmp_path / 'trace.json'
    prof.export_chrome_trace(str(path))
    names = {e.get('name') for e in json.loads(path.read_text())
             ['traceEvents'] if e.get('cat') == 'user_annotation'}
    program = {n for n in names if n.startswith(('flight.', 'step.'))}
    if on:
        assert program >= STEP_PHASES | {'flight.step', 'flight.deviates',
                                         'flight.read.wait'}
        assert rep['spans']['flight.step']['count'] > 0
    else:
        assert program == set()
        assert rep == {'spans': {}, 'counters': {}, 'requests': []}


def test_step_spans_equal_steps_and_phase_pair_calls(traced):
    s = traced['rep']['spans']
    n_steps = int(traced['on'].n_steps)
    assert s['flight.step']['count'] == n_steps == traced['k1'] \
        == len(traced['per_step'])
    assert s['flight.deviates']['count'] == n_steps
    for p in STEP_PHASES:
        assert s[p]['count'] == n_steps
    # one read before each step, one that ends each stage's loop, one for
    # stats; one compaction into the drain stage
    assert s['flight.read']['count'] == n_steps + 3
    assert s['flight.read.wait']['count'] == s['flight.read.copy']['count'] \
        == s['flight.read']['count']
    assert s['flight.compact']['count'] == 1
    assert 'host_read_s' not in traced['stats']


def test_idle_lanes_equal_a_brute_force_count(traced):
    slots = sum(b for b, _, _ in traced['per_step'])
    idle = sum(b - alive - spawned for b, alive, spawned
               in traced['per_step'])
    ctr = traced['rep']['counters']
    assert ctr['flight.lane_slots'] == traced['stats']['lane_slots'] == slots
    assert ctr['flight.idle_lanes'] == traced['stats']['idle_lanes'] == idle
    assert 0 < idle < slots
    assert slots == float(traced['on'].lane_iters)


def test_outcomes_sum_to_active_lane_iterations(traced):
    ctr = traced['rep']['counters']
    got = {k: ctr['flight.iter_outcome.' + k] for k in mc_flight.OUTCOMES}
    assert got == traced['stats']['iter_outcome']
    assert sum(got.values()) == ctr['flight.lane_slots'] \
        - ctr['flight.idle_lanes']
    assert got['real'] > 0 and got['null'] > 0 and got['stopped'] > 0
    assert got['surface'] + got['toa'] > 0


def test_tallies_equal_with_tracing_on_and_off(traced):
    off, on = traced['off'], traced['on']
    for f in ('rad', 'flux', 'absorbed', 'n_launched', 'n_steps',
              'lane_iters'):
        assert torch.equal(getattr(off, f), getattr(on, f)), f

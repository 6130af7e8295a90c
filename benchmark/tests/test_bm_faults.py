"""A run with the timed path broken underneath comes out not correct.

Each case drives the rest of a run (set-up, the closed-loop window, the
metrics, the check against the plain reference) at the CPU test size,
past the harness's look for a card, with one fault planted in the port:

* ``step_unchanged``: ``FlightKernel.step`` returns its state unchanged
  but for the loop's step count, so no photon is launched or tallied;
* ``half_batch``: every flight runs half its photons and its tallies are
  normalised by the half that ran (the mean over the rest);
* ``answer_altered``: the image or flux field is rolled by a quarter of
  the domain, and the heating-rate profile by a quarter of its layers,
  where ``rtm/out.py`` produces them;
* ``half_deposits``: half of what the photons deposit is left out where
  the field (or the heating rate) is produced, and the mean taken over all
  of them;
* ``drain_cut``: every flight stops at a 30th of its step cap, its
  photons still in flight dropped.

One chip only: no exchange between chips to leave out.
"""

import time
import types

import numpy as np
import pytest

from benchmark.lib import harness

from conftest import tiny_cell

CELLS = ['rad_les.run1e6', 'flux_les.run1e6', 'flux_les.hr1e6']


def _plant(monkeypatch, fault):
    from er3t_tpu_torch.rtm import mc_flight, out, solver
    if fault == 'step_unchanged':
        monkeypatch.setattr(mc_flight.FlightKernel, 'step',
                            lambda self, c, *a, **k: c._replace(
                                step=c.step + 1))
    elif fault == 'half_batch':
        orig = solver.run_transport_flight

        def half(scene, static, cfg, n_photon, seed, *a, **k):
            return orig(scene, static, cfg, n_photon // 2, seed, *a, **k)
        monkeypatch.setattr(solver, 'run_transport_flight', half)
    elif fault == 'drain_cut':
        from benchmark.calibrate import cap_cut
        prep = types.SimpleNamespace(solver=types.SimpleNamespace(
            run_transport_flight=solver.run_transport_flight))
        cap_cut(prep, 30)
        monkeypatch.setattr(solver, 'run_transport_flight',
                            prep.solver.run_transport_flight)
    elif fault in ('answer_altered', 'half_deposits'):
        def alter(a):
            a = np.asarray(a)
            if fault == 'half_deposits':
                return a * 0.5
            return np.roll(a, a.shape[0] // 4, axis=0)
        orig_r, orig_f = out.reduce_radiance, out.reduce_flux
        orig_h = out.heating_rate_from_absorbed

        def rad(*a, **k):
            r = orig_r(*a, **k)
            return dict(r, rad=alter(r['rad']))

        def flux(*a, **k):
            r = orig_f(*a, **k)
            return {key: (alter(v) if key != 'toa' else v)
                    for key, v in r.items()}
        monkeypatch.setattr(out, 'reduce_radiance', rad)
        monkeypatch.setattr(out, 'reduce_flux', flux)
        monkeypatch.setattr(out, 'heating_rate_from_absorbed',
                            lambda *a, **k: alter(orig_h(*a, **k)))


def _run(workload):
    return harness.run_cell(tiny_cell(workload), 2 ** 31 + 12345, 0.5, False,
                            'cpu', time.perf_counter())


@pytest.mark.parametrize('workload', CELLS)
def test_sound_run_is_correct(workload):
    out = _run(workload)
    assert out['correct'], out['checks']
    assert set(out['metrics']) == {'photons_per_s', 's_to_5pct', 'setup_s'} \
        or out['attempted'] == 1
    assert list(out)[-1] == 'checks'


@pytest.mark.parametrize('fault', ['step_unchanged', 'half_batch',
                                   'answer_altered', 'half_deposits',
                                   'drain_cut'])
@pytest.mark.parametrize('workload', CELLS)
def test_fault_is_not_correct(monkeypatch, workload, fault):
    _plant(monkeypatch, fault)
    out = _run(workload)
    assert not out['correct'], out['checks']

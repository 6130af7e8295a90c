"""FlightKernel.step cut in two at the phase-pair kernel (K1), and the
replay of the two halves as captured graphs, on the CPU.

* The halves against the step as it stood before the cut: from one
  carry and one stream of deviates, ``_step_post(mid, *phase_pair(*k1))``
  after ``k1, mid = _step_pre(...)`` (under the ``'phase'`` ablation the
  stand-in pair that ``_step_pre`` returns) must give every lane field,
  the launch count, the tallies and the outcome counts bit for bit as
  ``tests/data/flight_step_outputs.npz`` holds them.  That file was
  written by :func:`write_outputs` with the uncut step (radiance with Mie
  and TMS rows and ``rad_w``, per-column flux with the crossing clamp and
  ``flux_w``, the heating rate's domain-average flux with the absorbed
  tally, the airborne camera with aperture and pathlength, and the
  ``'phase'`` ablation); rewrite it only where the step's arithmetic is
  meant to change.
* The replay's bookkeeping (:class:`~er3t_tpu_torch.rtm.mc_flight._StepGraphs`):
  with the capture replaced by a stand-in that records the half and runs
  it again at each replay, writing its results where the first run put
  them (what a replayed graph does), a flight must equal the eager flight
  bit for bit, with one eager step and two captures per batch width.
* Whole flights against the flights as they stood before the step's
  decisions were gathered into one place each: each ``FLIGHTS`` case's
  tallies, ``stats``, counters and span counts, traced, bit for bit as
  ``tests/data/flight_outputs.npz`` holds them (written by
  :func:`write_flights`; rewrite it only where a flight is meant to
  change).
* Without a card nothing replays: ``stats['graph_steps']`` and the
  ``flight.graph.*`` counters read 0.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_flatten

from er3t_tpu_torch.pre.abs import abs_synthetic
from er3t_tpu_torch.pre.atm import atm_atmmod
from er3t_tpu_torch.pre.cld import cld_gen_hem
from er3t_tpu_torch.pre.pha import pha_mie_wc
from er3t_tpu_torch.rtm import mc_flight
from er3t_tpu_torch.rtm.mc import SolverConfig
from er3t_tpu_torch.rtm.out import spectral_factors
from er3t_tpu_torch.rtm.phase_pair import phase_pair
from er3t_tpu_torch.rtm.scene import build_scene
from er3t_tpu_torch.util import trace

torch.set_num_threads(2)
OUTPUTS = Path(__file__).parent / 'data' / 'flight_step_outputs.npz'
B = 512
STEPS = 4
BASE = dict(batch=B, n_scat_max=300, tile_size=4, qmc_launch=True)
CASES = {
    'radiance_mie_rad_w': dict(target='radiance'),
    'flux_kx4_flux_w': dict(target='flux', flux_per_column=True,
                            flux_kcross=4),
    'heating_rate': dict(target='flux', flux_per_column=False),
    'camera_air_pathlength': dict(
        target='radiance', sensor_type='camera', cam_zloc=8000.0,
        cam_the=180.0, cam_qmax=60.0, cam_npix=8, cam_apsize=50.0,
        pathlength=True),
    'phase_ablation': dict(target='radiance', ablate='phase'),
}
SAVED = ('x', 'y', 'z', 'ux', 'uy', 'uz', 'wsc', 'labs', 'tau', 'nscat',
         'alive', 'ix0', 'iy0', 'plen', 'direct', 'launched', 'rad',
         'rad_pl', 'flux', 'absorbed')


_SCENE = {}


def scene():
    """A 12 x 12 broken-cloud scene with Mie phase tables (TMS rows), two
    g-points, and its radiance and flux factors."""
    if not _SCENE:
        atm = atm_atmmod(np.array([0.0, 0.5, 1.0, 1.5, 3.0, 6.0, 10.0,
                                   20.0]))
        ab = abs_synthetic(650.0, atm, ng=2)
        cld = cld_gen_hem(nx=12, ny=12, nz=2, dx=0.2, dy=0.2, dz=0.5,
                          cloud_frac_tgt=0.3, radii=(0.3,), cot_scale=12.0,
                          cloud_base=0.5, seed=3)
        sc, st = build_scene(atm, ab, cld=cld, pha=pha_mie_wc(650.0),
                             surface=0.05, solar_zenith_angle=30.0,
                             solar_azimuth_angle=45.0, forward_trunc_deg=20.0,
                             device='cpu')
        _SCENE.update(
            scene=sc, st=st, ab=ab,
            rad_w=spectral_factors(ab, nz_out=1)[0][0],
            flux_w=spectral_factors(ab, nz_out=st.nz + 1)[0])
    return _SCENE


def kernel(case, n_photon=1500):
    s = scene()
    kw = CASES[case]
    cfg = SolverConfig(**BASE, **kw)
    extra = {}
    if kw['target'] == 'radiance' and kw.get('sensor_type') != 'camera':
        extra['rad_w'] = s['rad_w']
    if kw.get('flux_kcross'):
        extra['flux_w'] = s['flux_w']
    kern = mc_flight.FlightKernel(s['scene'], s['st'], cfg, n_photon, **extra)
    kern.outcome = torch.zeros(len(mc_flight.OUTCOMES), dtype=torch.int64)
    return kern


def deviates(case):
    rng = np.random.default_rng(sorted(CASES).index(case) + 11)
    return [torch.from_numpy(rng.uniform(1e-7, 1 - 1e-7, (14, B))
                             .astype(np.float32)) for _ in range(STEPS)]


def halves(kern, c, u, q_off):
    """One step as the two halves and K1 between them."""
    k1, mid = kern._step_pre(c, u, q_off)
    pair = k1 if 'phase' in kern.ablate else phase_pair(*k1)
    return kern._step_post(mid, *pair)


def run(case, way):
    """STEPS steps of ``case`` from the all-dead carry, each by ``way``
    ('step': FlightKernel.step, 'halves': :func:`halves`); the saved
    fields of the last carry and the outcome counts."""
    kern = kernel(case)
    c = kern.carry0(B)
    for u in deviates(case):
        c = (kern.step(c, u, 7) if way == 'step'
             else halves(kern, c, u, 7))
    out = {f: getattr(c, f).numpy() for f in SAVED}
    out['outcome'] = kern.outcome.numpy()
    out['step'] = np.array(c.step)
    return out


def write_outputs(path=OUTPUTS):
    """Write every case's outputs of FlightKernel.step to ``path``."""
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **{f'{case}/{k}': v for case in CASES
                                 for k, v in run(case, 'step').items()})


@pytest.mark.parametrize('way', ['halves', 'step'])
@pytest.mark.parametrize('case', list(CASES))
def test_halves_equal_the_uncut_step_bit_for_bit(case, way):
    saved = np.load(OUTPUTS)
    got = run(case, way)
    assert int(got['step']) == STEPS
    for k, v in got.items():
        ref = saved[f'{case}/{k}']
        assert v.dtype == ref.dtype and v.shape == ref.shape, k
        np.testing.assert_array_equal(v, ref, err_msg=f'{case} {k}')
    assert got['outcome'].sum() > 0 and got['launched'] > 0


# ---------------------------------------------------------------------------
# the replay's bookkeeping, with the capture replaced by a stand-in


class RerunGraph:
    """Stand-in for a captured graph: ``replay`` runs the recorded half
    again and writes each tensor it returns where the first run's result
    lies, as a replayed graph writes its outputs at fixed addresses."""

    def __init__(self, fn, out):
        self.fn, self.out = fn, out

    def replay(self):
        for old, new in zip(tree_flatten(self.out)[0],
                            tree_flatten(self.fn())[0]):
            if isinstance(old, torch.Tensor) and old is not new:
                old.copy_(new)


def rerun_capture(graphs, fn):
    """A capture records and does not run: the stand-in runs ``fn`` once for
    the results' places, then restores every tensor that the half writes
    (the static lanes, the tallies and the outcome counts)."""
    kern = graphs.kern
    held = [t for t in (*graphs.lanes.values(), *graphs.tallies,
                        kern.outcome) if t is not None]
    saved = [t.clone() for t in held]
    out = fn()
    for t, s in zip(held, saved):
        t.copy_(s)
    return RerunGraph(fn, out), out


@pytest.fixture
def replaying(monkeypatch):
    """Every FlightKernel.step of transport_flight replays, through the
    stand-in capture."""
    step = mc_flight.FlightKernel.step

    def replayed_step(kern, c, *a, **kw):
        if kern.graphs is None:
            kern.graphs = {}
        return step(kern, c, *a, **kw)

    monkeypatch.setattr(mc_flight.FlightKernel, 'step', replayed_step)
    monkeypatch.setattr(mc_flight._StepGraphs, '_capture', rerun_capture)


FLIGHTS = {
    'radiance_mie_rad_w': {},
    'flux_kx4_flux_w': {},
    'heating_rate': {},
    'camera_air_pathlength': {},
    'phase_ablation': {},
    'camera_importance': dict(target='radiance', sensor_type='camera',
                              cam_npix=8, cam_importance_sigma=500.0),
    'split_rr_value': dict(target='radiance', split_wmax=0.5, rr_value=0.1),
    'sort_every': dict(target='radiance', sort_every=3),
}


def flight(case, stats, photons=6000, batch=2048):
    """One transport_flight of ``case`` (drains 2048 -> 256 lanes)."""
    s = scene()
    kw = dict(BASE, **(FLIGHTS[case] or CASES[case]), batch=batch)
    extra = {}
    if kw['target'] == 'radiance' and kw.get('sensor_type') != 'camera':
        extra['rad_w'] = s['rad_w']
    if kw.get('flux_kcross'):
        extra['flux_w'] = s['flux_w']
    gen = torch.Generator()
    gen.manual_seed(5)
    return mc_flight.transport_flight(s['scene'], s['st'], SolverConfig(**kw),
                                      photons, gen, stats=stats, **extra)


FLIGHT_OUTPUTS = Path(__file__).parent / 'data' / 'flight_outputs.npz'
TALLIES = ('rad', 'flux', 'n_launched', 'n_steps', 'rad_plen', 'lane_iters',
           'absorbed')


def traced_flight(case):
    """:func:`flight` of ``case``, traced: its tallies, and its ``stats``,
    ``flight.*`` counters and span counts as one JSON text."""
    stats = {}
    scene()             # built, with its Mie tables, outside the trace
    trace.reset()
    trace.enable()
    try:
        tal = flight(case, stats)
        rep = trace.report()
    finally:
        trace.enable(False)
        trace.reset()
    out = {f: getattr(tal, f).numpy() for f in TALLIES}
    out['record'] = np.array(json.dumps(dict(
        stats=stats, counters=rep['counters'],
        spans={k: v['count'] for k, v in rep['spans'].items()}),
        sort_keys=True))
    return out


def write_flights(path=FLIGHT_OUTPUTS):
    """Write every flight case's outputs of :func:`traced_flight` to
    ``path``."""
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **{f'{case}/{k}': v for case in FLIGHTS
                                 for k, v in traced_flight(case).items()})


@pytest.mark.parametrize('case', list(FLIGHTS))
def test_flight_equals_the_pinned_flight(case):
    """A whole flight (its deviates drawn by transport_flight, the drain
    stages, the lane sort, the splitting and camera-importance substreams)
    gives the tallies, ``stats``, counters and span counts bit for bit as
    ``tests/data/flight_outputs.npz`` holds them."""
    saved = np.load(FLIGHT_OUTPUTS)
    got = traced_flight(case)
    rec = json.loads(str(got.pop('record')))
    assert rec == json.loads(str(saved[f'{case}/record']))
    for k, v in got.items():
        ref = saved[f'{case}/{k}']
        assert v.dtype == ref.dtype and v.shape == ref.shape, k
        np.testing.assert_array_equal(v, ref, err_msg=f'{case} {k}')
    assert rec['stats']['stage_steps'] and got['n_launched'] > 0


def same_flight(a, b):
    for f in TALLIES:
        np.testing.assert_array_equal(getattr(a, f).numpy(),
                                      getattr(b, f).numpy(), err_msg=f)


@pytest.mark.parametrize('case', list(FLIGHTS))
def test_replayed_flight_equals_the_eager_flight(case, request):
    eager_stats, stats = {}, {}
    trace.reset()
    trace.enable()
    try:
        eager = flight(case, eager_stats)
        counters = trace.report()['counters']
        assert eager_stats['graph_steps'] == 0
        for k in ('captures', 'replays', 'eager_steps'):
            assert counters[f'flight.graph.{k}'] == 0
        trace.reset()
        request.getfixturevalue('replaying')
        got = flight(case, stats)
        rep = trace.report()
    finally:
        trace.enable(False)
        trace.reset()
    same_flight(got, eager)
    assert stats['stage_steps'] == eager_stats['stage_steps']
    assert stats['iter_outcome'] == eager_stats['iter_outcome']
    widths = len(stats['stage_steps'])
    assert all(n >= 2 for n in stats['stage_steps'])
    assert stats['graph_steps'] == sum(stats['stage_steps']) - widths
    ctr = rep['counters']
    assert ctr['flight.graph.eager_steps'] == widths
    assert ctr['flight.graph.replays'] == stats['graph_steps']
    assert ctr['flight.graph.captures'] == 2 * widths
    assert rep['spans']['flight.graph.capture']['count'] == 2 * widths


def test_replay_recaptures_for_new_tallies_and_copies_in_new_lanes(
        replaying):
    """Driven by hand: a carry that is not the graphs' own lanes is copied
    in; tallies at another address are captured anew; both give the eager
    step's result bit for bit."""
    kern = kernel('flux_kx4_flux_w')
    ref = kernel('flux_kx4_flux_w')
    kern.graphs = {}
    us = deviates('flux_kx4_flux_w')
    c, r = kern.carry0(B), ref.carry0(B)
    for k, u in enumerate(us):
        if k == 2:
            # new tallies (a new flight's) and lanes from outside
            c = mc_flight._take_lanes(c, torch.arange(B))._replace(
                flux=c.flux.clone(), rad=c.rad.clone())
        c, r = kern.step(c, u.clone(), 7), ref.step(r, u, 7)
        if k >= 1:
            assert all(getattr(c, f) is kern.graphs[B].lanes[f]
                       for f in kern.graphs[B].lanes)
    assert kern.graph_stats == {'captures': 4, 'replays': 3,
                                'eager_steps': 1}
    for f in SAVED:
        np.testing.assert_array_equal(getattr(c, f).numpy(),
                                      getattr(r, f).numpy(), err_msg=f)
    np.testing.assert_array_equal(kern.outcome.numpy(), ref.outcome.numpy())


def test_cpu_flights_do_not_replay():
    """transport_flight turns replay on only for a scene on the card."""
    stats = {}
    trace.reset()
    trace.enable()
    try:
        flight('radiance_mie_rad_w', stats, photons=1500)
        ctr = trace.report()['counters']
    finally:
        trace.enable(False)
        trace.reset()
    assert stats['graph_steps'] == 0
    assert {k: ctr[k] for k in ctr if k.startswith('flight.graph.')} == {
        'flight.graph.captures': 0, 'flight.graph.replays': 0,
        'flight.graph.eager_steps': 0}


if __name__ == '__main__' and sys.argv[1:] == ['--write']:
    write_outputs()
if __name__ == '__main__' and sys.argv[1:] == ['--write-flights']:
    write_flights()

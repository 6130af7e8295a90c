"""The configuration ``oco2_o2a768`` (its file, inputs module and plain
reference), its cell ``oco2_o2a.rad1e6`` and the per-g cell
``rad_les.per_g``: found by name, as the configuration states them; the
readers of ``surface.lost_pct`` and ``flight.tile_clamp_pct`` on made-up
flights; a small run of the ocean cell correct on the CPU; and the bfloat16
control failing the ocean cell's check."""

import copy
import json
import time
import types

import pytest
import torch

from benchmark.lib import harness, manifest
from benchmark.reference import oco2_o2a768 as ocean_ref

from conftest import ROOT

CELLS = ('oco2_o2a.rad1e6', 'rad_les.per_g')


def _man():
    return json.loads((ROOT / 'BENCHMARK.json').read_text())


def _tiny_ocean():
    """The ocean cell at a CPU size: 24 x 24 columns, five clouds, the HG
    phase function, tile size 8, 2e4 photons a request."""
    cell = copy.deepcopy(manifest.load_cell(ROOT, 'oco2_o2a.rad1e6'))
    cell.config['cloud'].update(nx=24, ny=24)
    cell.config['cloud']['map'].update(disks=5)
    cell.config['mie'] = None
    cell.config['solve']['tile_size'] = 8
    cell.config['photons'] = 20000
    cell.traffic.update(warmup_photons=256, profile_start=2, profile_steps=4)
    cell.check.update(reference_photons=80000, reference_lanes=1 << 14)
    cell.check['limits']['rad.strip_z_rms'] = 2.0
    return cell


def test_the_manifest_gains_one_configuration_two_cells_two_metrics():
    m = _man()
    cfg = {c['name']: c for c in m['configs']}['oco2_o2a768']
    assert cfg['reduced'] == ['photons', 'n_run']
    assert cfg['file'] == 'benchmark/configs/oco2_o2a768.json'
    wl = {w['name']: w for w in m['workloads']}
    assert (wl['oco2_o2a.rad1e6']['config'], wl['oco2_o2a.rad1e6']['traffic']
            ) == ('oco2_o2a768', 'oco2_closed')
    assert (wl['rad_les.per_g']['config'], wl['rad_les.per_g']['traffic']
            ) == ('les_rad650', 'rad_perg_closed')
    assert all(wl[c]['chips'] == 1 for c in CELLS)
    pl = {p['name']: p for p in m['per_layer']}
    for name in ('surface.lost_pct', 'flight.tile_clamp_pct'):
        assert pl[name]['workloads'] == ['oco2_o2a.rad1e6']
        assert (pl[name]['unit'], pl[name]['source'], pl[name]['moves']) \
            == ('%', 'program_counter', 'photons_per_s')
    for c in CELLS:
        cell = manifest.load_cell(ROOT, c)
        assert {'photons_per_s', 's_to_5pct', 'setup_s'} == {
            e['name'] for e in cell.end_to_end}
        assert cell.per_layer


def test_the_configuration_states_its_deployment():
    cfg = json.loads((ROOT / 'benchmark' / 'configs'
                      / 'oco2_o2a768.json').read_text())
    assert (cfg['inputs'], cfg['reference']) == ('oco2_o2a768',) * 2
    c = cfg['cloud']
    assert (c['nx'], c['ny'], c['dx'], c['dy'], c['dz']) \
        == (430, 442, 0.25, 0.25, 0.5)
    assert (c['cer_um'], c['cth_km'], c['cgt_km']) == (12.0, 2.5, 1.0)
    assert c['map']['disks'] == round(10 * 430 * 442 / 64 ** 2) == 464
    assert len(cfg['levels_km']) == 24 and cfg['ng'] == 16
    assert cfg['wavelength_nm'] == cfg['mie']['wavelength'] == 768.5
    assert cfg['surface'] == {'generator': 'sfc_ocean', 'wvl': 768.5,
                              'u10': 5.0}
    assert cfg['solve'] == {
        'solver': '3d', 'solar_zenith_angle': 30.0,
        'solar_azimuth_angle': 45.0, 'sensor_zenith_angle': 0.0,
        'forward_trunc_deg': 20.0, 'tile_size': 16}
    assert set(cfg['reduced']) == {'photons', 'n_run'}
    assert cfg['source_values'] == {'photons': 100000000, 'n_run': 3}
    assert {'cloud', 'absorption', 'surface', 'geometry'} <= set(
        cfg['assumed'])


def test_the_configuration_finds_its_inputs_and_reference():
    cfg = json.loads((ROOT / 'benchmark' / 'configs'
                      / 'oco2_o2a768.json').read_text())
    ref = manifest.reference_module(ROOT, cfg)
    assert all(callable(getattr(ref, f)) for f in ('optics', 'run',
                                                   'reduce'))
    inp = manifest.inputs_builder(ROOT, cfg)(cfg)
    assert inp.cld.extinction.shape == (430, 442, 5)
    assert inp.solve_objects['surface'].jsfc.tolist() == [[2]]
    assert inp.abs_coef.ng == 16 and inp.mie == {'wavelength': 768.5}


def test_the_cells_check_what_they_say():
    ocean = manifest.load_cell(ROOT, 'oco2_o2a.rad1e6')
    assert set(ocean.check['limits']) == {
        'photons_missing', 'photons_cut_ppm', 'rad.strip_z_rms',
        'rad.mean_z'}
    per_g = manifest.load_cell(ROOT, 'rad_les.per_g')
    run1 = manifest.load_cell(ROOT, 'rad_les.run1e6')
    assert set(per_g.check['limits']) == set(run1.check['limits']) | {
        'rad.mean_z'}
    assert per_g.check['fields'] == run1.check['fields']
    assert per_g.traffic['solve'] == {'target': 'radiance',
                                      'spectral': 'independent'}
    assert (ocean.traffic['request_seed'], per_g.traffic['request_seed']) \
        == (1000039, 1000037)
    for c in (ocean, per_g):
        assert (c.traffic['warmup_photons'], c.traffic['profile_start'],
                c.traffic['profile_steps']) == (2048, 40, 100)


def _run(*stats):
    return types.SimpleNamespace(requests=[types.SimpleNamespace(
        flights=[{'stats': s} for s in stats])])


def test_readers_of_the_new_counters():
    lost = manifest.metric_reader(ROOT, 'surface.lost_pct')
    clamp = manifest.metric_reader(ROOT, 'flight.tile_clamp_pct')
    a = {'sfc_branch': {'specular': 90, 'whitecap': 5, 'lost': 5},
         'tile_stops': {'active': 1000, 'clamped': 150}}
    b = {'sfc_branch': {'specular': 96, 'whitecap': 1, 'lost': 3},
         'tile_stops': {'active': 3000, 'clamped': 250}}
    assert lost(_run(a, b)) == 4.0
    assert clamp(_run(a, b)) == 10.0
    # nothing from a program (or a flight) without the counts
    assert lost(_run(a, {})) is None and clamp(_run({}, b)) is None
    zero = {'sfc_branch': {'specular': 0, 'whitecap': 0, 'lost': 0},
            'tile_stops': {'active': 0, 'clamped': 0}}
    assert lost(_run(zero)) is None and clamp(_run(zero)) is None


def test_the_ocean_cell_runs_correct_on_the_cpu():
    out = harness.run_cell(_tiny_ocean(), 2 ** 31 + 4321, 0.5, False, 'cpu',
                           time.perf_counter())
    assert out['correct'], out['checks']
    assert list(out)[-1] == 'checks'


def test_the_ocean_reference_seeds_and_refuses_other_targets():
    cell = _tiny_ocean()
    inp = manifest.inputs_builder(ROOT, cell.config)(cell.config)
    o = ocean_ref.optics(inp, 'cpu')
    a, n = ocean_ref.run(o, 3000, 9, n_tallies=2, batch=1024)
    b, _ = ocean_ref.run(o, 3000, 9, n_tallies=2, batch=1024)
    assert n == [1500, 1500] and torch.equal(a, b)
    with pytest.raises(ValueError, match='radiance only'):
        ocean_ref.run(o, 10, 1, target='flux')


def test_bfloat16_control_fails_the_ocean_check():
    """The reference in bfloat16 in the program's place, on the cell's
    430 x 442 grid at a test budget (HG phase function), fails the cell's
    limits against the float32 reference, and float32 against float32
    passes them."""
    cell = copy.deepcopy(manifest.load_cell(ROOT, 'oco2_o2a.rad1e6'))
    cell.config['mie'] = None
    inp = manifest.inputs_builder(ROOT, cell.config)(cell.config)
    prep = harness.Prep(cell=cell, inputs=inp, kw={'device': 'cpu'},
                        n_asked=25000, target='radiance', solver=None,
                        flight=None)
    cell.check.update(reference_photons=100000, reference_lanes=1 << 16)
    ref, n_b = harness.reference(prep, 5)
    ctl, _ = harness.reference(prep, 12, dtype=torch.bfloat16,
                               n_photons=100000, batches=4)
    ok, rows = harness.judge(prep, ctl, 100000, 0, 0, ref, n_b)
    assert not ok, rows
    again, _ = harness.reference(prep, 13, n_photons=100000, batches=4)
    assert harness.judge(prep, again, 100000, 0, 0, ref, n_b)[0]


def test_a_per_g_weight_fault_fails_the_per_g_check(tiny):
    """The per-g cell at a CPU size, with the pass of g-point 8 normalised
    by the photons of pass 9 (its tally scaled by their ratio, the photon
    counts right, so the image is ~20 % brighter): ``rad.mean_z`` exceeds
    its limit."""
    from benchmark.lib.trace import Shims
    cell = tiny('rad_les.per_g')
    prep = harness.prepare(cell, 'cpu')
    sv = prep.solver
    dist = sv.distribute_photon(prep.n_asked, prep.inputs.abs_coef.weight)
    orig = sv._single_run

    def faulty(scene, static, cfg, n_photon, *a, **kw):
        out = orig(scene, static, cfg, n_photon, *a, **kw)
        if int(n_photon) == int(dist[8]):
            out = (out[0] * (dist[8] / dist[9]),) + tuple(out[1:])
        return out
    sv._single_run = faulty
    try:
        with Shims(prep.solver, prep.flight) as shims:
            reqs, _ = harness.window(prep, shims, n_requests=2)
    finally:
        sv._single_run = orig
    ref, n_b = harness.reference(prep, 11)
    ok, rows = harness.judge_requests(prep, reqs, ref, n_b)
    mean = {k: (v, lim) for k, v, lim in rows}['rad.mean_z']
    assert not ok and mean[0] > mean[1], rows

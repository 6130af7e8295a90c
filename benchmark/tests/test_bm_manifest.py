"""BENCHMARK.json keeps to the benchmark's contract, and the harness finds
each cell's files, each metric's reader and each configuration's inputs
builder and plain reference by name; a new cell or configuration is new
files and manifest entries, with no file edited."""

import hashlib
import json
import re
import shutil
from pathlib import Path

import pytest

from benchmark.lib import manifest

from conftest import ROOT

NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
SOURCES = {'device_trace', 'program_span', 'program_counter', 'host_clock'}


def _man():
    return json.loads((ROOT / 'BENCHMARK.json').read_text())


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and '\n' not in s \
        and '\t' not in s


def test_manifest_keys_and_names():
    m = _man()
    assert set(m) == {'command', 'paths', 'run_seconds', 'configs',
                      'workloads', 'end_to_end', 'per_layer'}
    assert m['command'] == ['python3', 'benchmark/run.py']
    assert m['paths'] == ['benchmark']
    assert isinstance(m['run_seconds'], int) and 1 <= m['run_seconds'] <= 51
    assert len((ROOT / 'BENCHMARK.json').read_bytes()) <= 64 * 1024
    for c in m['configs']:
        assert set(c) == {'name', 'source', 'file', 'reduced', 'why'}
        assert NAME.match(c['name']) and _line(c['source']) and _line(c['why'])
        assert c['file'].startswith('benchmark/')
        assert (ROOT / c['file']).is_file()
        assert len(c['reduced']) <= 16
        assert all(NAME.match(k) for k in c['reduced'])
        cfg = json.loads((ROOT / c['file']).read_text())
        assert all(k in cfg for k in c['reduced'])
    assert len({c['file'] for c in m['configs']}) == len(m['configs'])
    cfgs = {c['name'] for c in m['configs']}
    pairs = set()
    for w in m['workloads']:
        assert set(w) == {'name', 'config', 'traffic', 'chips', 'why'}
        assert NAME.match(w['name']) and NAME.match(w['traffic'])
        assert w['config'] in cfgs and w['chips'] in (1, 4) and _line(w['why'])
        pairs.add((w['config'], w['traffic']))
    assert len(pairs) == len(m['workloads'])
    assert cfgs == {w['config'] for w in m['workloads']}
    names = [x['name'] for x in m['configs']] + \
        [x['name'] for x in m['workloads']] + \
        [x['name'] for x in m['end_to_end'] + m['per_layer']]
    assert len(names) == len(set(names))
    for e in m['end_to_end']:
        assert set(e) - {'workloads'} == {'name', 'unit', 'better', 'bound',
                                          'source'}
        assert e['source'] in ('host_clock', 'device_trace')
        assert 0.01 <= e['bound'] <= 0.25
    assert 'setup_s' in {e['name'] for e in m['end_to_end']}
    layers = {}
    for p in m['per_layer']:
        assert set(p) - {'workloads'} == {'name', 'unit', 'better', 'source',
                                          'layer', 'moves'}
        assert p['source'] in SOURCES and _line(p['layer'])
        assert p['moves'] in {e['name'] for e in m['end_to_end']}
        layers.setdefault(p['layer'], []).append(p['name'])
    for x in m['end_to_end'] + m['per_layer']:
        assert NAME.match(x['name']) and UNIT.match(x['unit'])
        assert x['better'] in ('lower', 'higher')
        for w in x.get('workloads', []):
            assert w in {w['name'] for w in m['workloads']}


def test_check_budget_fits_with_24_cells():
    """2 + 14 runs a cell, each run_seconds + 60, 2 x 90 s of compile a
    cell and 1200 s spare, within 43200 s at the full 24 cells."""
    rs = _man()['run_seconds']
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    m = _man()
    for w in m['workloads']:
        e2e = {e['name'] for e in m['end_to_end']
               if w['name'] in e.get('workloads', [w['name']])}
        pl = [p for p in m['per_layer']
              if w['name'] in p.get('workloads', [w['name']])]
        assert 'setup_s' in e2e and len(e2e) >= 2 and pl
        assert all(p['moves'] in e2e for p in pl)


@pytest.mark.parametrize('workload',
                         [w['name'] for w in _man()['workloads']])
def test_load_cell_finds_every_file_by_name(workload):
    cell = manifest.load_cell(ROOT, workload)
    assert cell.config['name'] in {c['name'] for c in _man()['configs']}
    assert cell.traffic['solve']['target'] in ('radiance', 'flux',
                                               'heating_rate')
    assert set(cell.check['limits']) >= {'photons_missing'}
    assert {f['name'] for f in cell.check['fields']} >= {
        cell.check['noise_field']}
    for m in cell.end_to_end + cell.per_layer:
        assert callable(manifest.metric_reader(ROOT, m['name']))


def _digest(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(Path(root).rglob('*'))
            if p.is_file() and '__pycache__' not in p.parts}


def test_without_the_keys_a_configuration_takes_the_default_modules():
    from benchmark.lib import inputs
    from benchmark.reference import mc
    for c in _man()['configs']:
        cfg = json.loads((ROOT / c['file']).read_text())
        assert manifest.inputs_builder(ROOT, cfg) is inputs.make_inputs
        assert manifest.reference_module(ROOT, cfg) is mc


# a configuration's own inputs builder and plain reference, as a later
# change would add them: a clear sky over a brighter surface object, and
# the default reference fed that surface, which reports what it was given
_INPUTS = """import dataclasses

from benchmark.lib.inputs import make_inputs as _default


def make_inputs(config):
    return dataclasses.replace(_default(config), cld=None,
                               solve_objects={'surface': 0.5})
"""
_REFERENCE = """import dataclasses

import numpy as np

from . import mc

run = mc.run


def optics(inputs, device, dtype):
    kw = dict(inputs.solve_kw, **inputs.solve_objects)
    return mc.optics(dataclasses.replace(inputs, solve_kw=kw,
                                         solve_objects={}), device, dtype)


def reduce(o, img, n_launched, abs_coef, target):
    red = mc.reduce(o, img, n_launched, abs_coef, target)
    red['albedo_seen'] = np.full(red['f_up'].shape, o.albedo)
    return red
"""


def test_a_new_cell_is_new_files_and_an_entry(tmp_path):
    """In a copy: a throwaway traffic mix, its cell file, a metric reader
    and a configuration with its own inputs builder and plain reference
    are found by name once the manifest names them, and the configuration
    runs through ``prepare`` and ``reference`` on the CPU; no file that was
    there changes."""
    from benchmark.lib import harness

    from conftest import tiny_cell
    shutil.copytree(ROOT / 'benchmark', tmp_path / 'benchmark',
                    ignore=shutil.ignore_patterns('__pycache__'))
    shutil.copy(ROOT / 'BENCHMARK.json', tmp_path / 'BENCHMARK.json')
    before = _digest(tmp_path / 'benchmark')
    bench = tmp_path / 'benchmark'
    (bench / 'traffic' / 'rad_lut.json').write_text(json.dumps(
        {'solve': {'target': 'radiance', 'photons': 2e5, 'n_run': 3},
         'warmup_photons': 2048, 'profile_start': 40, 'profile_steps': 100,
         'request_seed': 11}))
    (bench / 'cells' / 'rad_les.lut2e5x3.json').write_text(
        (bench / 'cells' / 'rad_les.run1e6.json').read_text())
    (bench / 'metrics' / 'step.count.py').write_text(
        'def read(run):\n    return 42.0\n')
    cfg = json.loads((bench / 'configs' / 'les_flux650.json').read_text())
    cfg.update(name='clear_bright', inputs='clear_bright',
               reference='clear_bright')
    (bench / 'configs' / 'clear_bright.json').write_text(json.dumps(cfg))
    (bench / 'inputs' / 'clear_bright.py').write_text(_INPUTS)
    (bench / 'reference' / 'clear_bright.py').write_text(_REFERENCE)
    check = json.loads(
        (bench / 'cells' / 'flux_les.hr1e6.json').read_text())
    check['fields'].append({'name': 'albedo', 'key': 'albedo_seen',
                            'level': 0, 'domain': True})
    (bench / 'cells' / 'clear_bright.hr1e6.json').write_text(
        json.dumps(check))
    m = json.loads((tmp_path / 'BENCHMARK.json').read_text())
    m['configs'].append({'name': 'clear_bright', 'source': 'x',
                         'file': 'benchmark/configs/clear_bright.json',
                         'reduced': [], 'why': 'x'})
    m['workloads'].append({'name': 'rad_les.lut2e5x3', 'config': 'les_rad650',
                           'traffic': 'rad_lut', 'chips': 1, 'why': 'LUT'})
    m['workloads'].append({'name': 'clear_bright.hr1e6',
                           'config': 'clear_bright', 'traffic': 'hr_closed',
                           'chips': 1, 'why': 'own inputs and reference'})
    m['per_layer'].append({'name': 'step.count', 'unit': 'steps',
                           'better': 'lower', 'source': 'program_counter',
                           'layer': 'x', 'moves': 'photons_per_s',
                           'workloads': ['rad_les.lut2e5x3']})
    (tmp_path / 'BENCHMARK.json').write_text(json.dumps(m))
    cell = manifest.load_cell(tmp_path, 'rad_les.lut2e5x3')
    assert cell.traffic['solve']['n_run'] == 3
    assert [p['name'] for p in cell.per_layer] == ['step.count']
    assert manifest.metric_reader(tmp_path, 'step.count')(None) == 42.0

    cell = tiny_cell('clear_bright.hr1e6', tmp_path)
    assert cell.config['inputs'] == 'clear_bright'
    prep = harness.prepare(cell, 'cpu')
    assert prep.inputs.cld is None and prep.kw['surface'] == 0.5
    ref, n_b = harness.reference(prep, 3, n_photons=4000, batches=2)
    assert n_b == 2000
    assert [a.shape for a in ref['albedo']] == [(1, 1)] * 2
    assert [float(a[0, 0]) for a in ref['albedo']] == [0.5, 0.5]
    assert ref['hr'][0].shape == (len(cell.config['levels_km']) - 1,)
    after = _digest(bench)
    assert {k: v for k, v in after.items() if k in before} == before

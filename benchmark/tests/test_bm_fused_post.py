"""``flight.fused_post_pct`` on made-up records: the share of the window's
flight steps whose second half ran as one kernel, and nothing where the
program does not count them; its entry in BENCHMARK.json."""

import json
import types

import pytest

from benchmark.lib import manifest

from conftest import ROOT

CELLS = ['rad_les.run1e6', 'flux_les.run1e6', 'flux_les.hr1e6',
         'oco2_o2a.rad1e6', 'rad_les.per_g']


def _run(*stats):
    flights = [{'stats': s} for s in stats]
    return types.SimpleNamespace(requests=[
        types.SimpleNamespace(flights=flights[:1]),
        types.SimpleNamespace(flights=flights[1:])])


def test_fused_post_pct_of_made_up_flights():
    read = manifest.metric_reader(ROOT, 'flight.fused_post_pct')
    a = {'stage_steps': [300, 900, 500], 'fused_post_steps': 1700}
    b = {'stage_steps': [280, 1000], 'fused_post_steps': 1000}
    assert read(_run(a, b)) == pytest.approx(
        100.0 * (1700 + 1000) / (1700 + 1280), rel=1e-12)
    assert read(_run({'stage_steps': [10], 'fused_post_steps': 0})) == 0.0


def test_fused_post_pct_is_nothing_without_the_count():
    read = manifest.metric_reader(ROOT, 'flight.fused_post_pct')
    a = {'stage_steps': [300, 900, 500], 'fused_post_steps': 1700}
    assert read(_run({'stage_steps': [300, 900, 500],
                      'graph_steps': 1697})) is None
    assert read(_run(a, {'stage_steps': [280, 1000]})) is None
    assert read(_run()) is None


def test_the_metric_is_appended_to_per_layer():
    m = json.loads((ROOT / 'BENCHMARK.json').read_text())
    names = [p['name'] for p in m['per_layer']]
    assert names.count('flight.fused_post_pct') == 1
    # after every metric that the benchmark had before it
    assert names.index('flight.fused_post_pct') > names.index(
        'flight.tile_clamp_pct')
    entry = m['per_layer'][names.index('flight.fused_post_pct')]
    assert entry == {'name': 'flight.fused_post_pct', 'unit': '%',
                    'better': 'higher', 'source': 'program_counter',
                    'layer': 'rtm/mc_flight.py FlightKernel.step',
                    'moves': 'photons_per_s', 'workloads': CELLS}
    for c in CELLS:
        cell = manifest.load_cell(ROOT, c)
        assert 'flight.fused_post_pct' in [p['name'] for p in cell.per_layer]

"""``flight.graph_step_pct`` on made-up records: the share of the window's
flight steps that the program replayed from captured graphs, and nothing
where the program does not count them."""

import types

import pytest

from benchmark.lib import manifest

from conftest import ROOT


def _run(*stats):
    flights = [{'stats': s} for s in stats]
    return types.SimpleNamespace(requests=[
        types.SimpleNamespace(flights=flights[:1]),
        types.SimpleNamespace(flights=flights[1:])])


def test_graph_step_pct_of_made_up_flights():
    read = manifest.metric_reader(ROOT, 'flight.graph_step_pct')
    a = {'stage_steps': [300, 900, 500], 'graph_steps': 1697}
    b = {'stage_steps': [280, 1000], 'graph_steps': 1278}
    assert read(_run(a, b)) == pytest.approx(
        100.0 * (1697 + 1278) / (1700 + 1280), rel=1e-12)
    assert read(_run({'stage_steps': [10], 'graph_steps': 0})) == 0.0


def test_graph_step_pct_is_nothing_without_the_count():
    read = manifest.metric_reader(ROOT, 'flight.graph_step_pct')
    a = {'stage_steps': [300, 900, 500], 'graph_steps': 1697}
    assert read(_run({'stage_steps': [300, 900, 500]})) is None
    assert read(_run(a, {'stage_steps': [280, 1000]})) is None
    assert read(_run()) is None

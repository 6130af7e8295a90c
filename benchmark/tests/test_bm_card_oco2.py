"""On the card: the cells ``oco2_o2a.rad1e6`` and ``rad_les.per_g`` run
and are correct, and their new per-layer metrics read numbers in a traced
run.  Skips where no CUDA device is visible; on the GPU machine run
``python -m pytest benchmark/tests/test_bm_card_oco2.py``."""

import json
import subprocess
import sys

import pytest

from conftest import ROOT


def _run(workload, trace):
    r = subprocess.run(
        [sys.executable, 'benchmark/run.py', '--workload', workload,
         '--seed', str(2 ** 33 + 9), '--seconds', '1', '--trace', str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.cuda
@pytest.mark.parametrize('workload', ['oco2_o2a.rad1e6', 'rad_les.per_g'])
def test_new_cell_runs_and_is_correct(card, workload):
    out = _run(workload, 0)
    assert out['correct'], out['checks']
    assert out['device']['platform'] == 'gpu'


@pytest.mark.cuda
def test_the_ocean_counters_read_in_a_traced_run(card):
    out = _run('oco2_o2a.rad1e6', 1)
    assert out['correct'], out['checks']
    m = out['metrics']
    assert 0.0 <= m['surface.lost_pct']['value'] < 100.0
    assert 0.0 < m['flight.tile_clamp_pct']['value'] < 100.0

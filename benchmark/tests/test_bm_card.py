"""On the card: each cell runs and is correct, and the bfloat16 control at
the cell's own size is not.  Skips where no CUDA device is visible; on the
GPU machine run ``python -m pytest benchmark/tests/test_bm_card.py``."""

import json
import subprocess
import sys

import pytest

from conftest import ROOT

CELLS = ['rad_les.run1e6', 'flux_les.run1e6', 'flux_les.hr1e6']


@pytest.mark.cuda
@pytest.mark.parametrize('workload', CELLS)
def test_cell_runs_and_is_correct(card, workload):
    r = subprocess.run(
        [sys.executable, 'benchmark/run.py', '--workload', workload,
         '--seed', str(2 ** 33 + 5), '--seconds', '1', '--trace', '0'],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out['correct'], out['checks']
    assert out['device']['platform'] == 'gpu'
    # one request in a 1 s window: no s_to_5pct, which needs two
    assert set(out['metrics']) == {'photons_per_s', 'setup_s'}
    assert r.stderr.strip().splitlines()[-1] == 'correct True'


@pytest.mark.cuda
@pytest.mark.parametrize('workload', CELLS)
def test_bfloat16_control_is_not_correct_at_the_cell_size(card, workload,
                                                          tmp_path):
    out = tmp_path / 'cal.jsonl'
    r = subprocess.run(
        [sys.executable, 'benchmark/calibrate.py', '--workload', workload,
         '--requests', '2', '--control-seeds', '77', '--out', str(out)],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    line = json.loads(out.read_text().splitlines()[-1])
    assert line['kind'] == 'control' and line['correct'] is False

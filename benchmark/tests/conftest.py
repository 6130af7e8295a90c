"""Fixtures of the benchmark's own tests: a cell cut to a size that the
CPU runs in seconds (24 x 24 columns, HG phase function), with limits of
its own."""

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    import torch
    torch.set_num_threads(2)
    config.addinivalue_line(
        'markers', 'cuda: needs an NVIDIA GPU; skips where '
        'torch.cuda.is_available() is False')


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')


def tiny_cell(workload, root=ROOT):
    """The cell ``workload`` of ``<root>/BENCHMARK.json`` at a CPU test
    size: the same atmosphere, gases, sun and settings on 24 x 24 columns,
    the Mie table left out (HG), 2e4 photons a request, a small reference
    and test limits."""
    from benchmark.lib import manifest
    cell = copy.deepcopy(manifest.load_cell(root, workload))
    cell.config['cloud'].update(nx=24, ny=24, radii=[0.5])
    cell.config['mie'] = None
    cell.config['photons'] = 20000
    cell.traffic.update(warmup_photons=256, profile_start=2, profile_steps=4)
    cell.check.update(reference_photons=80000, reference_lanes=1 << 14)
    lim = cell.check['limits']
    for k in lim:
        if k.endswith(('.strip_z_rms', '.profile_z_rms')):
            lim[k] = 2.0
    return cell


@pytest.fixture
def tiny():
    return tiny_cell

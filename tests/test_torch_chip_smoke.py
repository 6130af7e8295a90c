"""A rehearsal of chip_smoke.run on the CPU at a tiny size.

The card queries, the build and the timer are stubbed, and every kernel
wrapper is wrapped so that its plain-version call counts as a launch (on
the CPU a wrapper runs its plain version and counts nothing).  What is
checked is the script's control flow and its output: the contract's last
two lines, every kernel's keys (floor, bound, library time), and the
launch counts of the main path and of the probe path.
"""

import json

import numpy as np
import pytest
import torch

import chip_smoke
from er3t_tpu_torch import _build
from er3t_tpu_torch.pre.abs import abs_synthetic
from er3t_tpu_torch.pre.atm import atm_atmmod
from er3t_tpu_torch.pre.cld import cld_gen_hem
from er3t_tpu_torch.probes import gather, gather_probe
from er3t_tpu_torch.rtm import mc_flight
from er3t_tpu_torch.rtm import phase_pair as pp
from er3t_tpu_torch.rtm.scene import build_scene

torch.set_num_threads(2)

LIMIT = 232448
KEYS = {'name', 'route', 'source', 'replaces', 'launches', 'max_abs_err',
        'ms', 'plain_ms', 'bound_ms', 'bound_by', 'library_ms', 'floor_ms'}
LIBRARY = {'take_reps', 'gather_row_sum', 'take2d', 'smem_stage'}


def _small_scene(device):
    levels = np.concatenate([np.arange(0, 3.0, 0.5), np.arange(3.0, 20.1, 2.0)])
    atm = atm_atmmod(levels)
    ab = abs_synthetic(650.0, atm, ng=4)
    cld = cld_gen_hem(nx=12, ny=12, nz=4, dx=0.1, dy=0.1, dz=0.5,
                      cloud_frac_tgt=0.25, radii=(0.3,), cot_scale=15.0,
                      cloud_base=0.5, seed=7)
    kw = dict(cld=cld, surface=0.03, solar_zenith_angle=30.0,
              solar_azimuth_angle=45.0, forward_trunc_deg=25.0)
    scene, st = build_scene(atm, ab, **kw, device=device)
    return atm, ab, kw, scene, st


def _counting(fn, attr='launches'):
    """``fn`` whose every call adds one to the launch count it would add
    on the card."""
    def shim(*a):
        name = attr
        if fn is pp.phase_pair and a[4].dtype == torch.bfloat16:
            name = 'launches_bf16'
        setattr(fn, name, getattr(fn, name) + 1)
        return fn(*a)
    return shim


@pytest.fixture
def rehearsal(monkeypatch, tmp_path):
    timer = lambda fn, n=100, per_launch=False: (fn(), 1.0)[1]  # noqa: E731
    for mod in (chip_smoke, gather_probe):
        monkeypatch.setattr(mod, 'device_ms', timer)
        monkeypatch.setattr(mod, 'card_line', lambda: 'CPU stub, 0 W')
    monkeypatch.setattr(torch.cuda, 'get_device_name', lambda d=None: 'cpu')
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 1)
    monkeypatch.setattr(torch.cuda, 'synchronize', lambda d=None: None)
    monkeypatch.setattr(torch.cuda, 'get_device_properties', lambda d=None:
                        type('P', (), {'shared_memory_per_block_optin':
                                       LIMIT}))
    monkeypatch.setattr(_build, 'build_all', lambda: {})
    monkeypatch.setattr(_build, 'load', lambda name: None)
    # the reference runs of the bench scene, replaced by a spread that
    # admits the 12x12 scene's means
    wide = ((0.0, 0.0), (100.0, 100.0))
    for name, value in (('BATCH', 1024), ('RAGGED', 1003),
                        ('PHOTONS', 20_000), ('WARM_PHOTONS', 4_000),
                        ('SOLVE_PHOTONS', 4_000), ('FLUX_PHOTONS', 20_000),
                        ('HR_PHOTONS', 10_000), ('FLUX_REF_RUNS', wide),
                        ('REF_RUN_MEANS', tuple(r[0] for r in wide)),
                        ('HR_REF_RUNS', tuple(r[0] for r in wide)),
                        ('OUT_JSON', str(tmp_path / 'chip_smoke.json')),
                        ('build_bench_scene', _small_scene)):
        monkeypatch.setattr(chip_smoke, name, value)
    monkeypatch.setattr(gather_probe, 'B', 1024)
    monkeypatch.setattr(gather_probe, 'K', 2)

    wrappers = {'phase_pair': pp.phase_pair,
                **{f.__name__: f for f in (gather.take_reps,
                                           gather.gather_row_sum,
                                           gather.take2d, gather.smem_stage,
                                           gather.noop)}}
    for fn in wrappers.values():        # the counts come back after the test
        for attr in ('launches', 'launches_bf16'):
            if hasattr(fn, attr):
                monkeypatch.setattr(fn, attr, getattr(fn, attr))
    shims = {name: _counting(fn) for name, fn in wrappers.items()}

    def refusing(tab):
        if tab.numel() * 4 > LIMIT:
            raise _build.CudaError('smem_stage', 1)
        return shims['smem_stage'](tab)
    for mod in (mc_flight, gather_probe, gather):
        for name, shim in shims.items():
            if hasattr(mod, name):
                monkeypatch.setattr(mod, name, shim)
    monkeypatch.setattr(gather_probe, 'smem_stage', refusing)
    return tmp_path


def test_chip_smoke_run_rehearsed_on_cpu(rehearsal, capsys):
    args = type('A', (), {'seed': 0, 'profile': False})()
    assert chip_smoke.run(args, torch.device('cpu')) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == {'ok': True, 'device': {
        'platform': 'gpu', 'kind': 'cpu', 'count': 1}}
    assert lines[-3] == 'CPU stub, 0 W'
    kernels = json.loads(lines[-2])['kernels']
    assert [k['name'] for k in kernels] == ['phase_pair'] + list(
        chip_smoke.PROBE_KERNELS)
    report = json.loads((rehearsal / 'chip_smoke.json').read_text())
    main = report['main']
    assert report['floor_ms'] == 1.0
    assert main['phase_pair_launches'] == main['steps'] > 0
    assert all(n == 0 for k, n in main['launches'].items()
               if k != 'phase_pair')
    flux = report['flux']
    assert flux['phase_pair_launches'] == flux['steps'] > 0
    assert flux['photons'] == 20_000 and flux['toa_direct_max_rel_err'] <= 1e-5
    assert all(n == 0 for k, n in flux['launches'].items()
               if k != 'phase_pair')
    for key in ('f_down_sfc', 'f_up_toa'):
        assert set(flux[key]) == {'value', 'ref', 'tol', 'rel_diff'}
        assert flux[key]['value'] > 0
    hr = report['heating_rate']
    assert len(hr['hr']) == 14 and abs(hr['closure_rel_diff']) <= 0.05
    assert hr['n_photon_effective'] == 20_000
    assert hr['launches']['phase_pair'] > 0
    assert hr['column_absorbed']['value'] > 0
    assert kernels[0]['flux_launches'] == flux['steps']
    for k in kernels:
        assert set(k) == KEYS | ({'flux_launches'} if k['name'] == 'phase_pair'
                                 else set()), k['name']
        assert k['launches'] > 0 and k['max_abs_err'] == 0.0, k['name']
        assert k['floor_ms'] == 1.0 and k['ms'] == k['plain_ms'] == 1.0
        assert k['bound_by'] == 'bytes' and 0 < k['bound_ms'] < 1.0
        assert (k['library_ms'] == 1.0) == (k['name'] in LIBRARY), k['name']
    rows = report['rows']
    assert sorted(rows) == ['K1', 'K2', 'K3', 'K4', 'K5', 'K6', 'K7',
                            'K7_pair']
    assert all(r['bound_ms'] > 0 and r['floor_ms'] == 1.0
               for r in rows.values())
    assert rows['K4']['library_ms'] == rows['K6']['library_ms'] == 1.0
    assert rows['K2']['library_ms'] == 1.0
    ceiling = [(r['bytes'], r['ok']) for r in report['probes']
               if r['probe'] == 'vmem_ceiling']
    assert ceiling[-2:] == [(LIMIT, True), (LIMIT + 4, False)]
    probe_tags = [r['probe'] for r in report['probes']]
    assert probe_tags.count('launch_floor') == 1
    assert probe_tags.count('timing_methods') == 3


def test_bounds_count_the_bytes_this_run_touches():
    """The bound of a gather counts the table elements its indices name,
    each once: 8 B per index (in and out) plus 4 B per distinct element."""
    idx = torch.tensor([3, 3, 5, 0], dtype=torch.int32)
    tab = torch.zeros(10, 2)
    assert chip_smoke.row_sum_cost(idx, tab) == (8 * 4 + 4 * 3 * 2, 8)
    # reps 2: rows {3, 5, 0} of column 0, rows {4, 6, 1} of column 1
    assert chip_smoke.take_reps_cost(idx, tab, 2) == (8 * 4 + 4 * 6, 8)
    a = torch.tensor([0, 1, 1, 1], dtype=torch.int32)
    mu = torch.tensor([-1.0, 1.0, 1.0, 1.0])
    nbytes, ops = chip_smoke.pair_cost(a, a + 2, mu, (mu + 1) / 2,
                                       torch.zeros(4, 5), torch.zeros(2, 7))
    assert (nbytes, ops) == (24 * 4 + 4 * (2 + 2), 24)
    ms, by = chip_smoke.bound((3.35e9, 1.0))
    assert by == 'bytes' and ms == pytest.approx(1.0)
    assert chip_smoke.bound((0, 67e9)) == (pytest.approx(1.0), 'operations')


def test_reference_tolerance_scales_the_runs_spread():
    """max(rel, 4 sigma), sigma the spread of one reference run scaled to
    the checked photons, combined with the reference mean's own error."""
    runs = (1.0, 1.2, 1.1, 0.9)                  # mean 1.05, sd 0.129
    sd = float(np.std(runs, ddof=1))
    r = chip_smoke.against_ref('x', 1.3, runs, 100, 400, 0.01)
    assert r['ref'] == pytest.approx(1.05)
    assert r['tol'] == pytest.approx(4 * np.hypot(sd / 2, sd / 2))
    assert r['rel_diff'] == pytest.approx(1.3 / 1.05 - 1)
    assert chip_smoke.against_ref('x', 1.05, (1.05, 1.05), 1, 1, 0.01)[
        'tol'] == pytest.approx(0.0105)
    with pytest.raises(AssertionError, match='not within'):
        chip_smoke.against_ref('x', 1.5, runs, 100, 400, 0.01)

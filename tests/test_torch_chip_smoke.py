"""A rehearsal of chip_smoke.run on the CPU at a tiny size.

The card queries, the build and the timer are stubbed, and every kernel
wrapper is wrapped so that its plain-version call counts as a launch (on
the CPU a wrapper runs its plain version and counts nothing).  What is
checked is the script's control flow and its output: the contract's last
two lines, every kernel's keys (floor, bound, library time), and the
launch counts of the main path and of the probe path.  Each test runs a
few phases (``chip_smoke.run(..., phases=)``): this file phases 1-7 and
the probes; tests/test_torch_chip_smoke_paths.py phases 8-9,
tests/test_torch_chip_smoke_apps.py phases 10-11,
tests/test_torch_chip_smoke_drivers.py phase 12,
tests/test_torch_chip_smoke_bench.py phase 13 and
tests/test_torch_chip_smoke_sweeps.py phase 14, with the fixture and the
checks of this file, so that the test workers share them.  Phase 8's quasi
renders are held against the JAX package's on the same small scene, and
phase 11's reader and cloud values (the AHI granule gridded to 12 x 12)
against the JAX package's on the same file, exactly.  Phase 12 runs
example 00's cases 01 and 06 at 4000 photons a run and the native bridge
at 80000 photons, each solver held against the others at the reference
test's bounds.
"""

import ast
import inspect
import json
import os

import numpy as np
import pytest
import torch

import chip_smoke
from er3t_tpu_torch import _build
from er3t_tpu_torch.pre.abs import abs_synthetic
from er3t_tpu_torch.pre.atm import atm_atmmod
from er3t_tpu_torch.pre import pha
from er3t_tpu_torch.pre.cld import cld_gen_hem
from er3t_tpu_torch.probes import gather, gather_probe
from er3t_tpu_torch.rtm import domain_tally, flight_post, mc, mc_flight
from er3t_tpu_torch.rtm import phase_pair as pp
from er3t_tpu_torch.rtm.scene import build_scene

import test_torch_fused_post as fused_post_mod
from test_torch_fused_post import host_twin  # noqa: F401  (a fixture)

torch.set_num_threads(2)

LIMIT = 232448
KEYS = {'name', 'route', 'source', 'replaces', 'launches', 'max_abs_err',
        'ms', 'plain_ms', 'bound_ms', 'bound_by', 'library_ms', 'floor_ms'}
LIBRARY = {'take_reps', 'gather_row_sum', 'take2d', 'smem_stage'}
PHASE7 = ('ipa', 'p3d', 'ipa_flux', 'camera', 'camera_air', 'cf_dtau',
          'split_wmax', 'rr_value', 'sort_coherent', 'production')
PHASE8 = ('march_flux', 'march_rad', 'march_hr')
PHASE9 = ('photon', 'decomp', 'flux', 'solve', 'process_group')
PHASE10 = ('les', 'lut', 'curve', 'spectral_flux')
PHASE11 = ('3d', 'ipa')
PHASE12 = ('01', '06')
PHASE13 = ('bench', 'ablate_full', 'ablate_phase', 'ablate_vox',
           'ablate_deposit', 'ablate_floor')
PHASE14 = ('ab_sweep', 'tile2_sweep', 'flux_ab', 'isolate_ab', 'pallas_ab',
           'r3_sweep', 'r5_sweep', 'cam_importance_ab', 'scaling', 'drain')


def _small_scene(device):
    """12 x 12 columns of 1 km, so that phase 9's slabs (two here) are 6 km
    wide (the bench scene's four are 12 km).  Narrow slabs drain slowly in
    both packages: a near-horizontal lane below the deck top (anywhere,
    under per-column flux) clamps at every slab face it crosses and waits
    a superstep for each migration; at 3 km the reference's per-column
    flux run reached its round cap."""
    levels = np.concatenate([np.arange(0, 3.0, 0.5), np.arange(3.0, 20.1, 2.0)])
    atm = atm_atmmod(levels)
    ab = abs_synthetic(650.0, atm, ng=4)
    cld = cld_gen_hem(nx=12, ny=12, nz=4, dx=1.0, dy=1.0, dz=0.5,
                      cloud_frac_tgt=0.25, radii=(3.0,), cot_scale=15.0,
                      cloud_base=0.5, seed=7)
    kw = dict(cld=cld, surface=0.03, solar_zenith_angle=30.0,
              solar_azimuth_angle=45.0, forward_trunc_deg=25.0)
    scene, st = build_scene(atm, ab, **kw, device=device)
    return atm, ab, kw, scene, st


def _quasi_ref(npix, n_steps):
    """chip_smoke.QUASI_REF of the small scene, from the JAX package's
    quasi_radiance on the same scene."""
    import jax.numpy as jnp
    from er3t_tpu.rtm.mc import SolverConfig as JConfig
    from er3t_tpu.rtm.quasi import quasi_radiance
    from er3t_tpu.rtm.scene import SceneArrays
    _, ab, _, scene, st = _small_scene('cpu')
    jscene = SceneArrays(**{f: jnp.asarray(getattr(scene, f).numpy())
                            for f in SceneArrays._fields})
    return {name: chip_smoke.quasi_summary(quasi_radiance(
        jscene, st, JConfig(sensor_type='camera', cam_npix=npix, **cam),
        n_steps), ab.weight) for name, cam in chip_smoke.QUASI_CAMERAS.items()}


def _sat_exact(fname, nx):
    """chip_smoke.SAT_EXACT of the granule gridded to nx x nx, from the JAX
    package's reader and cld_sat on the same file."""
    import chip_smoke_files
    from er3t_tpu.pre.cld import cld_sat
    from er3t_tpu.sat.ahi import ahi_l2
    chip_smoke_files.write_ahi_clp(fname, seed=0)
    obj = ahi_l2([fname], extent=chip_smoke_files.AHI_EXTENT, nx=nx, ny=nx)
    cot = obj.data['cot_2d']['data']
    cld = cld_sat(cot_2d=cot, cer_2d=np.where(cot > 0, obj.data['cer_2d'][
        'data'], 0.0), dx=0.5, dy=0.5, cth=2.0, cgt=1.0, dz=0.5)
    return (float(cot.sum()), float((cot > 0).mean()),
            float(cld.extinction.sum()))


class _Counting:
    """``fn`` whose every call adds one to the launch count it would add
    on the card; its attributes (the counts) are ``fn``'s, so that code
    holding the shim reads and resets them as it would on the card."""

    def __init__(self, fn):
        object.__setattr__(self, 'fn', fn)

    def __call__(self, *a, **kw):
        fn = self.fn
        name = 'launches'
        if fn is pp.phase_pair and a[4].dtype == torch.bfloat16:
            name = 'launches_bf16'
        setattr(fn, name, getattr(fn, name) + 1)
        return fn(*a, **kw)

    def __getattr__(self, name):
        return getattr(self.fn, name)

    def __setattr__(self, name, value):
        setattr(self.fn, name, value)


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
    for name, value in (('BATCH', 1024), ('RAGGED', 1003),
                        ('PHOTONS', 20_000), ('WARM_PHOTONS', 4_000),
                        ('SOLVE_PHOTONS', 4_000), ('INDEP_PHOTONS', 8_000),
                        ('FLUX_PHOTONS', 20_000),
                        ('HR_PHOTONS', 10_000), ('FLUX_REF_RUNS', WIDE),
                        ('MODES_PHOTONS', 6_000), ('IPA_FLUX_REF_RUNS', WIDE),
                        ('MARCH_PHOTONS', 6_000),
                        ('DIST_RANKS', 2), ('DIST_PHOTONS', 8_000),
                        ('DIST_FLUX_PHOTONS', 8_000),
                        ('DIST_SOLVE_PHOTONS', 4_000),
                        ('MARCH_FLUX_REF_RUNS', WIDE),
                        ('MARCH_RAD_REF_RUNS', tuple(r[0] for r in WIDE)),
                        ('MARCH_HR_REF_RUNS', tuple(r[0] for r in WIDE)),
                        ('QUASI_NPIX', 16), ('QUASI_STEPS', 48),
                        ('MODES_REF_RUNS', dict.fromkeys(
                            chip_smoke.MODES_REF_RUNS, WIDE_PLEN)),
                        ('REF_RUN_MEANS', tuple(r[0] for r in WIDE)),
                        ('HR_REF_RUNS', tuple(r[0] for r in WIDE)),
                        ('OUT_JSON', str(tmp_path / 'chip_smoke.json')),
                        ('build_bench_scene', _small_scene),
                        ('APPS_LES_SHAPE', (12, 12, 60)),
                        ('APPS_LES_PHOTONS', 4_000),
                        ('APPS_LUT_PHOTONS', 8_000),
                        ('APPS_CURVE_PHOTONS', 8_000),
                        ('APPS_FLUX_PHOTONS', 20_000),
                        ('APPS_LES_REF_RUNS', tuple(r[0] for r in WIDE)),
                        ('APPS_LUT_REF_RUNS', ((WIDE[0][:1] * 5,) * 2,
                                               (WIDE[1][:1] * 5,) * 2)),
                        ('APPS_CURVE_REF_RUNS', tuple(r[0] for r in WIDE)),
                        ('SAT_NX', 12), ('SAT_PHOTONS', 6_000),
                        ('SAT_REF_RUNS', dict.fromkeys(PHASE11, (
                            (0.0,) * 3, (100.0,) * 3))),
                        ('NATIVE_PHOTONS', 80_000),
                        ('EXAMPLES_PHOTONS', 4_000),
                        ('EXAMPLES_REF_RUNS', {
                            '01': WIDE, '06': tuple(r[:1] for r in WIDE)}),
                        ('EXAMPLES_OUT', str(tmp_path / 'phase12'))):
        monkeypatch.setattr(chip_smoke, name, value)
    # one Mie table a wavelength for the whole rehearsal (phase 10 asks
    # for 650 nm three times and 1600 nm once)
    mie = {}
    plain_mie = pha.pha_mie_wc

    def mie_once(wavelength=650.0, **kw):
        key = (wavelength, tuple(sorted(kw.items())))
        if key not in mie:
            mie[key] = plain_mie(wavelength, **kw)
        return mie[key]
    monkeypatch.setattr(pha, 'pha_mie_wc', mie_once)
    monkeypatch.setattr(chip_smoke, 'pha_mie_wc', mie_once)
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
    shims = {name: _Counting(fn) for name, fn in wrappers.items()}

    def refusing(tab):
        if tab.numel() * 4 > LIMIT:
            raise _build.CudaError('smem_stage', 1)
        return shims['smem_stage'](tab)
    for mod in (mc, mc_flight, gather_probe, gather, chip_smoke):
        for name, shim in shims.items():
            if hasattr(mod, name):
                monkeypatch.setattr(mod, name, shim)
    monkeypatch.setattr(gather_probe, 'smem_stage', refusing)
    return tmp_path


WIDE = ((0.0, 0.0), (100.0, 100.0))
WIDE_PLEN = ((0.0, 0.0), (100.0, 1e7))


def k1_keys(phases):
    """The per-path launch keys that ``phases`` add to the phase-pair
    kernel's entry of the kernels line."""
    keys = set()
    if 'flux' in phases:
        keys |= {'flux_launches'}
    if 'modes' in phases:
        keys |= {f'{m}_launches' for m in PHASE7}
    if 'march' in phases:
        keys |= {f'{m}_launches' for m in PHASE8}
    if 'dist' in phases:
        keys |= {f'dist_{m}_launches' for m in PHASE9}
    if 'apps' in phases:
        keys |= {f'apps_{m}_launches' for m in PHASE10}
    if 'sat' in phases:
        keys |= {f'sat_{m}_launches' for m in PHASE11}
    if 'scripts' in phases:
        keys |= {f'examples_{m}_launches' for m in PHASE12}
    if 'bench' in phases:
        keys |= {f'{m}_launches' for m in PHASE13}
    if 'sweeps' in phases:
        keys |= {f'sweeps_{m}_launches' for m in PHASE14}
    return keys


def rehearse(rehearsal, capsys, phases, monkeypatch=None):
    """chip_smoke.run with ``phases`` (and phases 1-4) on the CPU; checks
    the contract's last three lines, the main path, and every kernel's
    keys for those phases.  Returns (the printed lines, the report, the
    kernels line)."""
    if 'march' in phases:
        monkeypatch.setattr(chip_smoke, 'QUASI_REF', _quasi_ref(
            chip_smoke.QUASI_NPIX, chip_smoke.QUASI_STEPS))
    if 'sat' in phases:
        monkeypatch.setattr(chip_smoke, 'SAT_EXACT', _sat_exact(
            str(rehearsal / 'sat_ref.nc'), 12))
    args = type('A', (), {'seed': 0, 'profile': False})()
    assert chip_smoke.run(args, torch.device('cpu'), phases=phases) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == {'ok': True, 'device': {
        'platform': 'gpu', 'kind': 'cpu', 'count': 1}}
    assert lines[-3] == 'CPU stub, 0 W'
    kernels = json.loads(lines[-2])['kernels']
    report = json.loads((rehearsal / 'chip_smoke.json').read_text())
    main = report['main']
    assert report['floor_ms'] == 1.0
    assert main['phase_pair_launches'] == main['steps'] > 0
    assert all(n == 0 for k, n in main['launches'].items()
               if k != 'phase_pair')
    probes = 'probes' in phases
    assert [k['name'] for k in kernels] == ['phase_pair'] + (
        list(chip_smoke.PROBE_KERNELS) if probes else [])
    k1 = k1_keys(phases)
    for k in kernels:
        assert set(k) == KEYS | (k1 if k['name'] == 'phase_pair'
                                 else set()), k['name']
        assert k['launches'] > 0 and k['max_abs_err'] == 0.0, k['name']
        assert k['floor_ms'] == 1.0 and k['ms'] == k['plain_ms'] == 1.0
        assert k['bound_by'] == 'bytes' and 0 < k['bound_ms'] < 1.0
        assert (k['library_ms'] == 1.0) == (k['name'] in LIBRARY), k['name']
    rows = report['rows']
    assert sorted(rows) == ['K1'] + (['K2', 'K3', 'K4', 'K5', 'K6', 'K7',
                                      'K7_pair'] if probes else [])
    assert all(r['bound_ms'] > 0 and r['floor_ms'] == 1.0
               for r in rows.values())
    return lines, report, kernels


def test_chip_smoke_run_rehearsed_on_cpu(rehearsal, capsys):
    """Phases 1-4, 5, 5b, 4b, 7 and 6 (the probes); phases 8-14 are
    rehearsed in tests/test_torch_chip_smoke_{paths,apps,drivers,bench,
    sweeps}.py, a few phases a run, so that the test workers share them."""
    lines, report, kernels = rehearse(
        rehearsal, capsys, ('solve', 'independent', 'flux', 'modes',
                            'probes'))
    ind = report['independent']
    assert len(ind['passes']) == 2 * 4 and len(ind['runs']) == 2
    assert ind['phase_pair_launches'] == ind['steps'] == sum(
        p['steps'] for p in ind['passes']) > 0
    assert ind['n_photon_effective'] == 16_000
    assert [r['photons'] for r in ind['runs']] == [8_000, 8_000]
    assert all(r['photons_per_s'] > 0 for r in ind['runs'])
    assert ind['diffusion_total_rel_err'] <= 1e-9
    assert ind['domain_mean']['value'] > 0
    assert ind['noise_var_ratio_indep_over_corr'] > 0
    assert any(line.startswith('# independent run 1: ') for line in lines)
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
    modes = report['modes']
    assert set(modes) == set(PHASE7)
    for name, rec in modes.items():
        assert rec['phase_pair_launches'] == rec['steps'] > 0, name
        assert rec['photons'] == 6_000, name
        assert rec['photons_per_s'] > 0 and rec['passes'], name
        assert kernels[0][f'{name}_launches'] == rec['steps'], name
    for name in ('ipa', 'p3d', *chip_smoke.KNOBS):
        assert modes[name]['domain_mean']['value'] > 0, name
    assert modes['ipa_flux']['toa_direct_max_rel_err'] <= 1e-5
    assert modes['camera']['mean_finite']['value'] > 0
    assert modes['camera_air']['mean_plen']['value'] > 1e4
    assert modes['camera_air']['k1_bitwise_steps'] >= 2
    assert any(line.startswith('# phase 7 sort_coherent: ') for line in lines)
    rows = report['rows']
    assert rows['K4']['library_ms'] == rows['K6']['library_ms'] == 1.0
    assert rows['K2']['library_ms'] == 1.0
    ceiling = [(r['bytes'], r['ok']) for r in report['probes']
               if r['probe'] == 'vmem_ceiling']
    assert ceiling[-2:] == [(LIMIT, True), (LIMIT + 4, False)]
    probe_tags = [r['probe'] for r in report['probes']]
    assert probe_tags.count('launch_floor') == 1
    assert probe_tags.count('timing_methods') == 3


def test_fused_kernels_checked_in_the_rehearsal(rehearsal, capsys,
                                               monkeypatch, host_twin):
    """Phases 1-4 and 4b with the flight kernels fused as on the card,
    through the host build of their bodies (test_torch_fused_post.py):
    the main path's post half and the heating rate's tallies and post half
    are held against their plain versions at the captured steps of each
    of their widths (the full batch, 2048 here, and its drain stage),
    each kernel gets its entry in the kernels line (its cases a width),
    and its launches are the steps of its path."""
    init = mc_flight.FlightKernel.__init__

    def init_fused(kern, *a, **kw):
        init(kern, *a, **kw)
        fused_post_mod._fuse_on_cpu(kern)
    monkeypatch.setattr(mc_flight.FlightKernel, '__init__', init_fused)
    monkeypatch.setattr(flight_post, '_card_entry',
                        lambda dev: host_twin['post'])
    monkeypatch.setattr(domain_tally, '_card_entry',
                        lambda dev: host_twin['tally'])
    # the least batch that drains (to B/8 lanes; B/64 from 2^14)
    monkeypatch.setattr(chip_smoke, 'BATCH', 2048)
    args = type('A', (), {'seed': 0, 'profile': False})()
    assert chip_smoke.run(args, torch.device('cpu'), phases=('flux',)) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    kernels = json.loads(lines[-2])['kernels']
    report = json.loads((rehearsal / 'chip_smoke.json').read_text())
    main = report['main']
    assert main['fused_post_steps'] == main['steps'] > 0
    assert [k['name'] for k in kernels] == ['phase_pair', 'flight_post',
                                            'domain_tally']
    post, tally = kernels[1:]
    assert post['launches'] == main['steps']
    assert post['hr_launches'] == tally['launches'] > 0
    widths = ['2048_lanes', '256_lanes']
    for k in (post, tally):
        assert set(k) == KEYS | {'cases'} | (
            {'hr_launches'} if k is post else set()), k['name']
        assert k['source'] == chip_smoke.FUSED_KERNELS[k['name']][0]
        assert k['max_abs_err'] >= 0.0, k['name']
        assert k['ms'] == k['plain_ms'] == k['floor_ms'] == 1.0
        assert k['bound_by'] == 'bytes' and k['library_ms'] is None
        assert list(k['cases']) == widths, k['name']
        assert all(0 < c['bound_ms'] < 1.0 for c in k['cases'].values())
    fused = report['fused']
    assert [r['lanes'] for r in fused['flight_post']['hr_rows'].values()] \
        == [2048, 256]
    assert all(r['tally_err'].keys() == {'rad'}
               for r in fused['flight_post']['rows'].values())
    assert all(r['tally_err'].keys() == {'absorbed', 'absorbed_plain'}
               for r in fused['flight_post']['hr_rows'].values())
    assert post['max_abs_err'] <= 1e-4
    for r in fused['domain_tally']['rows'].values():
        assert 0 < r['active_share'] <= 1 and r['max_err_of_largest'] <= 1e-5
    for r in [*fused['flight_post']['rows'].values(),
              *fused['flight_post']['hr_rows'].values()]:
        assert all(rel <= 1e-5 for _, rel in r['tally_err'].values())


def check_march(lines, report, kernels):
    """Phase 8's records and quasi renders (tests/test_torch_chip_smoke_
    paths.py)."""
    march = report['march']
    assert set(march) == set(PHASE8)
    for name, rec in march.items():
        assert rec['phase_pair_launches'] == rec['steps'] > 0, name
        assert all(p['steps'] < p['max_steps'] for p in rec['passes']), name
        assert rec['photons'] == (12_000 if name == 'march_hr' else 6_000)
        assert kernels[0][f'{name}_launches'] == rec['steps'], name
        assert all(n == 0 for k, n in rec['launches'].items()
                   if k != 'phase_pair'), name
    assert march['march_flux']['toa_direct_max_rel_err'] <= 1e-5
    assert march['march_flux']['f_down_sfc']['value'] > 0
    assert march['march_rad']['domain_mean']['value'] > 0
    assert march['march_rad']['k1_bitwise_steps'] >= 2
    assert march['march_rad']['k1_tms_lanes'] > 0
    assert len(march['march_hr']['passes']) == 2
    assert march['march_hr']['column_absorbed']['value'] > 0
    assert any(line.startswith('# phase 8 march_flux: ') for line in lines)
    quasi = report['quasi']
    assert set(quasi) == set(chip_smoke.QUASI_CAMERAS)
    for name, rec in quasi.items():
        assert rec['nan_count'] == rec['ref_nan_count'] > 0, name
        assert abs(rec['rel_diff_mean']) <= chip_smoke.QUASI_RTOL, name
        assert rec['max_abs_rel_diff_block'] <= chip_smoke.QUASI_RTOL, name
        assert rec['wall_s'] > 0 and len(rec['blocks']) == 16, name


def check_dist(lines, report, kernels):
    """Phase 9's records (tests/test_torch_chip_smoke_paths.py)."""
    dist = report['dist']
    assert set(dist) == set(PHASE9)
    for name, rec in dist.items():
        assert rec['phase_pair_launches'] == rec['steps'] > 0, name
        assert rec['steps'] == sum(map(sum, rec['rank_steps'])), name
        assert kernels[0][f'dist_{name}_launches'] == rec['steps'], name
        assert all(n == 0 for k, n in rec['launches'].items()
                   if k != 'phase_pair'), name
        assert rec['photons'] == (8_000 if name in ('photon', 'decomp', 'flux')
                                  else 4_000), name
    assert [len(r) for r in dist['photon']['rank_steps']] == [2]
    assert dist['process_group']['rank_steps'] == [[
        dist['process_group']['steps']]]
    assert dist['process_group']['backend'] == 'gloo'
    for name in ('decomp', 'flux', 'solve'):
        rec = dist[name]
        assert all(r < m for r, m in zip(rec['rounds'], rec['max_rounds']))
        assert rec['shipped'] > 0 and 0 < rec['migrate_share'] < 1, name
    for name in ('photon', 'decomp', 'solve', 'process_group'):
        assert dist[name]['domain_mean']['value'] > 0, name
    assert dist['decomp']['k1_bitwise_steps'] >= 2
    assert dist['flux']['toa_direct_max_rel_err'] <= 1e-5
    assert any(line.startswith('# phase 9 decomp: ') for line in lines)


def check_apps(lines, report, kernels):
    """Phase 10's records (tests/test_torch_chip_smoke_apps.py)."""
    apps = report['apps']
    assert set(apps) == set(PHASE10)
    for name, rec in apps.items():
        assert rec['phase_pair_launches'] == rec['steps'] > 0, name
        assert kernels[0][f'apps_{name}_launches'] == rec['steps'], name
        assert all(n == 0 for k, n in rec['launches'].items()
                   if k != 'phase_pair'), name
        assert rec['photons_per_s'] > 0 and rec['k1_bitwise_steps'] >= 1
        assert all(0 < p['steps'] <= p['cap'] for p in rec['passes'])
        assert rec['in_flight'] == sum(p['in_flight'] for p in rec['passes'])
        assert any(line.startswith(f'# phase 10 {name}: ') for line in lines)
    les = apps['les']
    assert les['photons'] == 8_000 and les['synthetic'] is False
    assert les['cloud_layers'] >= 4 and les['k1_tables'] == 1
    assert les['domain_mean']['value'] > 0
    lut = apps['lut']
    assert lut['photons'] == 16_000 and len(lut['passes']) == 2
    assert lut['k1_tables'] == 2
    for band in ('ref_vis', 'ref_nir'):
        assert set(lut[band]) == {'mean', 'cot_lo_cer_lo', 'cot_lo_cer_hi',
                                  'cot_hi_cer_lo', 'cot_hi_cer_hi'}
    assert lut['retrieved'] == [[float(c) for c in np.concatenate(
        [[0.0], np.logspace(-1, 2, 24)])[[8, 15, 21]]], [8.0, 14.0, 20.0]]
    assert apps['curve']['photons'] == 8_000 and apps['curve']['rising']
    flux = apps['spectral_flux']
    assert flux['photons'] == 60_000 and flux['k1_tables'] == 3
    assert set(flux['wavelengths']) == {'650.0', '762.0', '860.0'}
    for rec in flux['wavelengths'].values():
        assert abs(rec['rel_diff_f_down']) <= 0.03
        assert abs(rec['rel_diff_f_up']) <= 0.06
        assert rec['toa_direct_max_rel_err'] <= 1e-5


def check_sat(lines, report, kernels):
    """Phase 11's records (tests/test_torch_chip_smoke_apps.py)."""
    sat = report['sat']
    assert set(sat) == set(PHASE11) | {'file_mb', 'write_s', 'read_s',
                                       'grid', 'exact'}
    assert sat['grid'] == [12, 12] and 30 < sat['file_mb'] < 45
    assert sat['exact'] == list(chip_smoke.SAT_EXACT)
    for name in PHASE11:
        rec = sat[name]
        assert rec['phase_pair_launches'] == rec['steps'] > 0, name
        assert kernels[0][f'sat_{name}_launches'] == rec['steps'], name
        assert all(n == 0 for k, n in rec['launches'].items()
                   if k != 'phase_pair'), name
        assert rec['photons'] == 6_000 and rec['photons_per_s'] > 0, name
        assert rec['k1_bitwise_steps'] >= 1 and rec['k1_tables'] == 1, name
        assert rec['passes_at_cap'] == sum(p['steps'] >= p['cap']
                                           for p in rec['passes'])
        assert rec['in_flight'] == sum(p['in_flight'] for p in rec['passes'])
        assert rec['toa_direct_max_rel_err'] <= 1e-5, name
        assert rec['track_level_km'] == 5.0, name
        for key in ('f_down_sfc', 'f_up_toa', 'f_down_track'):
            assert rec[key]['value'] > 0, (name, key)
    assert any(line.startswith('# phase 11: ') for line in lines)


def check_scripts(lines, report, kernels, out_dir):
    """Phase 12's records (tests/test_torch_chip_smoke_drivers.py)."""
    scripts = report['scripts']
    assert set(scripts) == {'native', 'example_01', 'example_06', 'vis',
                            'matplotlib'}
    nat = scripts['native']
    assert nat['photons'] == 80_000 and nat['library'].startswith('libmc_ref')
    assert set(nat['runs']) == {'native_flux', 'native_rad', 'flight_flux',
                                'flight_rad', 'march_flux'}
    assert all(r['wall_s'] > 0 for r in nat['runs'].values())
    assert set(nat['flux']) == {'flight_vs_native', 'march_vs_native',
                                'flight_vs_march'}
    for rel in nat['flux'].values():
        assert rel['down_direct'] <= 0.05 and rel['up'] <= 0.05
        assert abs(rel['sfc_down_diffuse']) <= 0.08
    assert abs(nat['radiance_flight_vs_native']['mean']) <= 0.04
    for case in PHASE12:
        rec = scripts[f'example_{case}']
        assert rec['phase_pair_launches'] == rec['steps'] > 0, case
        assert kernels[0][f'examples_{case}_launches'] == rec['steps'], case
        assert all(n == 0 for k, n in rec['launches'].items()
                   if k != 'phase_pair'), case
        assert rec['photons'] == 12_000 and rec['k1_bitwise_steps'] >= 1
        assert rec['passes_at_cap'] == sum(p['steps'] >= p['cap']
                                           for p in rec['passes'])
    assert scripts['example_01']['toa_direct_rel_err'] <= 1e-5
    assert scripts['example_01']['f_down_sfc']['value'] > 0
    assert scripts['example_06']['domain_mean']['value'] > 0
    page = scripts['vis']
    assert page['block'] == 2 and page['page_shape'] == [100, 100]
    assert scripts['matplotlib'] is page['png_writers_called'] is True
    assert all(n > 0 for n in page['pngs'].values())
    assert sorted(os.listdir(out_dir)) == [
        '01_flux_clear_sky.png', '06_rad_hem.html', '06_rad_hem.png']
    assert any(line.startswith('# phase 12: ') for line in lines)


def _rehearsed_phases():
    """The ``phases`` that each rehearsal test passes to ``rehearse``, read
    from the test files by ``ast``."""
    here = os.path.dirname(os.path.abspath(__file__))
    split = []
    for name in sorted(os.listdir(here)):
        if not (name.startswith('test_torch_chip_smoke')
                and name.endswith('.py')):
            continue
        with open(os.path.join(here, name)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Call) and getattr(
                    node.func, 'id', None) == 'rehearse':
                split.append(ast.literal_eval(node.args[2]))
    return split


def test_split_rehearsals_cover_the_default_run():
    """No CPU test runs every phase in one process (the card run does):
    the rehearsals, split over six files, run each phase of
    chip_smoke.run's default once between them, and the launch keys they
    check add up, with none written by two phases, to those of the
    default run's kernels line."""
    default = inspect.signature(chip_smoke.run).parameters['phases'].default
    assert default == chip_smoke.PHASES
    split = _rehearsed_phases()
    assert len(split) == 8
    assert sorted(p for ps in split for p in ps) == sorted(chip_smoke.PHASES)
    parts = [k1_keys(ps) for ps in split]
    assert set().union(*parts) == k1_keys(chip_smoke.PHASES)
    assert sum(map(len, parts)) == len(k1_keys(chip_smoke.PHASES)) == 43


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


def test_phase12_without_matplotlib_never_calls_the_png_writers(
        monkeypatch, tmp_path):
    """Where matplotlib is not installed (the card machine), phase 12 runs
    example 00's cases with their PNG writers replaced: it never calls
    them, writes no PNG, and still writes and checks the comparison page.
    The solves and the native phase are stand-ins here."""
    import importlib.util
    import types
    plain_find = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, 'find_spec', lambda name, *a: (
        None if name == 'matplotlib' else plain_find(name, *a)))
    rng = np.random.default_rng(0)

    class Res(types.SimpleNamespace):
        def __getitem__(self, k):
            return self.data[k]

    def fake_solve(**kw):
        nz1 = kw['atm'].nz + 1
        if kw['target'] == 'flux':
            data = {'f_down': np.full((1, 1, nz1), 1.3),
                    'f_up': np.full((1, 1, nz1), 0.07),
                    'f_down_direct': np.full((1, 1, nz1), 2.0 * np.cos(
                        np.deg2rad(30.0)))}
        else:
            data = {'rad': rng.uniform(0.02, 0.1, (200, 200))}
        return Res(data=data, toa=2.0, n_photon_effective=3 * kw['photons'])

    def refuse(*a, **kw):
        raise AssertionError('a PNG writer was called')
    plain_load = chip_smoke.load_script

    def load(path, name):
        mod = plain_load(path, name)
        mod.solver = types.SimpleNamespace(solve=fake_solve)
        mod.plot_flux_profile = mod.quicklook_radiance = refuse
        return mod
    monkeypatch.setattr(chip_smoke, 'load_script', load)
    monkeypatch.setattr(chip_smoke, 'native_phase', lambda args, dev: {})
    monkeypatch.setattr(chip_smoke, 'captured_path', lambda name, fn: (
        fn(None), {'phase_pair_launches': 1}, 0.0))
    monkeypatch.setattr(chip_smoke, 'EXAMPLES_OUT', str(tmp_path))
    monkeypatch.setattr(chip_smoke, 'EXAMPLES_REF_RUNS', {
        '01': ((1.3, 0.07), (1.3, 0.07)), '06': ((0.06,), (0.06,))})
    report = {}
    args = types.SimpleNamespace(seed=0)
    assert chip_smoke.scripts_phase(args, torch.device('cpu'), report) == 0.0
    rep = report['scripts']
    assert rep['matplotlib'] is False
    assert rep['vis']['png_writers_called'] is False
    assert rep['vis']['pngs'] == {'01_flux_clear_sky.png': 0,
                                  '06_rad_hem.png': 0}
    assert os.listdir(tmp_path) == ['06_rad_hem.html']

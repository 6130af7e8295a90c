"""The port's example, project and ``bin/`` drivers against the JAX
package's: examples/0{0,1,2}_er3t_tpu_torch*.py, projects/0{1..5}_*_torch.py
and bin/{lss,lsa,sdown}_torch beside examples/0{0,1,2}_er3t_tpu*.py,
projects/0{1..5}_*.py and bin/{lss,lsa,sdown}.

Every call a script makes to ``solve`` (and to ``func_ref_vs_cot*`` or the
1D spectral solvers where it calls them) is recorded by a spy set on the
script module's attribute, in both packages, and the two records must be
equal bit for bit (``assert_same``): the atmosphere, gases, cloud, phase
table, aerosols and surface, the angles, photons, seeds and options.  A
spy stops the script with a sentinel at the call given; where later calls
are reached, both spies return the same made-up result.  None of these
runs Monte Carlo.  Then the slice as a whole: example 00 case 01 end to
end in both packages, and each port script end to end on the CPU at a small
size into ``tmp_path`` (``slow`` where it takes more than a few seconds).
Nothing is written under examples/output/ or projects/output/: both
packages' scripts write into ``tmp_path``.
"""

import importlib.machinery
import importlib.util
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from er3t_tpu.apps import lut as j_lut
from er3t_tpu_torch.apps import lut as t_lut
from test_torch_pre import assert_same

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# script pairs: key -> (JAX package's script, the port's)
SCRIPTS = {
    'ex00': ('examples/00_er3t_tpu.py', 'examples/00_er3t_tpu_torch.py'),
    'ex01': ('examples/01_er3t_tpu_spectral.py',
             'examples/01_er3t_tpu_torch_spectral.py'),
    'ex02': ('examples/02_er3t_tpu_lrt_rad.py',
             'examples/02_er3t_tpu_torch_lrt_rad.py'),
    'p01': ('projects/01_oco2_rad_sim.py', 'projects/01_oco2_rad_sim_torch.py'),
    'p02': ('projects/02_sat_rad_sim.py', 'projects/02_sat_rad_sim_torch.py'),
    'p03': ('projects/03_spns_flux_sim.py',
            'projects/03_spns_flux_sim_torch.py'),
    'p04': ('projects/04_cam_nadir_rad_sim.py',
            'projects/04_cam_nadir_rad_sim_torch.py'),
    'p05': ('projects/05_cnn_les_factory.py',
            'projects/05_cnn_les_factory_torch.py'),
}
_LOADED = {}
_MIE = {}


def _mie_once(pha_mie_wc):
    """``pha_mie_wc`` computing each wavelength's table once per test
    process (the scripts ask for the same table again and again)."""
    def cached(wavelength=650.0, **kw):
        key = (pha_mie_wc, wavelength, tuple(sorted(kw.items())))
        if key not in _MIE:
            _MIE[key] = pha_mie_wc(wavelength, **kw)
        return _MIE[key]
    return cached


def load(path):
    """The script at ``path`` (relative to the repository) as a module,
    loaded once, its ``pha_mie_wc`` caching its tables."""
    if path not in _LOADED:
        name = 'script_' + os.path.basename(path).replace('.', '_')
        full = os.path.join(REPO, path)
        loader = importlib.machinery.SourceFileLoader(name, full)
        spec = importlib.util.spec_from_file_location(name, full,
                                                      loader=loader)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        if hasattr(mod, 'pha_mie_wc'):
            mod.pha_mie_wc = _mie_once(mod.pha_mie_wc)
        _LOADED[path] = mod
    return _LOADED[path]


class Stop(Exception):
    """Raised by a spy to end a script at the call it was told to."""


class FakeResult:
    """A made-up solve result: every field of both targets, filled from a
    generator seeded by the call's index, on the cloud's grid (one column
    without a cloud)."""

    def __init__(self, kw, index):
        cld = kw.get('cld')
        nx, ny = (cld.nx, cld.ny) if cld is not None else (1, 1)
        rng = np.random.default_rng(index)
        nz = kw['atm'].nz
        self.data = {'rad': rng.uniform(0.05, 0.3, (nx, ny))}
        for k in ('f_down', 'f_up', 'f_down_direct', 'f_down_diffuse'):
            self.data[k] = rng.uniform(0.1, 1.5, (nx, ny, nz + 1))
        self.toa = 1.5

    def __getitem__(self, k):
        return self.data[k]


class FakeCurve:
    """A made-up reflectance-vs-COT curve (func_ref_vs_cot's fields)."""
    cot = np.linspace(0.0, 60.0, 17)
    ref = np.linspace(0.05, 0.8, 17)
    ref_2s = ref * 1.01
    toa = 1.5

    def get_cot_from_ref(self, r):
        return np.interp(r, self.ref, self.cot)


class Spy:
    """Records each call's arguments; returns ``fake(kwargs, index)`` or
    raises :class:`Stop` at call ``stop_at`` (0-based)."""

    def __init__(self, fake=None, stop_at=0):
        self.calls, self.fake, self.stop_at = [], fake, stop_at

    def __call__(self, *args, **kw):
        self.calls.append((args, kw))
        if len(self.calls) > self.stop_at:
            raise Stop
        return self.fake(kw, len(self.calls) - 1)


def solve_spy(monkeypatch, mod, stop_at=0):
    """A spy in place of ``mod.solver`` (the script's ``solver.solve``)."""
    spy = Spy(FakeResult, stop_at)
    monkeypatch.setattr(mod, 'solver', types.SimpleNamespace(solve=spy))
    return spy


def run_main(monkeypatch, mod, argv):
    """``mod.main()`` under ``argv``; True if a spy stopped it."""
    monkeypatch.setattr(sys, 'argv', [mod.__file__, *argv])
    try:
        mod.main()
    except Stop:
        return True
    return False


def same_calls(ref, got, port=True):
    """The JAX script's calls ``ref`` equal the port's ``got``: the port's
    runs all asked for the CPU (``device``), nothing else differs."""
    assert len(got) == len(ref)
    for i, ((ra, rk), (ga, gk)) in enumerate(zip(ref, got)):
        gk = dict(gk)
        if port:
            assert gk.pop('device') == 'cpu', i
        assert_same(list(ra), list(ga), f'call {i} args')
        assert_same(rk, gk, f'call {i}')


# ---- example 00 ----

@pytest.mark.parametrize('case', ['01', '02', '03', '04', '05', '06'])
def test_example_00_solve_arguments(case, monkeypatch, tmp_path):
    """Each case's solve call equals the JAX script's bit for bit."""
    calls = []
    for path, kw in zip(SCRIPTS['ex00'], ({}, {'device': 'cpu'})):
        mod = load(path)
        monkeypatch.setattr(mod, 'OUT', str(tmp_path))
        spy = solve_spy(monkeypatch, mod)
        with pytest.raises(Stop):
            mod.EXAMPLES[case](1e6, **kw)
        calls.append(spy.calls)
    same_calls(*calls)


def test_example_00_cli_runs_every_case_on_the_device(monkeypatch, tmp_path):
    """The command line passes --device and --photons to every case; each
    case returns its result (a made-up one here) and plots it."""
    mod = load(SCRIPTS['ex00'][1])
    monkeypatch.setattr(mod, 'OUT', str(tmp_path / 'out'))
    spy = solve_spy(monkeypatch, mod, stop_at=99)
    assert not run_main(monkeypatch, mod, ['01', '06', '--photons', '2e3',
                                           '--device', 'cpu'])
    assert [kw['device'] for _, kw in spy.calls] == ['cpu', 'cpu']
    assert [kw['photons'] for _, kw in spy.calls] == [2e3, 2e3]
    assert sorted(os.listdir(tmp_path / 'out')) == [
        '01_flux_clear_sky.png', '06_rad_hem.png']


# ---- examples 01 and 02 ----

@pytest.mark.parametrize('fast', [False, True], ids=['default', 'fast'])
def test_example_01_spectral_arguments(fast, monkeypatch):
    """The five 1D spectral calls equal the JAX script's (made-up results
    between them; stopped before the plot)."""
    calls = []
    for path in SCRIPTS['ex01']:
        mod = load(path)
        flx = Spy(lambda kw, i: {}, stop_at=99)
        rad = Spy(lambda kw, i: {}, stop_at=1)
        monkeypatch.setattr(mod, 'spec_flx', flx)
        monkeypatch.setattr(mod, 'spec_rad', rad)
        assert run_main(monkeypatch, mod, ['--fast'] if fast else [])
        calls.append((flx.calls, rad.calls))
    assert len(calls[1][0]) == 3 and len(calls[1][1]) == 2
    for ref, got in zip(*calls):
        same_calls(ref, got, port=False)


def test_example_02_solve_and_1d_arguments(monkeypatch):
    """The sun-glint solves (the first three azimuths; made-up radiances
    between them) equal the JAX script's, and so do the Libera ADM 1D
    solver's inputs, layer by layer (first wavelength)."""
    calls = []
    for path, kw in zip(SCRIPTS['ex02'], ({}, {'device': 'cpu'})):
        mod = load(path)
        spy = solve_spy(monkeypatch, mod, stop_at=2)
        with pytest.raises(Stop):
            mod.sun_glint(fast=True, **kw)
        pp = Spy(lambda kw, i: np.zeros(73), stop_at=15)
        monkeypatch.setattr(mod, 'solve_plane_parallel', pp)
        with pytest.raises(Stop):
            mod.libera_adm(fast=True)
        calls.append((spy.calls, pp.calls))
    same_calls(calls[0][0], calls[1][0])
    same_calls(calls[0][1], calls[1][1], port=False)
    assert [kw['sensor_azimuth_angle'] for _, kw in calls[1][0]] == [
        0.0, 30.0, 60.0]


# ---- projects ----

PROJECT_CASES = {
    'p01': [],
    'p01_corrected': ['--vza', '20', '--vaa', '30', '--wind-u', '5',
                      '--wind-v', '-3', '--dt', '90'],
    'p02': [],
    'p03': [],
    'p04': [],
    'p04_fast_curve': ['--fast-curve'],
    'p05': [],
}


@pytest.mark.parametrize('case', list(PROJECT_CASES))
def test_project_solve_arguments(case, monkeypatch, tmp_path):
    """Every solve and func_ref_vs_cot* call of a project's whole run
    (made-up results between them) equals the JAX script's bit for bit."""
    key = case.split('_')[0]
    calls = []
    for pkg, path, lut in zip(('jax', 'torch'), SCRIPTS[key],
                              (j_lut, t_lut)):
        mod = load(path)
        out = tmp_path / pkg
        out.mkdir()             # the JAX package's projects/05 makes none
        spy = solve_spy(monkeypatch, mod, stop_at=99)
        curves = Spy(lambda kw, i: FakeCurve(), stop_at=99)
        for name in ('func_ref_vs_cot', 'func_ref_vs_cot_multi_pixel'):
            monkeypatch.setattr(lut, name, curves)
            if hasattr(mod, name):
                monkeypatch.setattr(mod, name, curves)
        argv = PROJECT_CASES[case] + (
            ['--out', str(out / 'tiles.npz')] if key == 'p05'
            else ['--outdir', str(out)])
        if pkg == 'torch':
            argv += ['--device', 'cpu']
        assert not run_main(monkeypatch, mod, argv)
        calls.append((spy.calls, curves.calls))
    n_solve = {'p01': 2, 'p02': 2, 'p03': 2, 'p04': 3, 'p05': 4}[key]
    assert len(calls[1][0]) == n_solve
    assert len(calls[1][1]) == (1 if key in ('p04', 'p05') else 0)
    for ref, got in zip(*calls):
        same_calls(ref, got)


# ---- the slice as a whole ----

def test_example_00_case_01_end_to_end_matches_jax(monkeypatch, tmp_path):
    """Example 00 case 01 (clear sky, 3 runs) in both packages: TOA
    down-direct is toa * mu0 to 1e-5 in the port, and the surface f_down
    agrees within max(2 %, 4 sigma)."""
    res = []
    for path, kw in zip(SCRIPTS['ex00'], ({}, {'device': 'cpu'})):
        mod = load(path)
        monkeypatch.setattr(mod, 'OUT', str(tmp_path))
        plain = mod.solver.solve
        got = []

        def keep(**a):
            got.append(plain(**a))
            return got[-1]
        monkeypatch.setattr(mod, 'solver', types.SimpleNamespace(solve=keep))
        mod.EXAMPLES['01'](3e4, **kw)
        res.append(got[0])
    ref, port = res
    mu0 = np.cos(np.deg2rad(30.0))
    direct = np.squeeze(port['f_down_direct'])[-1]
    assert abs(direct / (port.toa * mu0) - 1) <= 1e-5
    a = float(np.squeeze(ref['f_down'])[0])
    b = float(np.squeeze(port['f_down'])[0])
    sigma = np.hypot(float(np.squeeze(ref.std['f_down_std'])[0]),
                     float(np.squeeze(port.std['f_down_std'])[0])) / np.sqrt(3)
    assert abs(b - a) <= max(0.02 * a, 4 * sigma)
    assert (tmp_path / '01_flux_clear_sky.png').stat().st_size > 0


PORT_RUNS = {
    'ex00_06': ('ex00', ['06', '--photons', '2e4']),
    'ex01': ('ex01', ['--fast']),
    'ex02': ('ex02', ['--fast']),
    'p01': ('p01', ['--photons', '2e4', '--nx', '16']),
    'p02': ('p02', ['--photons', '2e4', '--nx', '16']),
    'p03': ('p03', ['--photons', '2e4', '--nx', '12']),
    'p04': ('p04', ['--photons', '2e4', '--nx', '12', '--fast-curve']),
    'p05': ('p05', ['--photons', '2e4', '--scenes', '1', '--coarsen', '4']),
}
PORT_FILES = {
    'ex00_06': ['06_rad_hem.png'], 'ex01': ['01_spectral.png'],
    'ex02': ['02_lrt_rad.png'],
    'p01': ['oco2_aband_rad.npz', 'oco2_aband_rad.png'],
    'p02': ['ipa_vs_3d.png', 'rad_3d.png', 'rad_ipa.png'],
    'p03': ['spns_track_flux.npz', 'spns_track_flux.png'],
    'p04': ['cam_nadir_rad.npz', 'cam_nadir_rad.png'],
    'p05': ['tiles.npz'],
}
SLOW_RUNS = ('ex00_06', 'ex01', 'ex02', 'p02', 'p03', 'p04', 'p05')


@pytest.mark.parametrize('case', [
    pytest.param(c, marks=pytest.mark.slow) if c in SLOW_RUNS else c
    for c in PORT_RUNS])
def test_port_script_runs_end_to_end_on_the_cpu(case, monkeypatch,
                                                 tmp_path):
    """Each port script at a small size on the CPU writes its files into
    tmp_path, each non-empty."""
    key, argv = PORT_RUNS[case]
    mod = load(SCRIPTS[key][1])
    argv = list(argv)
    if key.startswith('ex'):
        monkeypatch.setattr(mod, 'OUT', str(tmp_path))
    elif key == 'p05':
        argv += ['--out', str(tmp_path / 'tiles.npz')]
    else:
        argv += ['--outdir', str(tmp_path)]
    if key != 'ex01':
        argv += ['--device', 'cpu']
    assert not run_main(monkeypatch, mod, argv)
    assert sorted(os.listdir(tmp_path)) == PORT_FILES[case]
    assert all((tmp_path / f).stat().st_size > 0 for f in PORT_FILES[case])
    if key == 'p05':
        with np.load(tmp_path / 'tiles.npz') as z:
            assert z['ipa_cot'].shape == z['ipa_ref'].shape == (31,)
            assert np.isfinite(z['ipa_ref']).all()


# ---- bin/ ----

def _classic_nc(fname):
    """A small classic netCDF granule: two variables with attributes."""
    from scipy.io import netcdf_file
    rng = np.random.default_rng(3)
    with netcdf_file(fname, 'w') as f:
        f.createDimension('y', 5)
        f.createDimension('x', 4)
        v = f.createVariable('cot', 'f', ('y', 'x'))
        v[:] = rng.uniform(0, 30, (5, 4)).astype(np.float32)
        v.units = 'N/A'
        v.scale_factor = 0.5
        w = f.createVariable('lat', 'd', ('y',))
        w[:] = np.linspace(14.0, 16.0, 5)
        w.long_name = 'latitude'
    return str(fname)


def _tool(name, *args):
    proc = subprocess.run([sys.executable, os.path.join(REPO, 'bin', name),
                           *args], cwd=REPO, capture_output=True, text=True,
                          timeout=120, env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


@pytest.mark.parametrize('tool,args', [('lss', ()), ('lsa', ()),
                                       ('lsa', ('-d', 'cot')),
                                       ('sdown', ('--list',))],
                         ids=['lss', 'lsa', 'lsa_dataset', 'sdown_list'])
def test_bin_tools_print_the_same(tool, args, tmp_path):
    fname = () if tool == 'sdown' else (_classic_nc(tmp_path / 'g.nc'),)
    ref = _tool(tool, *fname, *args)
    assert ref.strip()
    assert _tool(f'{tool}_torch', *fname, *args) == ref

"""The port never imports JAX or the JAX package, its entry points run on
the card unless asked for the CPU, and neither chip_smoke.py nor the gather
probes have a CPU fallback.  The same holds for the port's example, project
and bin/ drivers, bench_torch.py and the measurement harnesses of
scripts/*_torch.py: none loads JAX or the JAX package, and each driver's
``--device`` defaults to the card and raises without one."""

import argparse
import importlib.machinery
import importlib.util
import inspect
import os
import subprocess
import sys

import pytest

from er3t_tpu_torch.apps import lut, spectral
from er3t_tpu_torch.dist import mesh
from er3t_tpu_torch.rtm import mc, mc_flight, quasi, scene, solver

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_MODULES = ('er3t_tpu_torch', 'er3t_tpu_torch._build',
                'er3t_tpu_torch.pre', 'er3t_tpu_torch.pre.abs',
                'er3t_tpu_torch.pre.aer', 'er3t_tpu_torch.pre.atm',
                'er3t_tpu_torch.pre.cld', 'er3t_tpu_torch.pre.pha',
                'er3t_tpu_torch.pre.sfc', 'er3t_tpu_torch.physics',
                'er3t_tpu_torch.physics.constants',
                'er3t_tpu_torch.physics.hg', 'er3t_tpu_torch.physics.mie',
                'er3t_tpu_torch.physics.rayleigh',
                'er3t_tpu_torch.physics.solar',
                'er3t_tpu_torch.physics.water', 'er3t_tpu_torch.util',
                'er3t_tpu_torch.util.grid',
                'er3t_tpu_torch.rtm', 'er3t_tpu_torch.rtm.mc',
                'er3t_tpu_torch.rtm.scene', 'er3t_tpu_torch.rtm.brdf',
                'er3t_tpu_torch.rtm.phase_pair', 'er3t_tpu_torch.rtm.mc_flight',
                'er3t_tpu_torch.rtm.out', 'er3t_tpu_torch.rtm.solver',
                'er3t_tpu_torch.rtm.quasi', 'er3t_tpu_torch.rtm.oned',
                'er3t_tpu_torch.probes', 'er3t_tpu_torch.probes.gather',
                'er3t_tpu_torch.probes.gather_probe', 'er3t_tpu_torch.dist',
                'er3t_tpu_torch.dist.mesh', 'er3t_tpu_torch.dist.photon',
                'er3t_tpu_torch.dist.decomp', 'er3t_tpu_torch.common',
                'er3t_tpu_torch.util.ncio', 'er3t_tpu_torch.util.logger',
                'er3t_tpu_torch.pre.pmom', 'er3t_tpu_torch.pre.abs_16g_db',
                'er3t_tpu_torch.pre.abs_rep_db', 'er3t_tpu_torch.pre.abs_gen',
                'er3t_tpu_torch.pre.abs_oco', 'er3t_tpu_torch.pre.abs_rrtmg',
                'er3t_tpu_torch.physics.twostream',
                'er3t_tpu_torch.physics.cloud_optics', 'er3t_tpu_torch.apps',
                'er3t_tpu_torch.apps.cldpos', 'er3t_tpu_torch.apps.lut',
                'er3t_tpu_torch.apps.spectral', 'er3t_tpu_torch.util.geo',
                'er3t_tpu_torch.util.misc', 'er3t_tpu_torch.sat',
                'er3t_tpu_torch.sat.ahi', 'er3t_tpu_torch.sat.oco2',
                'er3t_tpu_torch.sat.calipso', 'er3t_tpu_torch.sat.daac',
                'er3t_tpu_torch.sat.viirs', 'er3t_tpu_torch.sat.modis',
                'er3t_tpu_torch.vis', 'er3t_tpu_torch.vis.plot',
                'er3t_tpu_torch.vis.intv', 'er3t_tpu_torch.native',
                'chip_smoke_files', 'chip_smoke', 'chip_drivers',
                'bench_torch')
# the port's drivers, and whether each takes --device
PORT_SCRIPTS = {'examples/00_er3t_tpu_torch.py': True,
                'examples/01_er3t_tpu_torch_spectral.py': False,
                'examples/02_er3t_tpu_torch_lrt_rad.py': True,
                'projects/01_oco2_rad_sim_torch.py': True,
                'projects/02_sat_rad_sim_torch.py': True,
                'projects/03_spns_flux_sim_torch.py': True,
                'projects/04_cam_nadir_rad_sim_torch.py': True,
                'projects/05_cnn_les_factory_torch.py': True,
                'bin/lss_torch': False, 'bin/lsa_torch': False,
                'bin/sdown_torch': False, 'bench_torch.py': True,
                'scripts/profile_ablate_torch.py': True,
                'scripts/ablate2_torch.py': True,
                'scripts/var_budget_torch.py': True,
                'scripts/drain_ab_torch.py': True,
                'scripts/r5_knobs_torch.py': True,
                'scripts/tile_sweep_torch.py': True,
                'scripts/locality_ab_torch.py': True,
                'scripts/flux_kx_torch.py': True}
DEVICE_SCRIPTS = [p for p, dev in PORT_SCRIPTS.items() if dev]


def load_script(path):
    """The driver at ``path`` (relative to the repository) as a module,
    its ``main`` not run."""
    full = os.path.join(REPO, path)
    name = 'script_' + os.path.basename(path).replace('.', '_')
    loader = importlib.machinery.SourceFileLoader(name, full)
    mod = importlib.util.module_from_spec(
        importlib.util.spec_from_file_location(name, full, loader=loader))
    loader.exec_module(mod)
    return mod


def _python(code, **env):
    e = dict(os.environ, PYTHONPATH=REPO, **env)
    return subprocess.run([sys.executable, '-c', code], cwd=REPO, env=e,
                          capture_output=True, text=True, timeout=120)


def test_port_and_chip_smoke_import_no_jax():
    """Neither ``jax*`` nor ``er3t_tpu`` nor any ``er3t_tpu.*`` module."""
    code = ('import importlib, sys\n'
            f'for m in {PORT_MODULES!r}:\n'
            '    importlib.import_module(m)\n'
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'jaxlib')) "
            "or m == 'er3t_tpu' or m.startswith('er3t_tpu.'))\n"
            'assert not bad, bad\n'
            "print('clean')\n")
    proc = _python(code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == 'clean'


def test_scripts_import_no_jax():
    """Every port driver, loaded as ``chip_smoke.py`` and the tests load
    it, with the modules it imports inside its functions (the satellite
    readers, the LUT and cloud-position apps, the O2 A-band loader and the
    netCDF helpers) loaded too."""
    code = ('import importlib, sys\n'
            "sys.path.insert(0, 'tests')\n"
            'from test_torch_imports import PORT_SCRIPTS, load_script\n'
            'for p in PORT_SCRIPTS:\n'
            '    load_script(p)\n'
            "for m in ('er3t_tpu_torch.sat.oco2', 'er3t_tpu_torch.sat.ahi', "
            "'er3t_tpu_torch.sat.viirs', 'er3t_tpu_torch.apps.lut', "
            "'er3t_tpu_torch.apps.cldpos', 'er3t_tpu_torch.pre.abs_oco', "
            "'er3t_tpu_torch.util.ncio'):\n"
            '    importlib.import_module(m)\n'
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'jaxlib')) "
            "or m == 'er3t_tpu' or m.startswith('er3t_tpu.'))\n"
            'assert not bad, bad\n'
            "print('clean')\n")
    proc = _python(code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == 'clean'


class _Parsed(Exception):
    pass


@pytest.mark.parametrize('path', DEVICE_SCRIPTS)
def test_script_device_defaults_to_the_card(path, monkeypatch):
    """The driver's --device, left out, asks for the card."""
    mod = load_script(path)
    seen = []
    plain = argparse.ArgumentParser.parse_args

    def parse(self, *a, **kw):
        seen.append(plain(self, *a, **kw))
        raise _Parsed
    monkeypatch.setattr(argparse.ArgumentParser, 'parse_args', parse)
    monkeypatch.setattr(sys, 'argv', [path])
    with pytest.raises(_Parsed):
        mod.main()
    assert seen[0].device == 'cuda'


@pytest.mark.parametrize('path', DEVICE_SCRIPTS)
def test_script_without_a_card_raises(path, tmp_path):
    """Run at its defaults with no card visible, the driver raises at its
    first run on the device: nothing carries on on the CPU, and no result
    file is written."""
    out = ['--out', str(tmp_path / 'o.npz')] if path.startswith(
        'projects/05') else ['--outdir', str(tmp_path)] if path.startswith(
        'projects') else []
    proc = subprocess.run([sys.executable, os.path.join(REPO, path), *out],
                          cwd=str(tmp_path), capture_output=True, text=True,
                          timeout=300, env=dict(os.environ, PYTHONPATH=REPO,
                                                CUDA_VISIBLE_DEVICES=''))
    assert proc.returncode != 0
    assert 'CUDA' in proc.stderr or 'cuda' in proc.stderr
    assert not [f for f in os.listdir(tmp_path) if f.endswith(
        ('.npz', '.png'))]


def test_phase11_path_loads_no_h5py(tmp_path):
    """The card machine has no h5py, netCDF4 or pyhdf: phase 11 of
    chip_smoke.py writes its AHI granule (chip_smoke_files.write_ahi_clp)
    and reads it (sat.ahi.ahi_l2 in chip_smoke.sat_scene) with none of
    them loaded."""
    fname = str(tmp_path / 'ahi_clp.nc')
    code = ('import sys\n'
            'import chip_smoke, chip_smoke_files\n'
            f'fn = chip_smoke_files.write_ahi_clp({fname!r}, seed=0, '
            'lon=(119.0, 123.0), lat=(18.0, 14.0))\n'
            'cot = chip_smoke.sat_scene(fn, 12)[-1]\n'
            "bad = sorted(m for m in sys.modules if m.startswith(('h5py', "
            "'netCDF4', 'pyhdf')))\n"
            'assert not bad, bad\n'
            "print(cot.shape)\n")
    proc = _python(code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == '(12, 12)'


@pytest.mark.parametrize('fn', [scene.build_scene, solver.solve,
                                mc_flight.run_transport_flight,
                                mc.run_transport, mc.transport,
                                quasi.quasi_radiance, mesh.make_mesh,
                                lut.gen_bispectral_lookup_table,
                                lut.func_ref_vs_cot,
                                lut.func_ref_vs_cot_multi_pixel,
                                spectral.spectral_flux,
                                spectral.spectral_radiance],
                         ids=['build_scene', 'solve', 'run_transport_flight',
                              'run_transport', 'transport',
                              'quasi_radiance', 'make_mesh',
                              'gen_bispectral_lookup_table',
                              'func_ref_vs_cot',
                              'func_ref_vs_cot_multi_pixel', 'spectral_flux',
                              'spectral_radiance'])
def test_entry_points_default_to_the_card(fn):
    assert inspect.signature(fn).parameters['device'].default == 'cuda'


def test_build_scene_without_device_raises_without_a_card():
    """Leaving out ``device`` asks for the card: with none visible, PyTorch's
    CUDA initialisation raises; nothing carries on on the CPU."""
    code = ('import numpy as np\n'
            'from er3t_tpu_torch.pre.atm import atm_atmmod\n'
            'from er3t_tpu_torch.pre.abs import abs_synthetic\n'
            'from er3t_tpu_torch.rtm.scene import build_scene\n'
            'atm = atm_atmmod(np.linspace(0, 20, 11))\n'
            'build_scene(atm, abs_synthetic(650.0, atm, ng=4))\n'
            "print('ran')\n")
    proc = _python(code, CUDA_VISIBLE_DEVICES='')
    assert proc.returncode != 0
    assert 'ran' not in proc.stdout
    assert 'CUDA' in proc.stderr or 'cuda' in proc.stderr


def test_make_mesh_without_device_raises_without_a_card():
    """make_mesh() asks for every visible card: with none it raises, and
    nothing carries on with CPU ranks."""
    code = ('from er3t_tpu_torch.dist.mesh import make_mesh\n'
            'make_mesh()\n'
            "print('ran')\n")
    proc = _python(code, CUDA_VISIBLE_DEVICES='')
    assert proc.returncode != 0
    assert 'ran' not in proc.stdout
    assert 'no CUDA device' in proc.stderr


def test_chip_smoke_refuses_without_cuda():
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, 'chip_smoke.py')], cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES=''),
        capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert 'no CUDA device' in proc.stderr


def test_chip_drivers_refuses_without_cuda():
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, 'chip_drivers.py'), 'p03'],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO,
                           CUDA_VISIBLE_DEVICES=''),
        capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"name"' not in proc.stdout
    assert 'no CUDA device' in proc.stderr


def test_gather_probe_refuses_without_cuda():
    proc = subprocess.run(
        [sys.executable, '-m', 'er3t_tpu_torch.probes.gather_probe', 'all'],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO,
                           CUDA_VISIBLE_DEVICES=''),
        capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"probe"' not in proc.stdout
    assert 'no CUDA device' in proc.stderr

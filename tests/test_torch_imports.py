"""The port never imports JAX or the JAX package, its entry points run on
the card unless asked for the CPU, and neither chip_smoke.py nor the gather
probes have a CPU fallback."""

import inspect
import os
import subprocess
import sys

import pytest

from er3t_tpu_torch.rtm import mc_flight, scene, solver

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
                'er3t_tpu_torch.probes', 'er3t_tpu_torch.probes.gather',
                'er3t_tpu_torch.probes.gather_probe', 'chip_smoke')


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


@pytest.mark.parametrize('fn', [scene.build_scene, solver.solve,
                                mc_flight.run_transport_flight],
                         ids=['build_scene', 'solve', 'run_transport_flight'])
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


def test_chip_smoke_refuses_without_cuda():
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, 'chip_smoke.py')], cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES=''),
        capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
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

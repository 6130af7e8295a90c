"""The port never imports JAX, and neither chip_smoke.py nor the gather
probes have a CPU fallback."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_MODULES = ('er3t_tpu_torch', 'er3t_tpu_torch._build',
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
    code = ('import importlib, sys\n'
            f'for m in {PORT_MODULES!r}:\n'
            '    importlib.import_module(m)\n'
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'jaxlib', 'er3t_tpu.rtm')))\n"
            'assert not bad, bad\n'
            "print('clean')\n")
    proc = _python(code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == 'clean'


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

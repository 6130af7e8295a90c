"""Nothing the benchmark runs loads JAX or the JAX package, and the plain
references and the configurations' inputs builders load nothing of the
port.  Top-level module names are compared
whole: ``er3t_tpu_torch`` is the port, ``er3t_tpu`` the JAX package."""

import ast
import subprocess
import sys

import pytest

from conftest import ROOT

BENCH = ROOT / 'benchmark'
JAX_SIDE = {'jax', 'jaxlib', 'flax', 'er3t_tpu'}


def _top_imports(path):
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split('.')[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split('.')[0])
    return tops


def _sources(*parts):
    return [p for p in (BENCH.joinpath(*parts)).rglob('*.py')
            if 'tests' not in p.relative_to(BENCH).parts]


def test_no_source_imports_jax_or_the_jax_package():
    for p in _sources():
        assert not _top_imports(p) & JAX_SIDE, p


@pytest.mark.parametrize('part', ['reference', 'frozen', 'inputs'])
def test_reference_and_frozen_copies_import_nothing_of_the_port(part):
    for p in _sources(part):
        assert not _top_imports(p) & (JAX_SIDE | {'er3t_tpu_torch'}), p


def _in_subprocess(code):
    r = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                       capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout.strip().splitlines()[-1]


def test_a_run_loads_the_port_and_not_jax():
    code = (
        'import sys, time\n'
        'sys.path[:0] = [".", "benchmark/tests"]\n'
        'from conftest import tiny_cell\n'
        'from benchmark.lib import harness\n'
        'from benchmark.run import forbidden_modules\n'
        'harness.run_cell(tiny_cell("rad_les.run1e6"), 3, 0.1, False, "cpu",\n'
        '                 time.perf_counter())\n'
        'print(forbidden_modules(), "er3t_tpu_torch" in sys.modules)\n')
    assert _in_subprocess(code) == '[] True'


def test_the_reference_runs_without_the_port():
    code = (
        'import sys\n'
        'sys.path[:0] = [".", "benchmark/tests"]\n'
        'from conftest import tiny_cell\n'
        'from benchmark.lib.inputs import make_inputs\n'
        'from benchmark.reference import mc\n'
        'cell = tiny_cell("flux_les.run1e6")\n'
        'o = mc.optics(make_inputs(cell.config), "cpu")\n'
        'img, n = mc.run(o, 2000, 1, target="flux", batch=512, n_tallies=2)\n'
        'mods = {m.split(".")[0] for m in sys.modules}\n'
        'print(sorted(mods & {"jax", "jaxlib", "flax", "er3t_tpu",\n'
        '                     "er3t_tpu_torch"}), n)\n')
    assert _in_subprocess(code) == '[] [1000, 1000]'


def test_forbidden_names_are_compared_whole():
    from benchmark.run import forbidden_modules
    assert forbidden_modules(['er3t_tpu_torch', 'er3t_tpu_torch.rtm.solver',
                              'jaxtyping', 'flaxen', 'torch']) == []
    assert forbidden_modules(['er3t_tpu.rtm', 'jax.numpy', 'jaxlib',
                              'flax']) == ['er3t_tpu', 'flax', 'jax',
                                           'jaxlib']

"""Each configuration of BENCHMARK.json resolves to the inputs builder and
plain reference it names, and one that names none to the defaults:
``benchmark.lib.inputs.make_inputs`` and ``benchmark.reference.mc``."""

import json

from benchmark.lib import inputs, manifest
from benchmark.reference import mc

from conftest import ROOT


def _configs():
    man = json.loads((ROOT / 'BENCHMARK.json').read_text())
    return [json.loads((ROOT / c['file']).read_text())
            for c in man['configs']]


def test_a_configuration_takes_the_modules_it_names_else_the_defaults():
    named = 0
    for cfg in _configs():
        build = manifest.inputs_builder(ROOT, cfg)
        ref = manifest.reference_module(ROOT, cfg)
        if 'inputs' in cfg:
            named += 1
            want = ROOT / 'benchmark' / 'inputs' / f"{cfg['inputs']}.py"
            assert build.__code__.co_filename == str(want)
            assert build is not inputs.make_inputs
        else:
            assert build is inputs.make_inputs
        if 'reference' in cfg:
            want = ROOT / 'benchmark' / 'reference' / f"{cfg['reference']}.py"
            assert ref.__file__ == str(want)
            assert ref is not mc
        else:
            assert ref is mc
    assert 0 < named < len(_configs())

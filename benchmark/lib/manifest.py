"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) is its configuration file (the
manifest's ``file``), its traffic mix ``benchmark/traffic/<traffic>.json``
and its correctness settings ``benchmark/cells/<workload>.json``; a
per-layer metric is the reader ``benchmark/metrics/<metric>.py``.  A
configuration file may name its own inputs builder (``"inputs": "<name>"``,
``benchmark/inputs/<name>.py`` with ``make_inputs(config)``) and its own
plain reference (``"reference": "<name>"``, ``benchmark/reference/<name>.py``
with ``optics``, ``run`` and ``reduce`` as ``benchmark/reference/mc.py``);
without the key, ``benchmark.lib.inputs.make_inputs`` and
``benchmark.reference.mc``.  Adding a cell, a configuration or a metric adds
files and manifest entries, and edits nothing.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

__all__ = ['Cell', 'load_cell', 'metric_reader', 'inputs_builder',
           'reference_module']


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict           # the configuration file, as run
    traffic: dict          # the traffic mix
    check: dict            # what `correct` compares, and the limits
    end_to_end: list       # the manifest's end-to-end metrics of this cell
    per_layer: list        # the manifest's per-layer metrics of this cell
    root: Path             # the checkout


def _read(path):
    with open(path) as f:
        return json.load(f)


def _of_cell(metrics, name):
    return [m for m in metrics if name in m.get('workloads', [name])]


def load_cell(root, workload):
    """The cell ``workload`` of ``<root>/BENCHMARK.json``."""
    root = Path(root)
    man = _read(root / 'BENCHMARK.json')
    wl = {w['name']: w for w in man['workloads']}
    if workload not in wl:
        raise KeyError(f'no workload {workload!r} in BENCHMARK.json; '
                       f'known: {sorted(wl)}')
    w = wl[workload]
    cfg = {c['name']: c for c in man['configs']}[w['config']]
    bench = root / 'benchmark'
    return Cell(name=workload, chips=int(w['chips']),
                config=_read(root / cfg['file']),
                traffic=_read(bench / 'traffic' / f"{w['traffic']}.json"),
                check=_read(bench / 'cells' / f'{workload}.json'),
                end_to_end=_of_cell(man['end_to_end'], workload),
                per_layer=_of_cell(man['per_layer'], workload), root=root)


def _load(path, module_name):
    spec = importlib.util.spec_from_file_location(module_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(root, name):
    """The ``read(run)`` function of ``benchmark/metrics/<name>.py``."""
    path = Path(root) / 'benchmark' / 'metrics' / f'{name}.py'
    return _load(path, 'bench_metric_' + name.replace('.', '_')).read


def _of_config(root, folder, name):
    """``benchmark/<folder>/<name>.py``, loaded as a module of the package
    ``benchmark.<folder>`` (so its relative imports reach the frozen
    copies)."""
    path = Path(root) / 'benchmark' / folder / f'{name}.py'
    if not path.is_file():
        raise FileNotFoundError(f'no {folder} module {name!r}: {path}')
    return _load(path, f'benchmark.{folder}.{name}')


def inputs_builder(root, config):
    """The ``make_inputs(config)`` of the configuration dict ``config``."""
    if 'inputs' not in config:
        from .inputs import make_inputs
        return make_inputs
    return _of_config(root, 'inputs', config['inputs']).make_inputs


def reference_module(root, config):
    """The plain reference (``optics``, ``run``, ``reduce``) of the
    configuration dict ``config``."""
    if 'reference' not in config:
        from ..reference import mc
        return mc
    return _of_config(root, 'reference', config['reference'])

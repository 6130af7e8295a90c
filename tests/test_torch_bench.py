"""bench_torch.py and the measurement harnesses of scripts/*_torch.py
against their JAX sources: bench.py and scripts/tpu_{profile_ablate,
ablate2,var_budget,drain_ab,r5_knobs,tile_sweep,locality_ab,flux_kx}.py.

* bench_torch's scene equals bench.build()'s field by field, its
  ``_pixel_var_per_photon`` bench.py's bit for bit, and a CPU run of
  ``bench_torch.main`` at a tiny budget prints the keys of bench.py's
  result in the branch it takes (read from bench.py by ``ast``, so a drift
  in either shows; chip_smoke.BENCH_KEYS holds the same sets for the
  card);
* each harness makes the same runs as its source: every call to
  ``run_transport_flight`` is recorded in both packages by a stand-in that
  returns made-up tallies, and the two lists of (config, scene, photons,
  seed, spectral factors) must be equal, field for field and bit for bit.
  The scenes are shrunk to 12 x 12 columns in both packages (their cloud
  generator's other arguments are recorded and held equal too), so none
  of this runs Monte Carlo or a 480 x 480 build.

bench.py and the JAX scripts set ``JAX_COMPILATION_CACHE_DIR`` when they
are imported or loaded; here that happens only inside a test, after
``monkeypatch.setenv`` has pointed it at the test's ``tmp_path``, so the
environment that later tests and their subprocesses inherit is left as it
was (held by ``test_collection_leaves_the_environment_alone``).
"""

import ast
import dataclasses
import functools
import importlib.machinery
import importlib.util
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import jax

import bench_torch
import chip_smoke
from er3t_tpu.pre import cld as j_cld, pha as j_pha
from er3t_tpu.rtm import mc_flight as j_flight
from er3t_tpu_torch.pre import cld as t_cld, pha as t_pha
from er3t_tpu_torch.rtm import mc_flight as t_flight
from er3t_tpu_torch.rtm.solver import distribute_photon

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the harnesses: key -> (the JAX script, the port's, argv of a small run)
SCRIPTS = {
    'profile_ablate': ('tpu_profile_ablate', 'profile_ablate_torch', []),
    'ablate2': ('tpu_ablate2', 'ablate2_torch', []),
    'var_budget': ('tpu_var_budget', 'var_budget_torch', []),
    'drain_ab': ('tpu_drain_ab', 'drain_ab_torch', []),
    'r5_knobs': ('tpu_r5_knobs', 'r5_knobs_torch', []),
    'tile_sweep': ('tpu_tile_sweep', 'tile_sweep_torch', []),
    'tile_sweep_argv': ('tpu_tile_sweep', 'tile_sweep_torch', ['8', '24']),
    'locality_ab': ('tpu_locality_ab', 'locality_ab_torch', []),
    'flux_kx': ('tpu_flux_kx', 'flux_kx_torch', []),
}


@functools.lru_cache(maxsize=None)
def _mie(fn, wavelength, kw):
    return fn(wavelength, **dict(kw))


def _cached(fn):
    """``pha_mie_wc`` computing each table once per test process."""
    def mie(wavelength=650.0, **kw):
        return _mie(fn, wavelength, tuple(sorted(kw.items())))
    return mie


@pytest.fixture
def jax_cache(monkeypatch, tmp_path):
    """The JAX sources' compilation cache, pointed at this test's tmp_path
    and restored after it."""
    monkeypatch.setenv('JAX_COMPILATION_CACHE_DIR', str(tmp_path / 'jax_cache'))


@pytest.fixture
def bench(jax_cache):
    """bench.py (the JAX package's), imported inside the test."""
    import bench
    return bench


@pytest.fixture
def mie(monkeypatch):
    monkeypatch.setattr(j_pha, 'pha_mie_wc', _cached(j_pha.pha_mie_wc))
    monkeypatch.setattr(t_pha, 'pha_mie_wc', _cached(t_pha.pha_mie_wc))


def _host(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def test_bench_scene_equals_the_reference(bench, mie):
    ab_j, scn_j, st_j = bench.build()
    ab_t, scn_t, st_t = bench_torch.build('cpu')
    assert dataclasses.asdict(st_t) == dataclasses.asdict(st_j)
    assert scn_t._fields == scn_j._fields
    for f in scn_j._fields:
        a, b = np.asarray(getattr(scn_j, f)), getattr(scn_t, f).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    np.testing.assert_array_equal(ab_t.weight, ab_j.weight)
    assert ab_t.ng == ab_j.ng == 16


def test_pixel_var_per_photon_is_bench_py_bit_for_bit(bench):
    rng = np.random.default_rng(0)
    imgs = [rng.uniform(0, 1e-7, (7, 5)) for _ in range(8)]
    assert bench_torch._pixel_var_per_photon(imgs, 4_000_000) == \
        bench._pixel_var_per_photon(imgs, 4_000_000)


def bench_py_keys():
    """The key sets of bench.py's printed result in its two branches, read
    from its source: {'noise': ..., 'degraded': ...}."""
    tree = ast.parse(open(os.path.join(REPO, 'bench.py')).read())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == 'main')
    base, updates, flags = set(), [], set()
    for node in ast.walk(main):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict):
            tgt = node.targets[0]
            if isinstance(tgt, ast.Name) and tgt.id == 'out':
                base = {k.value for k in node.value.keys}
        elif isinstance(node, ast.Assign) and isinstance(
                node.targets[0], ast.Subscript) and isinstance(
                node.targets[0].value, ast.Name) \
                and node.targets[0].value.id == 'out':
            flags.add(node.targets[0].slice.value)
        elif isinstance(node, ast.Call) and isinstance(
                node.func, ast.Attribute) and node.func.attr == 'update' \
                and isinstance(node.func.value, ast.Name) \
                and node.func.value.id == 'out':
            updates.append({k.value for k in node.args[0].keys})
    assert base and len(updates) == 2 and flags == {'degraded'}
    return {'noise': base | updates[0], 'degraded': base | flags | updates[1]}


def test_chip_smoke_holds_bench_py_keys():
    """chip_smoke.py checks bench_torch's line on the card against these
    sets; they are bench.py's."""
    keys = bench_py_keys()
    assert {k: set(v) for k, v in chip_smoke.BENCH_KEYS.items()} == keys


def _small_bench(monkeypatch):
    """bench_torch.build on the 12 x 12, 4-g scene of the chip_smoke
    rehearsal; a clock that advances 1 s a reading (every chunk then takes
    the same time: all are clean); and run_transport_flight recording each
    call's (g-points, qmc_launch, batch, photons, seed, rad_w given) and
    running it at 1024 lanes (the run's own batch, 2^17, is recorded)."""
    from test_torch_chip_smoke import _small_scene
    _, ab, _, scene, st = _small_scene('cpu')
    monkeypatch.setattr(bench_torch, 'build', lambda device: (ab, scene, st))
    now = [0.0]

    def clock():
        now[0] += 1.0
        return now[0]
    monkeypatch.setattr(bench_torch, 'time', types.SimpleNamespace(time=clock))
    flights = []
    plain = t_flight.run_transport_flight

    def spy(scene, st, cfg, n, seed, device, **kw):
        flights.append((st.ng, cfg.qmc_launch, cfg.batch, int(n), int(seed),
                        kw.get('rad_w') is not None))
        return plain(scene, st, dataclasses.replace(cfg, batch=1024), n, seed,
                     device, **kw)
    monkeypatch.setattr(t_flight, 'run_transport_flight', spy)
    return ab, flights


TINY = dict(device='cpu', warmup=300, probe=600, chunk=600, chunk_min=600,
            chunk_max=600, target_seconds=1e9, repeats=2, n_noise=600,
            n_ind=800)


def test_bench_main_prints_bench_py_keys(monkeypatch, capsys):
    """Three clean chunks: the noise phase runs (both protocols), and the
    line has bench.py's keys of that branch."""
    ab, flights = _small_bench(monkeypatch)
    out = bench_torch.main(**TINY, max_chunks=3)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == out
    assert set(line) == bench_py_keys()['noise']
    assert line['healthy'] is True and len(line['chunk_rates']) == 3
    assert line['metric'] == 'noise_matched_photons_per_sec_per_chip'
    assert line['noise_var_ratio_indep_over_corr'] > 0
    # warm-up, probe, 3 chunks, 2 correlated repeats: the production
    # config; then 2 x ng one-g passes of the reference protocol
    corr = [(4, True, 1 << 17, n, s, True)
            for n, s in ((300, 0), (600, 1), (600, 2), (600, 3), (600, 4),
                         (600, 101), (600, 102))]
    dist = distribute_photon(800, ab.weight)
    indep = [(1, False, 1 << 17, int(dist[g]), 301 + 16 * k + g, False)
             for k in range(2) for g in range(ab.ng)]
    assert flights == corr + indep


def test_bench_without_three_clean_chunks_is_degraded(monkeypatch, capsys):
    """Two chunks: not healthy, so degraded, the noise phase skipped and the
    headline g-samples/s, as in bench.py."""
    _, flights = _small_bench(monkeypatch)
    out = bench_torch.main(**TINY, max_chunks=2)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == out and set(line) == bench_py_keys()['degraded']
    assert line['degraded'] is True and line['healthy'] is False
    assert line['metric'] == 'gpoint_photon_samples_per_sec_per_chip'
    assert line['value'] == line['g_samples_per_sec']
    assert [f[3] for f in flights] == [300, 600, 600, 600]   # no noise runs


# ---- the harnesses of scripts/ ----

def _load(name):
    full = os.path.join(REPO, 'scripts', name + '.py')
    loader = importlib.machinery.SourceFileLoader('script_' + name, full)
    mod = importlib.util.module_from_spec(
        importlib.util.spec_from_file_location('script_' + name, full,
                                               loader=loader))
    loader.exec_module(mod)
    return mod


class Recorder:
    """A stand-in for ``run_transport_flight`` that records each call and
    returns made-up tallies (numpy for the JAX package, tensors for the
    port), the same for the same call index in both."""

    def __init__(self, port):
        self.port, self.calls = port, []

    def __call__(self, scene, st, cfg, n, seed=0, device=None, rad_w=None,
                 flux_w=None):
        self.calls.append(dict(
            cfg=dataclasses.asdict(cfg), static=dataclasses.asdict(st),
            scene={f: _host(getattr(scene, f)) for f in scene._fields},
            n=int(n), seed=int(seed),
            rad_w=None if rad_w is None else _host(rad_w),
            flux_w=None if flux_w is None else _host(flux_w)))
        rng = np.random.default_rng(len(self.calls))
        ng = 1 if rad_w is not None else st.ng
        tal = dict(rad=rng.uniform(0.0, 1.0, (st.nx, st.ny, ng)),
                   flux=rng.uniform(0.0, 1.0, (1, 1, st.nz + 1, 3, 1)),
                   n_launched=np.int64(min(n, 1 << 22)),
                   n_steps=np.int64(300))
        if self.port:
            tal = {k: torch.from_numpy(np.asarray(v)) for k, v in tal.items()}
        return types.SimpleNamespace(**tal)


def _clock():
    now = [0.0]

    def time():
        now[0] += 0.5
        return now[0]
    return types.SimpleNamespace(time=time)


def _shrunk(fn, seen):
    """The cloud generator on 12 x 12 columns of 1 km; every call's other
    arguments recorded."""
    def gen(**kw):
        seen.append({k: v for k, v in kw.items()
                     if k not in ('nx', 'ny', 'dx', 'dy')})
        return fn(**{**kw, 'nx': 12, 'ny': 12, 'dx': 1.0, 'dy': 1.0})
    return gen


def _same(a, b, where):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _same(a[k], b[k], f'{where}.{k}')
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and np.array_equal(a, b), where
    else:
        assert a == b, where


@pytest.mark.parametrize('key', list(SCRIPTS))
def test_script_runs_equal_the_reference(key, jax_cache, mie, monkeypatch,
                                        capsys):
    """The harness makes the JAX script's runs: configs, scenes, photons,
    seeds and spectral factors, in the same order; its printed lines have
    the same shape."""
    j_name, t_name, argv = SCRIPTS[key]
    monkeypatch.syspath_prepend(os.path.join(REPO, 'scripts'))
    monkeypatch.setattr(jax.config, 'update', lambda *a, **kw: None)
    records, lines = [], []
    for name, port, flight, cld, extra in (
            (j_name, False, j_flight, j_cld, []),
            (t_name, True, t_flight, t_cld, ['--device', 'cpu'])):
        rec, seen = Recorder(port), []
        monkeypatch.setattr(flight, 'run_transport_flight', rec)
        monkeypatch.setattr(cld, 'cld_gen_hem', _shrunk(cld.cld_gen_hem, seen))
        mod = _load(name)
        mod.time = _clock()
        monkeypatch.setattr(sys, 'argv', [name] + argv + extra)
        mod.main()
        records.append((rec.calls, seen))
        lines.append([ln.split(':')[0] for ln in
                      capsys.readouterr().out.splitlines()])
    (ref, ref_cld), (got, got_cld) = records
    assert len(got) == len(ref) > 0
    for i, (g, r) in enumerate(zip(got, ref)):
        _same(g, r, f'{key} call {i}')
    assert got_cld == ref_cld and got_cld
    assert lines[1] == lines[0]


# the modules of tests/ that import bench.py or load the JAX scripts
BENCH_TEST_MODULES = ('test_torch_bench', 'test_torch_ablate',
                      'test_torch_chip_smoke_bench', 'test_torch_sweeps',
                      'test_torch_chip_smoke_sweeps')


def test_collection_leaves_the_environment_alone():
    """Importing these test modules, as pytest's collection does in every
    worker, sets no JAX_COMPILATION_CACHE_DIR: the subprocesses that later
    tests start would inherit it."""
    env = {k: v for k, v in os.environ.items()
           if k != 'JAX_COMPILATION_CACHE_DIR'}
    code = ('import os, sys; sys.path[:0] = sys.argv[1:3]; import conftest; '
            + '; '.join(f'import {m}' for m in BENCH_TEST_MODULES)
            + "; print(os.environ.get('JAX_COMPILATION_CACHE_DIR'))")
    out = subprocess.run(
        [sys.executable, '-c', code, REPO, os.path.join(REPO, 'tests')],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == 'None'

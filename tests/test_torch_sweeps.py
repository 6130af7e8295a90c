"""The sweep, A/B, scaling, drain and scatter harnesses of
scripts/*_torch.py against their JAX sources: scripts/tpu_{ab_sweep,
tile2_sweep,flux_ab,isolate_ab,pallas_ab,r3_sweep,r5_sweep}.py,
cam_importance_ab.py, cpu_scaling_bench.py, debug_decomp_drain.py and
tpu_{gather_probe4,scatter_bench,sorted_scatter}.py.

* Items 1-8 make the JAX script's runs: every call to
  ``run_transport_flight`` is recorded in both packages by a stand-in that
  returns made-up tallies of the run's shapes (tests/test_torch_bench.py's
  ``Recorder``, with flux tallies per column or domain-averaged, per-g or
  contracted, and the camera's image), and the two lists of (config,
  scene, photons, seed, rad_w, flux_w) must be equal field for field and
  bit for bit, the patched (isolate_ab) and binned (r5_sweep) phase
  tables among them, on 12 x 12 scenes.  With the same made-up tallies and
  the same stub clock both print the same lines, values included.
* Item 9 (scaling_bench_torch): a stand-in for ``transport_photon_parallel``
  and ``transport_decomp`` records the same mesh shapes, budgets, seeds and
  rad_w as cpu_scaling_bench.py's on the conftest's 8 virtual devices, and
  the printed JSON rows have the same keys.
* Item 10 (debug_decomp_drain_torch) runs on 2 CPU ranks at a tiny budget
  to its ``drained`` line through the dist layer's own ``migrate_dir``.
* Items 11-13 run on the CPU at tiny sizes: ``index_add_`` against
  ``np.add.at``, sorted against unsorted, and the printed keys and lines
  against the sources'.

chip_smoke.SWEEP_PREFIXES, the line prefixes that phase 14 of
chip_smoke.py holds the card's output to, are the JAX scripts' at their
defaults (held here).
"""

import ast
import dataclasses
import json
import os
import re
import sys
import types

import numpy as np
import pytest
import torch

import jax

import chip_smoke
from er3t_tpu.dist import decomp as j_decomp, photon as j_photon
from er3t_tpu.pre import cld as j_cld
from er3t_tpu.rtm import mc_flight as j_flight
from er3t_tpu_torch.dist import decomp as t_decomp, photon as t_photon
from er3t_tpu_torch.pre import cld as t_cld
from er3t_tpu_torch.rtm import mc_flight as t_flight
from test_torch_bench import (REPO, Recorder, _clock, _host, _load, _same,
                              _shrunk)
from test_torch_bench import jax_cache, mie  # noqa: F401  (the fixtures)

torch.set_num_threads(2)

# the harnesses: key -> (the JAX script, the port's, argv of a run)
SCRIPTS = {
    'ab_sweep': ('tpu_ab_sweep', 'ab_sweep_torch', []),
    'tile2_sweep': ('tpu_tile2_sweep', 'tile2_sweep_torch', []),
    'flux_ab': ('tpu_flux_ab', 'flux_ab_torch', []),
    'flux_ab_argv': ('tpu_flux_ab', 'flux_ab_torch', ['1e5']),
    'isolate_ab': ('tpu_isolate_ab', 'isolate_ab_torch', []),
    'isolate_ab_argv': ('tpu_isolate_ab', 'isolate_ab_torch', ['20']),
    'pallas_ab': ('tpu_pallas_ab', 'pallas_ab_torch', []),
    'r3_sweep': ('tpu_r3_sweep', 'r3_sweep_torch', []),
    'r5_sweep': ('tpu_r5_sweep', 'r5_sweep_torch', []),
    'r5_sweep_argv': ('tpu_r5_sweep', 'r5_sweep_torch', ['1e5', '2']),
    'cam_importance_ab': ('cam_importance_ab', 'cam_importance_ab_torch', []),
}
SCALING_ARGV = {'defaults': [],
                'argv': ['--base-photons', '4000', '--reps', '1',
                         '--devices', '1,2,4', '--strategies', 'decomp',
                         '--batch', '1024']}


class Tallies(Recorder):
    """Recorder's made-up tallies in the shapes of the run: the camera's
    image, and flux tallies per column or domain-averaged, per g or
    contracted with flux_w; pinned runs take their pinned steps."""

    def __call__(self, scene, st, cfg, n, seed=0, device=None, rad_w=None,
                 flux_w=None):
        tal = super().__call__(scene, st, cfg, n, seed, device, rad_w, flux_w)
        rng = np.random.default_rng(1000 + len(self.calls))
        ng_r = 1 if rad_w is not None else st.ng
        npix = cfg.cam_npix if cfg.sensor_type == 'camera' else None
        rad = rng.uniform(0.0, 1.0, (npix or st.nx, npix or st.ny, ng_r))
        cols = (st.nx, st.ny) if cfg.flux_per_column else (1, 1)
        ng_f = 1 if (flux_w is not None and cfg.flux_per_column) else st.ng
        flux = rng.uniform(0.0, 1.0, cols + (st.nz + 1, 3, ng_f))
        extra = dict(rad=rad, flux=flux,
                     n_steps=np.int64(cfg.max_events or 300))
        for k, v in extra.items():
            setattr(tal, k, torch.from_numpy(np.asarray(v)) if self.port
                    else v)
        return tal


def prefixes(lines):
    """The part of each printed line before its first ':'."""
    return sorted({ln.split(':')[0] for ln in lines})


def _run_pair(key, j_name, t_name, argv, monkeypatch, capsys, patch):
    """Runs the JAX script and the port's with ``patch(port)`` -> a list of
    recorders; returns [(records, clouds, lines)] for both."""
    monkeypatch.syspath_prepend(os.path.join(REPO, 'scripts'))
    monkeypatch.setattr(jax.config, 'update', lambda *a, **kw: None)
    out = []
    for name, port, cld, extra in ((j_name, False, j_cld, []),
                                   (t_name, True, t_cld, ['--device', 'cpu'])):
        seen = []
        recs = patch(port)
        monkeypatch.setattr(cld, 'cld_gen_hem', _shrunk(cld.cld_gen_hem, seen))
        mod = _load(name)
        mod.time = _clock()
        monkeypatch.setattr(sys, 'argv', [name] + argv + extra)
        mod.main()
        out.append(([r.calls for r in recs], seen,
                     capsys.readouterr().out.splitlines()))
    return out


def _same_lines(ref, got):
    """The same lines but the ``devices:`` line (the device differs)."""
    assert len(got) == len(ref)
    for r, g in zip(ref, got):
        if r.startswith('devices:'):
            assert g.startswith('devices:')
        else:
            assert g == r


def flight_pair(key, monkeypatch, capsys):
    j_name, t_name, argv = SCRIPTS[key]

    def patch(port):
        rec = Tallies(port)
        monkeypatch.setattr(t_flight if port else j_flight,
                            'run_transport_flight', rec)
        return [rec]
    return _run_pair(key, j_name, t_name, argv, monkeypatch, capsys, patch)


@pytest.mark.parametrize('key', list(SCRIPTS))
def test_sweep_runs_equal_the_reference(key, jax_cache, mie,  # noqa: F811
                                        monkeypatch, capsys):
    """The harness makes the JAX script's runs: configs, scenes (phase
    tables included), photons, seeds and spectral factors, in the same
    order, and prints the same lines."""
    (ref, ref_cld, ref_lines), (got, got_cld, got_lines) = flight_pair(
        key, monkeypatch, capsys)
    assert len(got[0]) == len(ref[0]) > 0
    for i, (g, r) in enumerate(zip(got[0], ref[0])):
        _same(g, r, f'{key} call {i}')
    assert got_cld == ref_cld and got_cld
    _same_lines(ref_lines, got_lines)


def test_isolate_ab_runs_the_large_tables_and_restores_the_builder(
        jax_cache, mie, monkeypatch, capsys):  # noqa: F811
    """isolate_ab's two scenes carry 2048 x 2048 and 8192 x 4096 tables
    (pt_p (4, 4096), pt_mu (2, 8192) on the large ones), and the scene
    builder's table function is the plain one again after the script."""
    import er3t_tpu_torch.pre.pha as P
    import er3t_tpu_torch.rtm.scene as S
    (_, _, _), (got, _, _) = flight_pair('isolate_ab_argv', monkeypatch,
                                         capsys)
    shapes = {(c['scene']['pt_p'].shape, c['scene']['pt_mu'].shape)
              for c in got[0]}
    assert shapes == {((4, 2048), (2, 2048)), ((4, 4096), (2, 8192))}
    assert S.build_phase_table is P.build_phase_table
    assert {c['cfg']['max_events'] for c in got[0]} == {20}


def test_r5_sweep_bins_the_tables(jax_cache, mie, monkeypatch,  # noqa: F811
                                  capsys):
    """r5_sweep's seven scenes: 2048, 1024 and 512 bins on both tables."""
    (_, _, _), (got, _, _) = flight_pair('r5_sweep_argv', monkeypatch, capsys)
    shapes = {(c['scene']['pt_p'].shape, c['scene']['pt_mu'].shape)
              for c in got[0]}
    assert shapes == {((4, b), (2, b)) for b in (2048, 1024, 512)}


def test_chip_smoke_holds_the_reference_prefixes(jax_cache, mie,  # noqa: F811
                                                 monkeypatch, capsys):
    """chip_smoke.SWEEP_PREFIXES are the prefixes of the JAX scripts'
    printed lines at their defaults, and the port's."""
    found = {}
    for key, (j_name, t_name, argv) in SCRIPTS.items():
        if argv:
            continue
        (_, _, ref), (_, _, got) = flight_pair(key, monkeypatch, capsys)
        assert prefixes(got) == prefixes(ref)
        found[key] = tuple(prefixes(ref))
    found['scaling'] = tuple(prefixes(scaling_pair(
        'defaults', monkeypatch, capsys)[0][2]))
    assert {k: tuple(v) for k, v in chip_smoke.SWEEP_PREFIXES.items()} \
        == found


# ---- item 9: the scaling bench over the dist layer ----

class DistRecorder:
    """A stand-in for ``transport_photon_parallel`` (``photon``) or
    ``transport_decomp`` that records each call (the strategy, config,
    scene, photons, mesh shape, seed, rad_w) and returns made-up tallies,
    the same for the same call index in both packages."""

    def __init__(self, port, strategy, calls):
        self.port, self.strategy, self.calls = port, strategy, calls

    def __call__(self, scene, st, cfg, n, mesh, seed=0, rad_w=None, **kw):
        assert not kw
        self.calls.append(dict(
            strategy=self.strategy, cfg=dataclasses.asdict(cfg),
            static=dataclasses.asdict(st),
            scene={f: _host(getattr(scene, f)) for f in scene._fields},
            n=int(n), mesh=dict(mesh.shape), seed=int(seed),
            rad_w=None if rad_w is None else _host(rad_w)))
        rng = np.random.default_rng(len(self.calls))
        tal = dict(rad=rng.uniform(0.0, 1.0, (st.nx, st.ny, 1)),
                   n_launched=np.int64(n), n_steps=np.int64(
                       40 * mesh.size + len(self.calls)),
                   lane_iters=np.float64(n * (10 + len(self.calls) % 7)))
        if self.port:
            tal = {k: torch.from_numpy(np.asarray(v)) for k, v in tal.items()}
        return types.SimpleNamespace(**tal)


def scaling_pair(key, monkeypatch, capsys):
    # the JAX script sets these when it is loaded; set here so that the
    # test restores them
    monkeypatch.setenv('JAX_PLATFORMS', 'cpu')
    monkeypatch.setenv('XLA_FLAGS', os.environ.get('XLA_FLAGS', ''))

    def patch(port):
        calls = []
        recs = []
        for mod, name, strat in (
                (t_photon if port else j_photon, 'transport_photon_parallel',
                 'photon'),
                (t_decomp if port else j_decomp, 'transport_decomp',
                 'decomp')):
            rec = DistRecorder(port, strat, calls)
            monkeypatch.setattr(mod, name, rec)
            recs.append(rec)
        return recs[:1]        # they share one list of calls
    return _run_pair(key, 'cpu_scaling_bench', 'scaling_bench_torch',
                     SCALING_ARGV[key], monkeypatch, capsys, patch)


@pytest.mark.parametrize('key', list(SCALING_ARGV))
def test_scaling_runs_equal_the_reference(key, jax_cache, mie,  # noqa: F811
                                          monkeypatch, capsys):
    """The same strategies, mesh shapes, budgets, seeds and rad_w as
    cpu_scaling_bench.py, on the same scene; the same lines, and JSON rows
    with the same keys and values."""
    (ref, ref_cld, ref_lines), (got, got_cld, got_lines) = scaling_pair(
        key, monkeypatch, capsys)
    assert len(got[0]) == len(ref[0]) > 0
    for i, (g, r) in enumerate(zip(got[0], ref[0])):
        _same(g, r, f'{key} call {i}')
    assert got_cld == ref_cld and got_cld
    _same_lines(ref_lines, got_lines)
    start = next(i for i, ln in enumerate(got_lines) if ln == '{')
    rows = json.loads('\n'.join(got_lines[start:]))
    keys = {'n_dev', 'photons', 'launched', 'wall_s', 'photons_per_s',
            'steps_total', 'slab_cols', 'work_per_photon', 'alg_efficiency',
            'wallclock_efficiency'}
    assert all(set(r) == keys for rs in rows.values() for r in rs)
    meshes = {(c['strategy'], c['mesh']['x'], c['mesh']['b'])
              for c in got[0]}
    n_devs = [int(v) for v in (SCALING_ARGV[key][5] if key == 'argv'
                               else '1,2,4,8').split(',')]
    strats = ('decomp',) if key == 'argv' else ('photon', 'decomp')
    assert meshes == {(s, n if s == 'decomp' else 1, 1 if s == 'decomp'
                       else n) for s in strats for n in n_devs}


def test_rank_devices_share_the_cards(monkeypatch):
    """--device cuda puts rank r on visible card r mod count; --device cpu
    asks make_mesh for CPU ranks."""
    mod = _load('scaling_bench_torch')
    assert mod.rank_devices(torch.device('cpu'), 4) == 'cpu'
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 3)
    assert mod.rank_devices(torch.device('cuda'), 5) == [
        torch.device('cuda', r % 3) for r in range(5)]


# ---- item 10: the decomposed-drain tracer ----

def test_drain_tracer_drains_through_migrate_dir(mie, monkeypatch,  # noqa: F811
                                                 capsys):
    """Two CPU ranks, 2000 photons, the scene's cloud cut to 12 x 12
    columns of 1 km: the tracer prints its rows and ``drained at round``,
    every photon launched; a spy on dist.decomp.migrate_dir sees two swaps
    a round, and each printed row's act + roam + froz equals the rank's
    live lanes after the round's last swap."""
    monkeypatch.syspath_prepend(os.path.join(REPO, 'scripts'))
    seen = []
    monkeypatch.setattr(t_cld, 'cld_gen_hem', _shrunk(t_cld.cld_gen_hem, seen))
    plain = t_decomp.migrate_dir
    swaps = []

    def spy(mesh, cs, *a, **kw):
        out = plain(mesh, cs, *a, **kw)
        swaps.append([int(c.alive.sum()) for c in out])
        return out
    monkeypatch.setattr(t_decomp, 'migrate_dir', spy)
    mod = _load('debug_decomp_drain_torch')
    monkeypatch.setattr(sys, 'argv', ['x', '2', '2000', '--device', 'cpu'])
    rec = mod.main()
    lines = capsys.readouterr().out.splitlines()
    r = rec['drained']
    assert r is not None and lines[-1] == f'drained at round {r}'
    assert rec['rounds'] == r + 1 and len(swaps) == 2 * (r + 1)
    assert rec['launched'] == [1000, 1000]
    assert rec['rank_steps'] == [16 * (r + 1)] * 2
    rows = [ln for ln in lines if ln.startswith('r=')]
    assert len(rows) == len(rec['rows']) > 0
    for row in rec['rows']:
        alive = swaps[2 * row['r'] + 1]
        for d in range(2):
            assert row['act'][d] + row['roam'][d] + row['froz'][d] \
                == alive[d]
    assert seen and seen[0]['seed'] == 7
    # the line format of the source's rows (debug_decomp_drain.py:160-166)
    assert re.fullmatch(r'r=\s*0 \| d0: act\s+\d+ roam\s+\d+ froz\s+\d+ '
                        r'launched\s+\d+ max_nscat \d+ \| d1: .*', rows[0])


def test_decomp_ranks_are_transport_decomps(monkeypatch):
    """rank_kernels and flight_step are the per-rank setup and step that
    transport_decomp runs: with them stepped by hand as transport_decomp
    steps them, one superstep and its swaps give the same carries."""
    from test_torch_chip_smoke import _small_scene
    from er3t_tpu_torch.dist.mesh import make_mesh
    from er3t_tpu_torch.rtm.mc import SolverConfig
    _, _, _, scene, st = _small_scene('cpu')
    cfg = SolverConfig(target='radiance', batch=256, n_scat_max=600,
                       tile_size=8)
    mesh = make_mesh(2, decomp=2, device='cpu')
    kept = []
    plain = t_decomp.migrate_dir

    def keep(mesh, cs, *a, **kw):
        out = plain(mesh, cs, *a, **kw)
        kept.append(out)
        return out
    monkeypatch.setattr(t_decomp, 'migrate_dir', keep)
    t_decomp.transport_decomp(scene, st, cfg, 1000, mesh, seed=5,
                              max_rounds=1, k_super=4)
    ranks = t_decomp.rank_kernels(scene, st, cfg, mesh, 500, 5,
                                  spawn_reserve=min(64 // 2, 256 // 8))
    cs = [kern.carry0(256) for kern, *_ in ranks]
    for k, (kern, gen, q_off) in enumerate(ranks):
        for _ in range(4):
            cs[k] = t_flight.flight_step(kern, gen, cs[k], q_off)
    k0 = ranks[0][0]
    for right in (True, False):
        cs = plain(mesh, cs, 64, k0.lx_loc, k0.zd_hi, k0.roam, right)
    for a, b in zip(kept[-1], cs):
        for f in ('x', 'y', 'z', 'alive', 'wsc', 'launched'):
            assert torch.equal(getattr(a, f), getattr(b, f)), f


# ---- items 11-13: the scatter probes ----

def source_templates(name):
    """Regexes of the lines that ``name``'s print calls make (formatted
    values match anything), read from the JAX script by ``ast``."""
    tree = ast.parse(open(os.path.join(REPO, 'scripts', name + '.py')).read())
    out = []
    for node in sorted((n for n in ast.walk(tree) if isinstance(n, ast.Call)
                        and getattr(n.func, 'id', None) == 'print'),
                       key=lambda n: n.lineno):
        arg = node.args[0]
        if isinstance(arg, ast.JoinedStr):
            out.append(''.join(re.escape(v.value)
                               if isinstance(v, ast.Constant) else '.*?'
                               for v in arg.values))
        elif isinstance(arg, ast.Constant):
            out.append(re.escape(arg.value) + (' .*' if node.args[1:]
                                               else ''))
    return out


def _probe4(monkeypatch, mod, b=256, k=3):
    monkeypatch.setattr(mod, 'B', b)
    monkeypatch.setattr(mod, 'K', k)


def report_keys(name):
    """The keyword sets of the ``report`` calls of a JAX probe script, read
    by ``ast``."""
    tree = ast.parse(open(os.path.join(REPO, 'scripts', name + '.py')).read())
    return [{k.arg for k in n.keywords} for n in sorted(
        (n for n in ast.walk(tree) if isinstance(n, ast.Call)
         and getattr(n.func, 'id', None) == 'report' and n.keywords),
        key=lambda n: n.lineno)]


def test_gather_probe4_keys_equal_the_source(jax_cache, monkeypatch,
                                             capsys):
    """One JSON line a probe in both, the same probes in the same order
    (the loops cut to 256 lanes and 3 steps); the port's keys are those of
    the source's report calls.  The source's own run reports an error for
    every probe: its jitted ``run(on)`` branches in Python on the traced
    flag, which this JAX refuses, so its keys are read from its source."""
    monkeypatch.syspath_prepend(os.path.join(REPO, 'scripts'))
    recs = []
    for name, extra in (('tpu_gather_probe4', []),
                        ('gather_probe4_torch', ['--device', 'cpu'])):
        mod = _load(name)
        _probe4(monkeypatch, mod)
        monkeypatch.setattr(sys, 'argv', [name] + extra)
        mod.main()
        recs.append([json.loads(ln)
                     for ln in capsys.readouterr().out.splitlines()])
    ref, got = recs
    assert [r['probe'] for r in got] == [r['probe'] for r in ref]
    assert len(got) == 7 and got[0]['probe'] == 'device'
    keys = report_keys('tpu_gather_probe4')
    assert len(keys) == 3 and {'kind'} in keys and {'error'} in keys
    measured, = (k for k in keys if k not in ({'kind'}, {'error'}))
    assert set(got[0]) == {'probe', 'kind'}
    assert all(set(r) == {'probe'} | measured for r in got[1:])
    assert all(np.isfinite(r['ns_per_row']) for r in got[1:])


@pytest.mark.parametrize('rows', [1, 4])
def test_gather_probe4_scatter_is_np_add_at(rows, monkeypatch):
    """The in-loop tally equals np.add.at of the loop's (indices, values)
    in float64, and the 'off' loop scatters nothing."""
    mod = _load('gather_probe4_torch')
    _probe4(monkeypatch, mod, b=512, k=4)
    keep = []
    tal, acc = mod.scatter_loop(1000, rows, 'cpu', True, keep=keep)
    ref = np.zeros(1000)
    for idx, u in keep:
        np.add.at(ref, idx.numpy(), u.numpy().astype(np.float64))
    assert len(keep) == 4 and keep[0][0].numel() == 512 * rows
    np.testing.assert_allclose(tal.numpy(), ref, rtol=1e-5, atol=1e-6)
    off, acc_off = mod.scatter_loop(1000, rows, 'cpu', False)
    assert not off.any() and torch.equal(acc, acc_off)


def test_scatter_bench_cases_are_np_add_at():
    """Each of the seven shapes adds what np.add.at adds (window16 the same
    elements as the source's 16-wide window), at a small size."""
    mod = _load('scatter_bench_torch')
    for name, fn, args in mod.cases('cpu', n=256, nrow_packed=300,
                                    nrow_small=40):
        ref = args[0].numpy().astype(np.float64).copy()
        if fn is mod.s_window16:
            t, i, isub, u = (a.numpy() for a in args)
            cols = isub[:, None] * 16 + np.arange(16)
            np.add.at(ref, (i[:, None], cols), u)
        else:
            np.add.at(ref, args[1].numpy(), args[2].numpy())
        out = fn(*args)
        np.testing.assert_allclose(out.numpy().reshape(ref.shape), ref,
                                   err_msg=name)


def test_scatter_bench_prints_the_source_lines(monkeypatch, capsys):
    """The seven names of tpu_scatter_bench.py's list, in order, each line
    in the form of its print call."""
    monkeypatch.syspath_prepend(os.path.join(REPO, 'scripts'))
    mod = _load('scatter_bench_torch')
    monkeypatch.setattr(sys, 'argv', ['x', '--scale', '1e-3', '--device',
                                      'cpu'])
    out = mod.main()
    lines = capsys.readouterr().out.splitlines()
    tree = ast.parse(open(os.path.join(REPO, 'scripts',
                                       'tpu_scatter_bench.py')).read())
    names = [e.elts[0].value for node in ast.walk(tree)
             if isinstance(node, ast.For) and isinstance(node.iter, ast.List)
             for e in node.iter.elts]
    assert list(out) == names and len(names) == 7
    devices_t, line_t = source_templates('tpu_scatter_bench')[:2]
    assert re.fullmatch(devices_t, lines[0])
    for name, ln in zip(names, lines[1:]):
        assert ln.startswith(name + ':') and re.fullmatch(line_t, ln), ln


def test_sorted_scatter_matches_and_prints_the_source_lines(monkeypatch,
                                                            capsys):
    """Sorted and unsorted loops add the same tallies; the lines have the
    source's form; a sorted loop that loses weights raises."""
    monkeypatch.syspath_prepend(os.path.join(REPO, 'scripts'))
    mod = _load('sorted_scatter_torch')
    a, _ = mod.loop(mod.b_unsorted, 300, 1000, 'cpu', k=5)
    b, _ = mod.loop(mod.b_sorted, 300, 1000, 'cpu', k=5)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5)
    assert float(a.sum()) > 0
    monkeypatch.setattr(sys, 'argv', ['x', '--scale', '1e-3', '--device',
                                      'cpu'])
    out = mod.main()
    lines = capsys.readouterr().out.splitlines()
    assert all(r['match'] for r in out.values()) and list(out) == [
        'image', 'flux']
    templates = source_templates('tpu_sorted_scatter')
    assert len(lines) == 1 + 2 * (len(templates) - 1)
    assert re.fullmatch(templates[0], lines[0])
    for i, ln in enumerate(lines[1:]):
        assert re.fullmatch(templates[1 + i % 5], ln), ln
    monkeypatch.setattr(mod, 'b_sorted', lambda tal, acc, idx, w: (
        tal.index_add_(0, idx[:-1], w[:-1]), acc))
    with pytest.raises(AssertionError, match='sorted tally'):
        mod.main()

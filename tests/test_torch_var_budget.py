"""scripts/var_budget_torch.py against scripts/tpu_var_budget.py on the CPU
at a cut size: the variance of the sensor-importance roulette
(``rr_value``) over that of the base config, in both packages.

Both scripts run unchanged (``--configs base,rr05``, the same seeds
500 + k) on the bench scene cut to 48 x 48 columns of 100 m (the cloud
generator's other arguments kept), each flight at 4096 lanes instead of
2^17.  The two packages draw different random numbers, so the runs agree
in distribution only.  The test prints both tables and holds the ratio
var(rr05) / var(base) of the port within a factor of 3 of the
reference's, and each config's mean radiance within 5 %.

    python -m pytest tests/test_torch_var_budget.py -q -s -m slow
"""

import dataclasses
import json
import sys

import numpy as np
import pytest
import torch

import jax

from er3t_tpu.pre import cld as j_cld, pha as j_pha
from er3t_tpu.rtm import mc_flight as j_flight
from er3t_tpu_torch.pre import cld as t_cld, pha as t_pha
from er3t_tpu_torch.rtm import mc_flight as t_flight
from test_torch_bench import _cached, _load

torch.set_num_threads(2)

NX = 48
LANES = 1 << 12
PHOTONS = 200_000
REPEATS = 12


def _cut(fn):
    """The cloud generator on NX x NX of the bench's 100 m columns."""
    def gen(**kw):
        return fn(**{**kw, 'nx': NX, 'ny': NX})
    return gen


def _at_lanes(fn, images):
    """``run_transport_flight`` at LANES lanes, each image per photon kept
    under its config's rr_value."""
    def run(scene, st, cfg, n, *a, **kw):
        tal = fn(scene, st, dataclasses.replace(cfg, batch=LANES), n, *a, **kw)
        img = np.asarray(tal.rad.cpu() if isinstance(tal.rad, torch.Tensor)
                         else tal.rad)[:, :, 0]
        images.setdefault(cfg.rr_value, []).append(
            img / max(int(tal.n_launched), 1))
        return tal
    return run


def _table(out):
    text = out.split('\n{', 1)[1]
    return json.loads('{' + text)


@pytest.mark.slow
def test_rr_variance_ratio_matches_the_reference(monkeypatch, tmp_path,
                                                 capsys):
    monkeypatch.setenv('JAX_COMPILATION_CACHE_DIR', str(tmp_path / 'jax'))
    monkeypatch.setattr(jax.config, 'update', lambda *a, **kw: None)
    argv = ['--configs', 'base,rr05', '--photons', str(PHOTONS),
            '--repeats', str(REPEATS)]
    tables, images = {}, {}
    for key, name, flight, cld, pha, extra in (
            ('jax', 'tpu_var_budget', j_flight, j_cld, j_pha, []),
            ('torch', 'var_budget_torch', t_flight, t_cld, t_pha,
             ['--device', 'cpu'])):
        images[key] = {}
        monkeypatch.setattr(pha, 'pha_mie_wc', _cached(pha.pha_mie_wc))
        monkeypatch.setattr(cld, 'cld_gen_hem', _cut(cld.cld_gen_hem))
        monkeypatch.setattr(flight, 'run_transport_flight', _at_lanes(
            flight.run_transport_flight, images[key]))
        monkeypatch.setattr(sys, 'argv', [name] + argv + extra)
        _load(name).main()
        tables[key] = _table(capsys.readouterr().out)
    ratio = {}
    with capsys.disabled():
        print(f'\n{NX} x {NX} columns, {LANES} lanes, {PHOTONS} photons x '
              f'{REPEATS} repeats, seeds 500-{499 + REPEATS}')
        for key, tab in tables.items():
            ratio[key] = tab['rr05']['var_mean'] / tab['base']['var_mean']
            for cfg in ('base', 'rr05'):
                d = tab[cfg]
                print(f'{key:5s} {cfg:4s} var {d["var_mean"]:.4g} (cloudy '
                      f'{d["var_cloudy"]:.4g} clear {d["var_clear"]:.4g}) '
                      f'mean {d["mean_rad"]:.5g}')
            # the ratio in each half of the seeds: how far it spreads
            halves = []
            for part in (slice(0, REPEATS // 2), slice(REPEATS // 2, None)):
                v = {rr: np.stack(imgs[part]).var(axis=0, ddof=1).mean()
                     for rr, imgs in images[key].items()}
                halves.append(v[0.05] / v[0.0])
            print(f'{key:5s} var(rr05)/var(base) {ratio[key]:.4g} '
                  f'(seed halves {halves[0]:.4g}, {halves[1]:.4g})')
    for cfg in ('base', 'rr05'):
        ref, got = tables['jax'][cfg]['mean_rad'], \
            tables['torch'][cfg]['mean_rad']
        assert abs(got / ref - 1) < 0.05, (cfg, got, ref)
    assert 1 / 3 < ratio['torch'] / ratio['jax'] < 3, ratio

"""The benchmark's arithmetic on known inputs: the noise metrics, K1's bytes
and operations against ``chip_smoke.pair_cost``, the trace reduction and
the numbers that decide ``correct``."""

import json
import types

import numpy as np
import pytest
import torch

from benchmark.frozen import measure
from benchmark.lib import compare, manifest
from benchmark.lib.trace import LOOP_LABEL, STEP_LABEL, reduce_trace

from conftest import ROOT


def _run(images, n, photons, window_s):
    return types.SimpleNamespace(noise_images=images, noise_photons=n,
                                 photons=photons, window_s=window_s)


def test_relvar_and_seconds_to_five_percent():
    # two 2 x 2 fields: per-pixel variances (ddof 1) 2, 0, 0, 8 -> mean 2.5
    a = np.array([[1.0, 2.0], [3.0, 4.0]])
    b = np.array([[3.0, 2.0], [3.0, 8.0]])
    run = _run([a, b], 1000, 2000, 4.0)
    mean = np.mean([a, b])
    rv = 2.5 * 1000 / mean ** 2
    got = manifest.metric_reader(ROOT, 'transport.relvar_per_photon')(run)
    assert got == pytest.approx(rv, rel=1e-12)
    s = manifest.metric_reader(ROOT, 's_to_5pct')(run)
    assert s == pytest.approx(rv / 0.05 ** 2 / (2000 / 4.0), rel=1e-12)
    assert manifest.metric_reader(ROOT, 's_to_5pct')(_run([a], 1, 1, 1.0)) \
        is None


def test_pair_cost_equals_chip_smoke_at_the_bench_shapes():
    import chip_smoke
    g = torch.Generator().manual_seed(3)
    b = 1 << 17
    pt_p = torch.rand((4, 2048), generator=g)
    pt_mu = torch.rand((2, 2048), generator=g) * 2 - 1
    apf = torch.randint(0, 2, (b,), generator=g, dtype=torch.int32)
    row_e = apf + 2 * torch.randint(0, 2, (b,), generator=g,
                                    dtype=torch.int32)
    mu = torch.rand(b, generator=g) * 2 - 1
    u = torch.rand(b, generator=g)
    got = measure.pair_cost(apf, row_e, mu, u, pt_p, pt_mu)
    assert got == chip_smoke.pair_cost(apf, row_e, mu, u, pt_p, pt_mu)
    nbytes, ops = got
    assert ops == 6 * b and 24 * b < nbytes <= 24 * b + 4 * 6 * 2048
    t, by = measure.bound(got)
    assert by == 'bytes' and t == pytest.approx(nbytes / 3.35e12)
    ms, by_ref = chip_smoke.bound(got)
    assert ms == pytest.approx(1e3 * t) and by_ref == by


def test_trace_reduction_on_a_made_up_trace(tmp_path):
    """Two steps (0-13, 25-35 us issued); kernels 0-10 and 12-15, 30-40 after
    a gap in the loop; a copy 41-42."""
    ev = [dict(ph='X', cat='user_annotation', name='bench.step', ts=0, dur=13),
          dict(ph='X', cat='user_annotation', name='bench.step', ts=25,
               dur=10),
          dict(ph='X', cat='kernel', name='phase_pair_kernel', ts=0, dur=10),
          dict(ph='X', cat='kernel', name='add', ts=12, dur=3),
          dict(ph='X', cat='kernel', name='phase_pair_kernel', ts=30, dur=10),
          dict(ph='X', cat='gpu_memcpy', name='Memcpy DtoH', ts=41, dur=1)]
    p = tmp_path / 't.json'
    p.write_text(json.dumps({'traceEvents': ev}))
    t = reduce_trace(str(p))
    assert not p.exists()
    us = 1e-6
    assert t['window_s'] == pytest.approx(42 * us)
    assert t['busy_s'] == pytest.approx(24 * us)
    assert t['n_steps'] == 2 and t['n_kernels'] == 3
    assert t['kernel_s'] == pytest.approx(23 * us)
    assert t['k1_mean_s'] == pytest.approx(10 * us)
    gaps = dict(t['idle_gaps'])
    assert gaps[STEP_LABEL] == pytest.approx(2 * us)        # 10-12 in step 1
    assert gaps[LOOP_LABEL] == pytest.approx(16 * us)       # 15-30, 40-41
    assert t['device_ops'][0] == ['phase_pair_kernel', pytest.approx(20 * us)]


def test_numbers_of_equal_and_of_shifted_fields():
    rng = np.random.default_rng(5)
    truth = np.zeros((40, 30))
    truth[5:15, 3:20] = 4.0
    truth += 1.0
    fields = [{'name': 'rad', 'key': 'rad'}]

    def fields_of(n, scale):
        return [truth + rng.normal(0, scale, truth.shape) for _ in range(n)]
    ref = {'rad': fields_of(8, 0.5)}
    good = compare.numbers({'rad': fields_of(4, 0.5)}, 4 * 1000, ref, 1000,
                           fields, 0)
    assert good['photons_missing'] == 0.0
    assert 0.5 < good['rad.strip_z_rms'] < 2.0
    moved = compare.numbers(
        {'rad': [np.roll(f, 7, axis=0) for f in fields_of(4, 0.5)]},
        4 * 1000, ref, 1000, fields, 0)
    assert moved['rad.strip_z_rms'] > 10.0
    scaled = compare.numbers({'rad': [1.2 * f for f in fields_of(4, 0.5)]},
                             4 * 1000, ref, 1000, fields, 0)
    assert scaled['rad.strip_z_rms'] > 5.0
    ok, rows = compare.judge(good, {'photons_missing': 0,
                                    'rad.strip_z_rms': 3.0})
    assert ok and [r[0] for r in rows] == ['photons_missing',
                                           'rad.strip_z_rms']
    assert not compare.judge(moved, {'rad.strip_z_rms': 3.0})[0]
    assert not compare.judge({'x': float('nan')}, {'x': 1.0})[0]


def test_domain_mean_sees_a_scale_error_that_the_strips_miss():
    """A 480 x 480 field at a radiance cell's noise (per-pixel variance
    1.5e6 per photon): four requests of 1e6 photons, a reference of 16
    batches of 2.5e5.  A scale error of 2 % leaves the strips near one
    error, where the domain mean reads about eleven."""
    rng = np.random.default_rng(11)
    fields = [{'name': 'rad', 'key': 'rad'}]
    var = 1.5e6

    def images(k, n, scale):
        return [scale + rng.normal(0.0, np.sqrt(var / n), (480, 480))
                for _ in range(k)]
    ref = {'rad': images(16, 2.5e5, 1.0)}
    good = compare.numbers({'rad': images(4, 1e6, 1.0)}, 4e6, ref, 2.5e5,
                           fields, 0)
    off = compare.numbers({'rad': images(4, 1e6, 1.02)}, 4e6, ref, 2.5e5,
                          fields, 0)
    assert good['rad.mean_z'] < 3.0
    assert off['rad.strip_z_rms'] < 1.6
    assert off['rad.mean_z'] > 6.0


def test_photons_cut_per_million_asked():
    fields = [{'name': 'rad', 'key': 'rad'}]
    img = [np.full((4, 4), 1.0 + 0.01 * i) for i in range(4)]
    v = compare.numbers({'rad': img[1:3]}, 2e6, {'rad': img}, 1000, fields,
                        0, photons_cut=37)
    assert v['photons_cut_ppm'] == pytest.approx(18.5)
    assert v['rad.mean_z'] == pytest.approx(0.0, abs=1e-9)

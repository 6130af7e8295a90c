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


def _limits(workload):
    return json.loads((ROOT / 'benchmark' / 'cells'
                       / f'{workload}.json').read_text())['limits']


def _draws(rng, truth, k, n, var):
    """``k`` fields of ``n`` photons each about ``truth``, at a per-photon
    variance ``var`` a pixel."""
    return [truth + rng.normal(0.0, np.sqrt(var / n), np.shape(truth))
            for _ in range(k)]


def test_an_image_is_compared_by_the_same_arithmetic_as_before():
    """A field with no NaN whose image has both sides above 1: strips and
    domain mean by exactly the arithmetic that the cells were calibrated
    with, bit for bit."""
    rng = np.random.default_rng(2)
    truth = 1.0 + rng.random((48, 40))
    prog, ref = _draws(rng, truth, 3, 1e4, 2.0), _draws(rng, truth, 8, 5e3,
                                                        2.0)
    got = compare.numbers({'f': prog}, 3e4, {'f': ref}, 5e3,
                          [{'name': 'f', 'key': 'f'}], 0)
    p, rb = np.mean(prog, axis=0), np.stack(ref)

    def strips(a):
        return np.concatenate([a.mean(axis=1), a.mean(axis=0)])
    rs = np.stack([strips(b) for b in rb])
    z = (strips(p) - rs.mean(axis=0)) / np.sqrt(
        rs.var(axis=0, ddof=1) * 5e3 * (1 / 3e4 + 1 / 4e4))
    m = rb.mean(axis=(1, 2))
    zm = (p.mean() - m.mean()) / np.sqrt(m.var(ddof=1) * 5e3
                                         * (1 / 3e4 + 1 / 4e4))
    assert got['f.strip_z_rms'] == float(np.sqrt(np.mean(z ** 2)))
    assert got['f.mean_z'] == float(abs(zm))
    assert set(got) == {'photons_missing', 'photons_cut_ppm', 'f.strip_z_rms',
                        'f.mean_z'}


def test_domain_fields_are_averaged_and_read_by_their_mean():
    """The program's domain-average tally, a (1, 1, Nz+1) field, against
    the reference's per-column crossings averaged per batch: only
    ``mean_z``, under the heating-rate cell's limit when sound and above
    it with a 5 % scale error."""
    rng = np.random.default_rng(3)
    lim = _limits('flux_les.hr1e6')
    field = [{'name': 'f_down_sfc', 'key': 'f_down', 'level': 0,
              'domain': True}]
    col = 1.0 + rng.random((24, 20, 5))
    ref = [compare.field_images({'f_down': c}, field)['f_down_sfc']
           for c in _draws(rng, col, 16, 2.5e5, 30.0)]
    assert all(a.shape == (1, 1) for a in ref)

    def prog(scale):
        dom = col.mean(axis=(0, 1), keepdims=True) * scale
        return [compare.field_images({'f_down': d}, field)['f_down_sfc']
                for d in _draws(rng, dom, 4, 1e6, 1.0)]
    good = compare.numbers({'f_down_sfc': prog(1.0)}, 4e6,
                           {'f_down_sfc': ref}, 2.5e5, field, 0)
    off = compare.numbers({'f_down_sfc': prog(1.05)}, 4e6,
                          {'f_down_sfc': ref}, 2.5e5, field, 0)
    assert 'f_down_sfc.strip_z_rms' not in good
    assert good['f_down_sfc.mean_z'] < lim['f_down_sfc.mean_z']
    assert off['f_down_sfc.mean_z'] > lim['f_down_sfc.mean_z']


def test_a_profile_is_read_entry_by_entry_and_by_its_mean():
    """A heating-rate profile (23,) at about the reference's noise at the
    cell's size (0.3 % a layer in a batch of 2.5e5 photons):
    ``profile_z_rms`` and ``mean_z`` under the heating-rate cell's limits
    when sound; a 5 % scale error reads above ``mean_z``'s, a profile
    shifted by one layer, or 5 % of one layer's absorption moved into the
    next (the mean kept), above ``profile_z_rms``'s."""
    rng = np.random.default_rng(4)
    lim = _limits('flux_les.hr1e6')
    truth = np.linspace(3e-4, 2e-3, 23) + 1e-4 * np.sin(np.arange(23))
    var = (0.003 * truth) ** 2 * 2.5e5
    fields = [{'name': 'hr', 'key': 'hr'}]
    ref = {'hr': _draws(rng, truth, 16, 2.5e5, var)}

    def numbers(prof):
        return compare.numbers({'hr': _draws(rng, prof, 4, 1e6, var)}, 4e6,
                               ref, 2.5e5, fields, 0)
    good, off = numbers(truth), numbers(1.05 * truth)
    shifted = numbers(np.roll(truth, 1))
    moved = truth.copy()
    moved[[11, 12]] += np.array([-0.05, 0.05]) * truth[11]
    moved = numbers(moved)
    assert set(good) == {'photons_missing', 'photons_cut_ppm',
                         'hr.profile_z_rms', 'hr.mean_z'}
    assert good['hr.profile_z_rms'] < lim['hr.profile_z_rms']
    assert good['hr.mean_z'] < lim['hr.mean_z']
    assert off['hr.mean_z'] > lim['hr.mean_z']
    assert shifted['hr.profile_z_rms'] > lim['hr.profile_z_rms']
    assert moved['hr.mean_z'] < lim['hr.mean_z']
    assert moved['hr.profile_z_rms'] > lim['hr.profile_z_rms']


def test_nan_pixels_are_left_out_of_strips_and_means():
    """A fisheye image, NaN outside its circle on both sides: finite
    numbers under the radiance cell's strip limit when sound; a 5 % scale
    error reads above it."""
    rng = np.random.default_rng(6)
    lim = _limits('rad_les.run1e6')['rad.strip_z_rms']
    n = 64
    yy, xx = np.mgrid[:n, :n] + 0.5
    out = np.hypot(xx - n / 2, yy - n / 2) > n / 2
    truth = 1.0 + 0.5 * np.cos(xx / 9.0) * np.sin(yy / 7.0)
    fields = [{'name': 'rad', 'key': 'rad'}]

    def images(k, photons, scale):
        return [np.where(out, np.nan, a)
                for a in _draws(rng, scale * truth, k, photons, 4.0)]
    ref = {'rad': images(16, 2.5e5, 1.0)}
    good = compare.numbers({'rad': images(4, 1e6, 1.0)}, 4e6, ref, 2.5e5,
                           fields, 0)
    off = compare.numbers({'rad': images(4, 1e6, 1.05)}, 4e6, ref, 2.5e5,
                          fields, 0)
    assert np.isfinite(good['rad.strip_z_rms'])
    assert np.isfinite(good['rad.mean_z'])
    assert good['rad.strip_z_rms'] < lim
    assert off['rad.strip_z_rms'] > lim


def _flat(shape, masked):
    """A flat field of ``shape`` (so that dropping a pixel biases nothing),
    NaN outside a centred circle where ``masked``."""
    a = np.ones(shape)
    if masked:
        yy, xx = np.mgrid[:shape[0], :shape[1]] + 0.5
        a[np.hypot(xx - shape[1] / 2, yy - shape[0] / 2) > shape[0] / 2] = \
            np.nan
    return a


@pytest.mark.parametrize('kind', ['masked', 'image', 'domain', 'profile'])
def test_a_program_nan_where_the_reference_has_a_number_fails(kind):
    """One NaN in one of the program's requests, where the reference has a
    number: every number of that field is NaN, and ``judge`` fails it;
    the same field without the NaN passes.  Flat fields, so that leaving
    one pixel out could not move a strip or a mean by itself."""
    rng = np.random.default_rng(7)
    if kind == 'profile':
        truth, spot = np.linspace(1.0, 2.0, 23), (11,)
        fields = [{'name': 'hr', 'key': 'hr'}]
    elif kind == 'domain':
        truth, spot = _flat((24, 20, 5), False), (12, 10, 0)
        fields = [{'name': 'hr', 'key': 'f', 'level': 0, 'domain': True}]
    else:
        truth, spot = _flat((64, 64), kind == 'masked'), (32, 32)
        fields = [{'name': 'hr', 'key': 'hr'}]

    def draws(k, photons):
        out = []
        for a in _draws(rng, truth, k, photons, 4.0):
            if kind == 'domain':
                a = compare.field_images({'f': a}, fields)['hr']
            out.append(a)
        return out
    ref = {'hr': draws(16, 2.5e5)}
    sound = draws(4, 1e6)
    holed = [a.copy() for a in sound]
    if kind == 'domain':
        col = _draws(rng, truth, 1, 1e6, 4.0)[0]
        col[spot] = np.nan
        holed[0] = compare.field_images({'f': col}, fields)['hr']
    else:
        holed[0][spot] = np.nan
    good = compare.numbers({'hr': sound}, 4e6, ref, 2.5e5, fields, 0)
    bad = compare.numbers({'hr': holed}, 4e6, ref, 2.5e5, fields, 0)
    limits = {k: 6.0 for k in good if k.startswith('hr.')}
    assert limits and compare.judge(good, limits)[0]
    assert all(np.isnan(bad[k]) for k in limits)
    assert not compare.judge(bad, limits)[0]

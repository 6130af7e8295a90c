"""The plain reference: the direct beam of a clear column against its closed
form, and the low-precision control failing the cell's check."""

import dataclasses

import numpy as np
import pytest
import torch

from benchmark.frozen import out as fout
from benchmark.lib import compare, harness
from benchmark.lib.inputs import make_inputs
from benchmark.reference import mc

from conftest import tiny_cell


def test_direct_beam_through_a_clear_column():
    """f_down_direct at the surface = mu0 sum_g factor_g
    exp(-(tau_Rayleigh + tau_gas,g) / mu0), the launched photons that reach
    the surface unscattered; within 4 sigma of the binomial count."""
    cell = tiny_cell('flux_les.run1e6')
    inp = dataclasses.replace(make_inputs(cell.config), cld=None, pha=None)
    o = mc.optics(inp, 'cpu')
    n = 40000
    img, launched = mc.run(o, n, 99, target='flux', batch=1 << 14)
    assert launched == [n]
    got = mc.reduce(o, img[0], n, inp.abs_coef,
                    'flux')['f_down_direct'][0, 0, 0]
    mu0 = np.cos(np.deg2rad(cell.config['solve']['solar_zenith_angle']))
    tau_ray = float((o.sig_ray.double() * torch.diff(o.z_lev.double())).sum())
    tau_gas = inp.abs_coef.abso_coef.sum(axis=0)
    fac = fout.spectral_factors(inp.abs_coef, nz_out=o.nz + 1)[0][0]
    t = np.exp(-(tau_ray + tau_gas) / mu0)
    want = mu0 * float(np.sum(fac * t))
    # each photon reaches the surface direct with probability exp(-tau_ray/mu0)
    # and then carries the weights t_g / exp(-tau_ray/mu0)
    p = np.exp(-tau_ray / mu0)
    sigma = want * np.sqrt((1 - p) / (p * n))
    assert abs(got - want) < 4 * sigma
    # and the domain is clear: nothing diffuse reaches the surface direct
    assert got < mu0 * float(np.sum(fac))


def test_bfloat16_control_fails_the_radiance_check():
    """The reference in bfloat16 in the program's place, on the cell's
    480 x 480 grid at a test budget (HG phase function), fails the cell's
    limits against the float32 reference: bfloat16 x and y hold 256 m
    steps past 32.8 km, so whole pixel columns get no deposit."""
    cell = tiny_cell('rad_les.run1e6')
    cell.config['cloud'].update(nx=480, ny=480, radii=[0.5, 1.0, 2.0])
    prep = harness.Prep(cell=cell, inputs=make_inputs(cell.config),
                        kw={'device': 'cpu'}, n_asked=25000,
                        target='radiance', solver=None, flight=None)
    cell.check.update(reference_photons=100000, reference_lanes=1 << 16)
    # at this budget (a few photons a pixel) float32 against float32 reads
    # about 2.1 and the control about 5.4
    cell.check['limits']['rad.strip_z_rms'] = 3.0
    ref, n_b = harness.reference(prep, 5)
    ctl, _ = harness.reference(prep, 12, dtype=torch.bfloat16,
                               n_photons=100000, batches=4)
    ok, rows = harness.judge(prep, ctl, 100000, 0, 0, ref, n_b)
    limits = dict((k, lim) for k, _, lim in rows)
    values = dict((k, v) for k, v, _ in rows)
    assert not ok
    assert values['rad.strip_z_rms'] > limits['rad.strip_z_rms']
    # the same check passes the float32 reference against itself
    again, _ = harness.reference(prep, 13, n_photons=100000, batches=4)
    assert harness.judge(prep, again, 100000, 0, 0, ref, n_b)[0]


def test_heating_rate_of_a_purely_absorbing_column_is_its_closed_form():
    """Gas absorption alone (no Rayleigh, no cloud) over a black surface:
    every photon falls straight through, so each layer absorbs, per
    g-point, mu0 F0_g (exp(-tau_top,g / mu0) - exp(-tau_bottom,g / mu0)),
    tau the gas optical depth above a level.  The reference's ``hr`` times
    each layer's air heat capacity, both worked out here, equals it; the
    top level's ``f_down`` is the incoming beam.  In float64: the test
    column is one pixel, and 20000 equal crossings summed into it in
    float32 round by up to 3e-4 of the incoming flux, as much as a thin
    layer absorbs (the cell's tallies spread over 480 x 480 columns).
    Float64 meets the closed form to 1e-4 of each layer's share."""
    cell = tiny_cell('flux_les.hr1e6')
    inp = dataclasses.replace(make_inputs(cell.config), cld=None, pha=None)
    o = mc.optics(inp, 'cpu', dtype=torch.float64)
    o.sig_ray = torch.zeros_like(o.sig_ray)
    o.ray_up = torch.zeros_like(o.ray_up)
    o.sig_maj = torch.full_like(o.sig_maj, 1e-12)
    o.albedo = 0.0
    n = 20000
    img, launched = mc.run(o, n, 17, target='heating_rate', batch=1 << 14)
    assert launched == [n]
    red = mc.reduce(o, img[0], n, inp.abs_coef, 'heating_rate')
    lay = inp.atm.lay
    heat_cap = (lay.pressure * 100.0 / (287.0 * lay.temperature) * 1004.0
                * lay.thickness * 1000.0)
    absorbed = red['hr'] * heat_cap / 86400.0
    tau = np.concatenate([np.cumsum(inp.abs_coef.abso_coef[::-1],
                                    axis=0)[::-1],
                          np.zeros((1, o.ng))])                # (Nz+1, Ng)
    fac = fout.spectral_factors(inp.abs_coef, nz_out=o.nz + 1)[0]
    down = o.mu0 * (fac * np.exp(-tau / o.mu0)).sum(axis=1)   # (Nz+1,)
    incoming = o.mu0 * fout.spectral_factors(inp.abs_coef)[1]
    assert red['hr'].shape == (o.nz,)
    assert red['f_down'].mean(axis=(0, 1))[-1] == pytest.approx(incoming,
                                                                 rel=1e-6)
    np.testing.assert_allclose(absorbed, down[1:] - down[:-1], rtol=1e-3)
    assert (absorbed > 0).all()


@pytest.mark.parametrize('target', ['radiance', 'flux', 'heating_rate'])
def test_reference_is_seeded(target):
    cell = tiny_cell({'radiance': 'rad_les.run1e6', 'flux': 'flux_les.run1e6',
                      'heating_rate': 'flux_les.hr1e6'}[target])
    inp = make_inputs(cell.config)
    o = mc.optics(inp, 'cpu')
    a, na = mc.run(o, 3000, 7, target=target, batch=1024, n_tallies=3)
    b, nb = mc.run(o, 3000, 7, target=target, batch=1024, n_tallies=3)
    c, _ = mc.run(o, 3000, 8, target=target, batch=1024, n_tallies=3)
    assert na == nb == [1000, 1000, 1000]
    assert torch.equal(a, b) and not torch.equal(a, c)
    f = compare.field_images(mc.reduce(o, a[2], na[2], inp.abs_coef, target),
                             cell.check['fields'])
    assert all(np.isfinite(v).all() and v.mean() > 0 for v in f.values())

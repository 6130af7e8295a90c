"""The OCO-2 A-band ocean configuration (``oco2_o2a768``) at a CPU size:
the port's ``solve`` against the benchmark's plain reference of that
configuration (``benchmark/reference/oco2_o2a768.py``); that reference
against ``benchmark/reference/mc.py`` on a Lambertian surface; its Cox-Munk
model against closed forms; and the flight kernel's surface-branch and
tile-clamp counters."""

import copy
import dataclasses
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.frozen import sfc as frozen_sfc
from benchmark.lib import compare
from benchmark.lib.inputs import Inputs
from benchmark.reference import mc as mc_ref
from benchmark.reference import oco2_o2a768 as ocean_ref
from er3t_tpu_torch.rtm import mc_flight, solver
from er3t_tpu_torch.rtm.mc import SolverConfig
from er3t_tpu_torch.rtm.out import spectral_factors
from er3t_tpu_torch.rtm.scene import build_scene
from er3t_tpu_torch.util import trace

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
F64 = torch.float64


def _small_inputs(surface=None):
    """The configuration at 24 x 24 columns: its atmosphere, its
    cld_gen_cop cloud in two layers (1.5-2.5 km), 4 g-points of which the
    last is made strongly absorbing (column optical depth ~16), the HG
    phase function in place of the Mie tables, tile size 8, and the ocean
    (or ``surface``)."""
    from benchmark.inputs import oco2_o2a768 as ocean_inputs
    cfg = json.loads((ROOT / 'benchmark' / 'configs'
                      / 'oco2_o2a768.json').read_text())
    cfg['cloud'].update(nx=24, ny=24)
    cfg['cloud']['map'].update(disks=5)
    cfg.update(ng=4, mie=None)
    cfg['solve']['tile_size'] = 8
    inp = ocean_inputs.make_inputs(cfg)
    k = inp.abs_coef.abso_coef.copy()
    k[:, -1] *= 30.0
    inp = dataclasses.replace(
        inp, abs_coef=dataclasses.replace(inp.abs_coef, abso_coef=k))
    if surface is not None:
        inp = dataclasses.replace(inp, solve_objects={'surface': surface})
    return inp


def _reference(inp, n, seed, batches, module=ocean_ref):
    o = module.optics(inp, 'cpu')
    img, counts = module.run(o, n, seed, n_tallies=batches, batch=1 << 16)
    return [module.reduce(o, img[k], counts[k], inp.abs_coef,
                          'radiance')['rad'] for k in range(batches)]


def test_solve_agrees_with_the_ocean_reference():
    """3e5 photons a side.  Limits: the 48 strip z-scores of two unbiased
    estimators have an RMS near 1 (1.01 here; 1.07-1.09 on three other
    pairs of seeds), so 2.0 leaves room for the noise; the domain mean is
    one z-score (0.07 here; 0.10-0.81 on the other seeds), held to 3.5.
    The glint toward the sensor scaled by 1.3 in the port reads 4.58 on
    the strips and 3.15 on the mean."""
    inp = _small_inputs()
    n = 300_000
    ref = _reference(inp, n, 5, 16)
    res = solver.solve(atm=inp.atm, abs_coef=inp.abs_coef, cld=inp.cld,
                       pha=None, **inp.solve_kw, **inp.solve_objects,
                       target='radiance', photons=n, n_run=1, seed=3,
                       batch=1 << 15, device='cpu')
    assert res.n_photon_effective == n
    v = compare.numbers({'rad': [res.data['rad']]}, n, {'rad': ref}, n / 16,
                        [{'name': 'rad', 'key': 'rad'}], 0)
    assert v['rad.strip_z_rms'] < 2.0, v
    assert v['rad.mean_z'] < 3.5, v


def test_reference_on_a_lambertian_surface_agrees_with_mc():
    """The same scene over a Lambertian surface of albedo 0.06: both
    references draw the reflection from the same deviates, and the ocean
    reference weighs it by pi * (albedo / pi), so the images agree to the
    rounding of that product in float32."""
    inp = _small_inputs(frozen_sfc.sfc_lambertian(0.06))
    got = _reference(inp, 40_000, 7, 2)
    kw = dict(inp.solve_kw, surface=0.06)
    want = _reference(dataclasses.replace(inp, solve_kw=kw,
                                          solve_objects={}), 40_000, 7, 2,
                      module=mc_ref)
    for g, w in zip(got, want):
        assert np.allclose(g, w, rtol=1e-4, atol=1e-6 * np.abs(w).max())
    assert np.mean(got) > 0


def _ocean(n_r=1.336, slope=0.0286, frac=0.0, alb=0.0):
    return tuple(torch.tensor(v, dtype=F64) for v in (n_r, slope, frac, alb))


def _hemisphere(n_mu=1000, n_phi=720):
    mu = (torch.arange(n_mu, dtype=F64) + 0.5) / n_mu
    phi = (torch.arange(n_phi, dtype=F64) + 0.5) * (2 * math.pi / n_phi)
    m, p = torch.meshgrid(mu, phi, indexing='ij')
    s = torch.sqrt(1 - m * m)
    return (s * torch.cos(p), s * torch.sin(p), m), 2 * math.pi / (n_mu * n_phi)


def _albedo(mu_i, ocean, view, dw):
    """Directional albedo: the integral of rho mu_v over the views."""
    wx, wy, wz = (torch.full_like(view[2], v)
                  for v in (-math.sqrt(1 - mu_i ** 2), 0.0, -mu_i))
    o = type('O', (), {'sfc_kind': 2, 'ocean': ocean})
    rho = ocean_ref.surface_rho(o, wx, wy, wz, *view)
    return float((rho * view[2]).sum() * dw)


@pytest.mark.parametrize('sza', [0.0, 30.0, 60.0])
def test_flat_sea_reflects_the_fresnel_reflectance(sza):
    """With the slope variance at 1e-4 the glint is a mirror: the
    directional albedo is the Fresnel reflectance at the sun's angle.
    Integrated in polar coordinates about the specular direction, out to
    0.2 rad (25 standard deviations of the reflected direction)."""
    mu_i = math.cos(math.radians(sza))
    si = math.sqrt(1 - mu_i ** 2)
    a = (torch.arange(4000, dtype=F64) + 0.5) * (0.2 / 4000)
    psi = (torch.arange(360, dtype=F64) + 0.5) * (2 * math.pi / 360)
    aa, pp = torch.meshgrid(a, psi, indexing='ij')
    r = torch.tensor([-si, 0.0, mu_i], dtype=F64)         # specular
    e1 = torch.tensor([mu_i, 0.0, si], dtype=F64)
    e2 = torch.tensor([0.0, 1.0, 0.0], dtype=F64)
    v = (torch.cos(aa)[..., None] * r + torch.sin(aa)[..., None]
         * (torch.cos(pp)[..., None] * e1 + torch.sin(pp)[..., None] * e2))
    up = v[..., 2] > 0
    dw = torch.sin(aa) * (0.2 / 4000) * (2 * math.pi / 360)
    o = type('O', (), {'sfc_kind': 2, 'ocean': _ocean(slope=1e-4)})
    rho = ocean_ref.surface_rho(
        o, *(torch.full_like(aa, c) for c in (-si, 0.0, -mu_i)),
        v[..., 0], v[..., 1], v[..., 2])
    alb = float(torch.where(up, rho * v[..., 2], 0.0).mul(dw).sum())
    fr = float(ocean_ref.fresnel(torch.tensor(mu_i, dtype=F64),
                                 torch.tensor(1.336, dtype=F64)))
    assert alb == pytest.approx(fr, rel=2e-3)


def test_hemispherical_integral_is_at_most_one():
    view, dw = _hemisphere()
    for u10 in (5.0, 15.0):
        ocean = _ocean(slope=0.003 + 0.00512 * u10, frac=2.95e-6 * u10 ** 3.52,
                       alb=0.22)
        for sza in (0.0, 30.0, 60.0, 75.0):
            a = _albedo(math.cos(math.radians(sza)), ocean, view, dw)
            assert 0.0 < a <= 1.0


def test_the_ocean_brdf_is_reciprocal():
    g = torch.Generator().manual_seed(3)
    mu_i, mu_v = 0.05 + 0.95 * torch.rand((2, 1000), generator=g,
                                          dtype=F64)
    dphi = 2 * math.pi * torch.rand(1000, generator=g, dtype=F64)
    c2w = mu_i * mu_v + torch.sqrt((1 - mu_i ** 2) * (1 - mu_v ** 2)) \
        * torch.cos(dphi)
    ocean = _ocean(frac=0.01, alb=0.2)
    assert torch.allclose(ocean_ref.coxmunk_rho(mu_i, mu_v, c2w, *ocean),
                          ocean_ref.coxmunk_rho(mu_v, mu_i, c2w, *ocean),
                          rtol=1e-12, atol=0.0)


def test_whitecaps_alone_are_lambertian():
    g = torch.Generator().manual_seed(4)
    mu_i, mu_v, c2w = torch.rand((3, 500), generator=g, dtype=F64)
    rho = ocean_ref.coxmunk_rho(0.1 + 0.9 * mu_i, 0.1 + 0.9 * mu_v,
                                2 * c2w - 1, *_ocean(frac=1.0, alb=0.22))
    assert torch.allclose(rho, torch.full_like(rho, 0.22 / math.pi),
                          rtol=1e-14, atol=0.0)


# ---- the flight kernel's counters ----

def _flight(surface, tile, stats):
    from benchmark.frozen import ocean
    inp = _small_inputs()
    sfc = {'ocean': ocean.sfc_ocean(768.5, 5.0), 'rough': copy.deepcopy(
        ocean.sfc_ocean(768.5, 5.0))}.get(surface, surface)
    if surface == 'rough':
        # whitecaps on 30 % of a rough sea, so that every branch is taken
        sfc.psfc[..., 1], sfc.psfc[..., 4] = 0.3, 0.2
    scene, st = build_scene(inp.atm, inp.abs_coef, cld=inp.cld, surface=sfc,
                            solar_zenith_angle=60.0, solar_azimuth_angle=45.0,
                            device='cpu')
    cfg = SolverConfig(target='radiance', batch=2048, tile_size=tile)
    rad_w = spectral_factors(inp.abs_coef, nz_out=1)[0][0]
    return mc_flight.run_transport_flight(scene, st, cfg, 6000, 11, 'cpu',
                                          rad_w=rad_w, stats=stats)


@pytest.mark.parametrize('surface', ['ocean', 'rough'])
def test_surface_branches_sum_to_the_surface_hits(surface):
    stats = {}
    trace.reset()
    trace.enable()
    try:
        _flight(surface, 8, stats)
        ctr = trace.report()['counters']
    finally:
        trace.enable(False)
        trace.reset()
    branch = {k: ctr['flight.sfc.' + k] for k in mc_flight.SFC_BRANCHES}
    assert branch == stats['sfc_branch']
    assert sum(branch.values()) == ctr['flight.iter_outcome.surface'] > 0
    assert branch['specular'] > 0
    if surface == 'rough':
        assert branch['whitecap'] > 0 and branch['lost'] > 0
    tiles = stats['tile_stops']
    assert ctr['flight.tile_clamps'] == tiles['clamped'] > 0
    assert tiles['active'] == sum(stats['iter_outcome'].values())
    assert tiles['clamped'] <= stats['iter_outcome']['stopped']


def test_counters_are_read_untraced_and_absent_where_nothing_adds_them(
        monkeypatch):
    built = []
    init = mc_flight.FlightKernel.__init__

    def keep(self, *a, **kw):
        init(self, *a, **kw)
        built.append(self)
    monkeypatch.setattr(mc_flight.FlightKernel, '__init__', keep)
    trace.enable(False)
    _flight('ocean', 8, None)
    assert built[-1].sfc_branch is None and built[-1].tile_stops is None
    stats = {}
    _flight('ocean', 8, stats)
    assert set(stats) >= {'sfc_branch', 'tile_stops'}
    assert 'iter_outcome' not in stats
    stats = {}
    trace.reset()
    trace.enable()
    try:
        _flight(0.03, 0, stats)
        ctr = trace.report()['counters']
    finally:
        trace.enable(False)
        trace.reset()
    assert built[-1].sfc_branch is None and built[-1].tile_stops is None
    assert not {'sfc_branch', 'tile_stops'} & set(stats)
    assert not [k for k in ctr if k.startswith(('flight.sfc.',
                                                'flight.tile_clamps'))]
    assert ctr['flight.iter_outcome.surface'] > 0


def test_ocean_inputs_are_one_object_for_both_sides():
    from benchmark.inputs import oco2_o2a768 as ocean_inputs
    cfg = json.loads((ROOT / 'benchmark' / 'configs'
                      / 'oco2_o2a768.json').read_text())
    cfg['cloud'].update(nx=40, ny=44)
    cfg['cloud']['map'].update(disks=8)
    inp = ocean_inputs.make_inputs(cfg)
    assert isinstance(inp, Inputs)
    sfc = inp.solve_objects['surface']
    assert sfc.jsfc.tolist() == [[2]]
    assert sfc.psfc[0, 0, 4] == pytest.approx(0.003 + 0.00512 * 5.0)
    assert inp.cld.extinction.shape == (40, 44, 5)
    col = inp.cld.cot.sum(axis=-1)
    assert np.all(inp.cld.extinction[..., :3] == 0)
    assert 3.0 <= col[col > 0].min() and col.max() <= 25.0

"""The port's front door (er3t_tpu_torch.rtm.solver.solve) and spectral
reduction against er3t_tpu's, and the options it once refused, each a
short run beside er3t_tpu's (multi-device runs on meshes of CPU ranks
beside the reference's on its virtual devices)."""

import dataclasses
import datetime
from unittest import mock

import numpy as np
import pytest
import torch

from er3t_tpu.pre.atm import atm_atmmod
from er3t_tpu.pre.abs import abs_synthetic
from er3t_tpu.pre.cld import cld_gen_hom
from er3t_tpu.dist.mesh import make_mesh as jmake_mesh
from er3t_tpu.rtm import mc_flight as jmf
from er3t_tpu.rtm import out as jout
from er3t_tpu.rtm import solver as jsolver
from er3t_tpu.rtm.mc import SolverConfig as JConfig
from er3t_tpu.rtm.scene import build_scene as jbuild_scene
from er3t_tpu_torch.dist.mesh import make_mesh as tmake_mesh
from er3t_tpu_torch.rtm import out as tout
from er3t_tpu_torch.rtm import solver as tsolver
from er3t_tpu_torch.rtm.mc import SolverConfig
from er3t_tpu_torch.rtm.mc_flight import run_transport_flight
from er3t_tpu_torch.rtm.scene import scene_from_numpy

torch.set_num_threads(2)


@pytest.fixture(scope='module')
def case():
    atm = atm_atmmod(np.linspace(0, 20, 21))
    ab = abs_synthetic(650.0, atm, ng=4)
    cld = cld_gen_hom(nx=8, ny=8, nz=2, dx=0.5, dy=0.5, cot0=8.0, cer0=10.0,
                      cloud_base=1.0, cloud_top=3.0)
    cld.extinction[4:] = 0.0          # half cloudy, half clear
    cld.cer[4:] = 0.0
    return dict(atm=atm, abs_coef=ab, cld=cld, surface=0.1,
                solar_zenith_angle=30.0, solar_azimuth_angle=45.0)


def test_solve_matches_reference(case):
    kw = dict(target='radiance', photons=3e4, n_run=2, batch=1 << 12,
              tile_size=16, qmc_launch=True, seed=3)
    ref = jsolver.solve(**case, **kw)
    got = tsolver.solve(**case, **kw, device='cpu')
    assert set(got.data) == set(ref.data) == {'rad'}
    assert set(got.std) == set(ref.std)
    for k in ref.data:
        assert np.shape(got.data[k]) == np.shape(ref.data[k]) == (8, 8)
    assert got.toa == ref.toa
    assert got.n_photon_effective == ref.n_photon_effective == 60000
    assert got['rad'].mean() == pytest.approx(ref['rad'].mean(), rel=0.03)


@pytest.mark.parametrize('date', [None, datetime.datetime(2020, 7, 1)])
def test_spectral_reduction_equals_reference(case, date):
    ab = case['abs_coef']
    for nz_out in (None, 1, 21):
        f_t, toa_t = tout.spectral_factors(ab, date=date, nz_out=nz_out)
        f_j, toa_j = jout.spectral_factors(ab, date=date, nz_out=nz_out)
        np.testing.assert_array_equal(f_t, f_j)
        assert toa_t == toa_j
    rng = np.random.default_rng(0)
    for ng_r, pre in ((4, False), (1, True)):
        tally = rng.uniform(0, 5, (8, 8, ng_r)).astype(np.float32)
        a = tout.reduce_radiance(tally, 1234, ab, 0.8, date=date,
                                 precontracted=pre)
        b = jout.reduce_radiance(tally, 1234, ab, 0.8, date=date,
                                 precontracted=pre)
        np.testing.assert_array_equal(a['rad'], b['rad'])
        assert a['toa'] == b['toa']
        c = tout.reduce_radiance(torch.from_numpy(tally), 1234, ab, 0.8,
                                 date=date, precontracted=pre)
        np.testing.assert_array_equal(c['rad'], b['rad'])


def same_result(got, ref):
    """A short run of the port's solve against the reference's: the same
    launched photons, toa, fields, shapes and NaN masks, finite where the
    reference is; the TOA down-direct flux (deterministic) to 1e-6."""
    assert got.n_photon_effective == ref.n_photon_effective
    assert got.toa == ref.toa and got.target == ref.target
    assert set(got.data) == set(ref.data) and set(got.std) == set(ref.std)
    for k in ref.data:
        a, b = np.asarray(got.data[k]), np.asarray(ref.data[k])
        assert a.shape == b.shape, k
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=k)
        assert np.isfinite(a[np.isfinite(b)]).all(), k
    if 'f_down_direct' in ref.data:
        np.testing.assert_allclose(got['f_down_direct'][..., -1],
                                   ref['f_down_direct'][..., -1], rtol=1e-6)


@pytest.mark.parametrize('bad', [
    dict(target='flux', flux_engine='marching'), dict(solver='ipa'),
    dict(solver='p3d'), dict(sensor_type='camera'), dict(camera={'npix': 8}),
    dict(spectral='independent', sensor_type='camera'),
    dict(spectral='independent', pathlength=True), dict(cf_dtau=0.5),
    dict(pathlength=True), dict(split_wmax=2.0)],
    ids=lambda d: '-'.join(f'{k}={v}' for k, v in d.items()))
def test_solve_refuses_unported_options(case, bad):
    """Every case, refused until the marching flux engine, IPA, partial
    3D, the camera, pathlength, forcing and splitting were ported, now
    runs: a short solve of each matches the reference's (same_result).
    Nothing is refused any more (mesh=: test_solve_mesh_matches_reference)."""
    kw = dict(photons=2000, n_run=1, batch=1 << 10, seed=5, **bad)
    same_result(tsolver.solve(**case, device='cpu', **kw),
                jsolver.solve(**case, **kw))


@pytest.mark.parametrize('x', [4, 1], ids=['decomp_x4', 'photon_x1'])
def test_solve_mesh_matches_reference(case, x):
    """solve(mesh=...), refused until the dist layer was ported, runs each
    package on its own mesh of 4 ranks (the port's CPU ranks, the
    reference's virtual devices): x = 4 slabs decomposed with migration,
    x = 1 photon-parallel; a short solve matches the reference's
    (same_result: the same photons launched, 500 a rank)."""
    kw = dict(photons=2000, n_run=1, batch=1 << 10, seed=5, tile_size=2)
    got = tsolver.solve(**case, device='cpu', **kw,
                        mesh=tmake_mesh(4, decomp=x, device='cpu'))
    same_result(got, jsolver.solve(**case, **kw,
                                   mesh=jmake_mesh(4, decomp=x)))
    assert float(np.mean(got['rad'])) > 0


@pytest.mark.parametrize('bad', [
    dict(target='flux', flux_engine='marching'), dict(sensor_type='camera'),
    dict(p3d_order=1),
    dict(cf_dtau=0.5), dict(split_wmax=2.0), dict(rr_value=0.1),
    dict(sort_every=4), dict(launch_coherent=True),
    dict(cam_importance_sigma=1.0), dict(pathlength=True), dict(ipa=True)],
    ids=lambda d: '-'.join(f'{k}={v}' for k, v in d.items()))
def test_flight_refuses_unported_options(case, bad):
    """Every option, once refused, runs: 2000 photons through both
    packages' run_transport_flight on one scene launch exactly as many
    photons, and give tallies of the same shapes, finite and >= 0, the
    target's tally not all zero.  The flight entry ignores flux_engine, as
    the reference's does."""
    bad = dict(bad)
    ipa = bad.pop('ipa', False)
    kw = {k: v for k, v in case.items() if k not in ('atm', 'abs_coef')}
    scn, st = jbuild_scene(case['atm'], case['abs_coef'], **kw)
    st = dataclasses.replace(st, ipa=ipa)
    if 'cam_importance_sigma' in bad:
        bad['sensor_type'] = 'camera'
    ref = jmf.run_transport_flight(scn, st, JConfig(batch=256, **bad), 2000,
                                   seed=0)
    got = run_transport_flight(*scene_from_numpy(scn, st, 'cpu'),
                               SolverConfig(batch=256, **bad), 2000, 0, 'cpu')
    assert int(got.n_launched) == int(ref.n_launched) == 2000
    for f in ('rad', 'rad_plen', 'flux', 'absorbed'):
        a, b = getattr(got, f).numpy(), np.asarray(getattr(ref, f))
        if f == 'flux':
            b = b.reshape(a.shape)     # radiance: zeros of the same size
        assert a.shape == b.shape, f
        assert np.isfinite(a).all() and (a >= 0).all(), f
    tally = got.flux if bad.get('target') == 'flux' else got.rad
    assert float(tally.sum()) > 0
    if bad.get('target') == 'flux':
        np.testing.assert_allclose(got.flux[..., -1, 0, :].numpy(),
                                   np.asarray(ref.flux)[..., -1, 0, :],
                                   rtol=1e-6)


@pytest.mark.parametrize('engine', ['flight', 'marching'])
@pytest.mark.parametrize('target', ['flux', 'heating_rate'])
def test_flux_contraction_only_for_the_flight_engine(case, engine, target):
    """Per-column crossings are contracted over g in the step (flux_w) by
    the flight engine only: a marching run gets no contraction, in the
    port as in the reference (er3t_tpu/rtm/solver.py:344-347)."""
    seen = {}

    def spy(pkg, fn):
        def run(*a, **kw):
            seen.setdefault(pkg, []).append(kw.get('flux_w'))
            return fn(*a, **kw)
        return run
    kw = dict(target=target, flux_engine=engine, flux_per_column=True,
              photons=1000, n_run=1, batch=1 << 10, seed=2)
    with mock.patch.object(tsolver, '_single_run',
                           spy('port', tsolver._single_run)), \
            mock.patch.object(jsolver, '_single_run',
                              spy('ref', jsolver._single_run)):
        got = tsolver.solve(**case, device='cpu', **kw)
        ref = jsolver.solve(**case, **kw)
    built = {p: [w is not None for w in ws] for p, ws in seen.items()}
    assert built['port'] == built['ref'] == [engine == 'flight']
    same_result(got, ref)

"""The solver-level protocol of the port against er3t_tpu's: the photon
split over g-points, the independent per-g protocol, the diffusion
smoothing and the HDF5 results.

The tests mirror tests/test_solver_modes.py (each names its reference
test) with the port, on the CPU, in place of er3t_tpu's solver; the parity
cases hold the port's copies against the reference's functions on the same
inputs: ``distribute_photon`` and ``smooth_diffusion`` bit for bit, HDF5
files across the two packages, the host side of the independent protocol
bit for bit with the transport replaced by the same made-up tallies in
both, and one flight step of a g-sliced scene to the f32 tolerance of
tests/test_torch_flight.py.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from er3t_tpu.pre.abs import G16_WEIGHTS, abs_synthetic
from er3t_tpu.pre.atm import atm_atmmod
from er3t_tpu.pre.cld import cld_gen_hem, cld_gen_hom
from er3t_tpu.rtm import mc_flight as jmf
from er3t_tpu.rtm import out as jout
from er3t_tpu.rtm import solver as jsolver
from er3t_tpu.rtm.mc import SolverConfig as JConfig
from er3t_tpu.rtm.scene import build_scene as jbuild_scene
from er3t_tpu_torch.pre.abs import abs_synthetic as tabs_synthetic
from er3t_tpu_torch.pre.atm import atm_atmmod as tatm_atmmod
from er3t_tpu_torch.pre.sfc import sfc_ocean
from er3t_tpu_torch.rtm import mc_flight as tmf
from er3t_tpu_torch.rtm import out as tout
from er3t_tpu_torch.rtm import solver
from er3t_tpu_torch.rtm.mc import SolverConfig
from er3t_tpu_torch.rtm.mc_flight import run_transport_flight
from er3t_tpu_torch.rtm.scene import build_scene, scene_from_numpy

torch.set_num_threads(2)


@pytest.fixture(scope='module')
def atm():
    return atm_atmmod(np.linspace(0, 20, 21))


def _solve(**kw):
    return solver.solve(device='cpu', **kw)


# ---- mirrors of tests/test_solver_modes.py ----

def test_distribute_photon_parity():
    """:20: 5 % floor, the remainder to the extreme-weight g."""
    w = np.array([0.5, 0.3, 0.15, 0.05])
    d = solver.distribute_photon(1000000, w)
    assert d.sum() == 1000000
    assert d.min() >= 0.05 / 4 * 1000000 * 0.9
    assert d.argmax() == 0


@pytest.mark.slow
def test_independent_g_matches_correlated(atm):
    """:31 (slow there too): clear-sky nadir radiance within 5 %."""
    ab = abs_synthetic(650.0, atm)
    kw = dict(atm=atm, abs_coef=ab, surface=0.2, target='radiance',
              solar_zenith_angle=30.0, n_run=1, batch=1 << 12)
    rc = _solve(spectral='correlated', photons=150000, seed=1, **kw)
    ri = _solve(spectral='independent', photons=300000, seed=2, **kw)
    assert ri['rad'][0, 0] == pytest.approx(rc['rad'][0, 0], rel=0.05)


def test_flux_over_ocean_surface(atm):
    """:40: a typed Cox-Munk surface in the flight engine's flux target:
    the ocean is dark, most energy is absorbed at the surface."""
    ab = tabs_synthetic(650.0, atm)
    ab.abso_coef[:] = 0.0
    ocean = sfc_ocean(650.0, u10=5.0)
    res = _solve(atm=atm, abs_coef=ab, surface=ocean, target='flux',
                 solar_zenith_angle=30.0, photons=40000, n_run=1,
                 batch=1 << 12)
    f_up_toa = float(np.squeeze(res['f_up'])[-1])
    f_dn_sfc = float(np.squeeze(res['f_down'])[0])
    assert 0.0 < f_up_toa < 0.15 * f_dn_sfc  # ocean albedo ~2-6%


def test_result_h5_roundtrip(atm, tmp_path):
    """:54."""
    ab = abs_synthetic(650.0, atm)
    res = _solve(atm=atm, abs_coef=ab, surface=0.1, target='flux',
                 photons=20000, n_run=2, batch=1 << 11)
    fname = os.path.join(tmp_path, 'out.h5')
    res.save_h5(fname)
    back = solver.Result.load_h5(fname)
    np.testing.assert_allclose(back['f_up'], res['f_up'])
    assert back.n_run == 2
    assert 'f_up_std' in back.std


def test_independent_g_flux(atm):
    """:288: the independent protocol for flux targets matches correlated
    sampling (6 % per level, TOA down-direct to 1e-3)."""
    ab = abs_synthetic(650.0, atm, ng=4)
    kw = dict(atm=atm, abs_coef=ab, surface=0.2, target='flux',
              solar_zenith_angle=30.0, n_run=1, batch=1 << 12,
              flux_per_column=False)
    rc = _solve(spectral='correlated', photons=100000, seed=1, **kw)
    ri = _solve(spectral='independent', photons=200000, seed=2, **kw)
    for k in ('f_down', 'f_up'):
        a = np.asarray(rc[k])[0, 0]
        b = np.asarray(ri[k])[0, 0]
        sel = a > 1e-2
        np.testing.assert_allclose(b[sel], a[sel], rtol=0.06)
    assert ri['f_down_direct'][0, 0, -1] == pytest.approx(
        rc['f_down_direct'][0, 0, -1], rel=1e-3)


def test_diffusion_smoothing(atm):
    """:306: the total is conserved (1e-12), the noise reduced, and
    through the front door the domain mean is kept (1e-6)."""
    rng = np.random.RandomState(0)
    f = rng.rand(16, 16) + 1.0
    s = tout.smooth_diffusion(f, 3)
    assert s.sum() == pytest.approx(f.sum(), rel=1e-12)
    assert s.std() < 0.5 * f.std()
    ab = abs_synthetic(650.0, atm, ng=4)
    cld = cld_gen_hom(nx=8, ny=8, nz=2, dx=0.5, dy=0.5, cot0=6.0, cer0=10.0,
                      cloud_base=1.0, cloud_top=3.0)
    kw = dict(atm=atm, abs_coef=ab, cld=cld, surface=0.1, target='radiance',
              solar_zenith_angle=30.0, photons=20000, n_run=1, batch=1 << 12,
              seed=4)
    r0 = _solve(**kw)
    r1 = _solve(diffusion=2, **kw)
    assert r1['rad'].mean() == pytest.approx(r0['rad'].mean(), rel=1e-6)
    assert r1['rad'].std() < r0['rad'].std()
    # the mean field only: not the std, not the runs
    np.testing.assert_array_equal(r1.std['rad_std'], r0.std['rad_std'])


def test_result_mode_all_roundtrip(atm, tmp_path):
    """:489."""
    ab = abs_synthetic(650.0, atm)
    res = _solve(atm=atm, abs_coef=ab, surface=0.1, target='flux',
                 photons=20000, n_run=3, batch=1 << 11, mode='all')
    assert len(res.runs) == 3
    np.testing.assert_allclose(
        np.mean([r['f_up'] for r in res.runs], axis=0), res['f_up'],
        rtol=1e-6)
    fname = os.path.join(tmp_path, 'all.h5')
    res.save_h5(fname)
    back = solver.Result.load_h5(fname)
    assert len(back.runs) == 3
    np.testing.assert_allclose(back.runs[1]['f_down'],
                               res.runs[1]['f_down'], rtol=1e-6)
    res2 = _solve(atm=atm, abs_coef=ab, surface=0.1, target='flux',
                  photons=10000, n_run=2, batch=1 << 11)
    assert res2.runs == []


def test_independent_contraction_exact(atm):
    """:513: the unit-weight contraction of a per-g pass equals the
    uncontracted pass on the same generator seed (rtol 1e-5, atol 1e-9),
    on the port alone."""
    ab = abs_synthetic(940.0, atm)
    scene, st = build_scene(atm, ab, surface=0.2, solar_zenith_angle=30.0,
                            device='cpu')
    cfg = SolverConfig(target='radiance', batch=1 << 11)
    dist = solver.distribute_photon(30000, ab.weight)
    seed = 42
    acc_c = np.zeros((st.nx, st.ny, ab.ng))
    acc_u = np.zeros((st.nx, st.ny, ab.ng))
    for g in range(ab.ng):
        scene_g, st_g = solver.g_slice(scene, st, g)
        tc = run_transport_flight(scene_g, st_g, cfg, int(dist[g]), seed + g,
                                  'cpu', rad_w=np.ones(1, np.float32))
        tu = run_transport_flight(scene_g, st_g, cfg, int(dist[g]), seed + g,
                                  'cpu')
        acc_c[..., g] = tc.rad.numpy()[..., 0] / int(tc.n_launched)
        acc_u[..., g] = tu.rad.numpy()[..., 0] / int(tu.n_launched)
    np.testing.assert_allclose(acc_c, acc_u, rtol=1e-5, atol=1e-9)


def test_distribute_photon_no_zero_g():
    """:659."""
    d = solver.distribute_photon(100, G16_WEIGHTS)
    assert d.sum() == 100 and d.min() >= 1
    d = solver.distribute_photon(16, G16_WEIGHTS)
    assert d.sum() == 16 and d.min() >= 1


def test_result_h5_effective_count_roundtrip(atm, tmp_path):
    """:702."""
    ab = abs_synthetic(650.0, atm)
    res = _solve(atm=atm, abs_coef=ab, surface=0.1, target='flux',
                 photons=10000, n_run=2, batch=1 << 11)
    assert res.n_photon_effective == 20000
    fn = os.path.join(tmp_path, 'eff.h5')
    res.save_h5(fn)
    assert solver.Result.load_h5(fn).n_photon_effective == 20000


# ---- the port's own cases of the protocol ----

def test_independent_heating_rate_differences_net_fluxes(atm):
    """Under the independent protocol hr is the net-flux convergence of
    each run (reference :408-414), so hr_std and every run carry it."""
    ab = abs_synthetic(940.0, atm, ng=4)
    res = _solve(atm=atm, abs_coef=ab, surface=0.2, target='heating_rate',
                 spectral='independent', solar_zenith_angle=30.0,
                 photons=8000, n_run=2, batch=1 << 11, mode='all')
    assert 'hr' in res.data and 'hr_std' in res.std
    for r in res.runs:
        np.testing.assert_array_equal(r['hr'], tout.heating_rate(r, atm))
    assert res.n_photon_effective == 16000


def test_independent_protocol_refuses_fewer_photons_than_g_points(atm):
    ab = abs_synthetic(650.0, atm)
    with pytest.raises(ValueError, match='photons >= ng'):
        _solve(atm=atm, abs_coef=ab, spectral='independent', photons=8,
               n_run=1, batch=256)


def test_solve_refuses_an_unknown_spectral_mode(atm):
    ab = abs_synthetic(650.0, atm, ng=4)
    with pytest.raises(ValueError, match='bogus'):
        _solve(atm=atm, abs_coef=ab, spectral='bogus', photons=100, n_run=1)


# ---- parity with the reference ----

def _weights():
    atm_b = atm_atmmod(np.concatenate([np.arange(0, 3.0, 0.5),
                                       np.arange(3.0, 20.1, 1.0)]))
    return {'g16': G16_WEIGHTS,
            'abs_synthetic_650': abs_synthetic(650.0, atm_b).weight,
            'abs_synthetic_940_ng4': abs_synthetic(940.0, atm_b, ng=4).weight,
            'one_heavy': np.array([0.97, 0.01, 0.01, 0.01]),
            'ramp7': np.arange(1.0, 8.0) / 28.0,
            'single': np.array([1.0])}


@pytest.mark.parametrize('name', list(_weights()))
def test_distribute_photon_equals_reference(name):
    """Bit for bit over budgets from 16 to 10^7, below and at the g count
    too."""
    w = _weights()[name]
    for n in (1, 3, 15, 16, 17, 31, 100, 999, 1000, 4096, 65537, 10 ** 5,
              2 * 10 ** 6, 4_000_003, 10 ** 7):
        got = solver.distribute_photon(n, w)
        ref = jsolver.distribute_photon(n, w)
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref, err_msg=f'{name} {n}')


@pytest.mark.parametrize('n_iter', [0, 1, 2, 3])
@pytest.mark.parametrize('shape', [(16, 16), (12, 7), (9, 6, 5)],
                         ids=['2d', '2d_ragged', '3d'])
def test_smooth_diffusion_equals_reference(shape, n_iter):
    """Bit for bit, on f32 and f64 fields."""
    rng = np.random.default_rng(3)
    for dtype in (np.float32, np.float64):
        f = rng.uniform(0.5, 2.0, shape).astype(dtype)
        got = tout.smooth_diffusion(f, n_iter)
        ref = jout.smooth_diffusion(f, n_iter)
        assert got.dtype == ref.dtype == np.float64
        np.testing.assert_array_equal(got, ref)


def _fields(rng, shape):
    return {'f_up': rng.normal(size=shape), 'f_down': rng.normal(size=shape),
            'hr': rng.normal(size=shape[-1:])}


@pytest.mark.parametrize('writer', ['port', 'reference'])
def test_h5_files_load_in_the_other_package(tmp_path, writer):
    """A file written by either package's Result.save_h5 loads in the
    other's Result.load_h5 with every field, run and attribute equal."""
    rng = np.random.default_rng(4)
    data = _fields(rng, (4, 3, 21))
    std = {k + '_std': v for k, v in _fields(rng, (4, 3, 21)).items()}
    runs = [_fields(rng, (4, 3, 21)) for _ in range(3)]
    kw = dict(target='flux', data=data, std=std, toa=1.5, n_photon=2e4,
              n_run=3, n_photon_effective=60000.0, runs=runs)
    cls_w, cls_r = ((solver.Result, jsolver.Result) if writer == 'port'
                    else (jsolver.Result, solver.Result))
    fn = os.path.join(tmp_path, f'{writer}.h5')
    cls_w(**kw).save_h5(fn)
    back = cls_r.load_h5(fn)
    for k in ('target', 'toa', 'n_photon', 'n_run', 'n_photon_effective'):
        assert getattr(back, k) == kw[k], k
    for got, ref in ((back.data, data), (back.std, std)):
        assert set(got) == set(ref)
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k])
    assert len(back.runs) == 3
    for got, ref in zip(back.runs, runs):
        assert set(got) == set(ref)
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k])


def _fake_tallies(static, cfg, n_photon, seed, rad_w, flux_w):
    """Made-up tallies of one pass (image, flux, pathlength image), a
    function of its photons and seed, in the shapes the pass would give."""
    rng = np.random.default_rng([n_photon, seed])
    flux_run = cfg.target != 'radiance'
    nxf, nyf = ((static.nx, static.ny) if flux_run and cfg.flux_per_column
                else (1, 1))
    nxr, nyr = ((cfg.cam_npix, cfg.cam_npix) if cfg.sensor_type == 'camera'
                else (static.nx, static.ny))
    ng_r = 1 if rad_w is not None else static.ng
    ng_f = 1 if flux_w is not None else static.ng
    rad = rng.uniform(0, n_photon, (nxr, nyr, ng_r)).astype(np.float32)
    flux = rng.uniform(0, n_photon, (nxf, nyf, static.nz + 1, 3, ng_f)
                       ).astype(np.float32)
    rad_pl = (rng.uniform(0, 3e4 * n_photon, (nxr, nyr, static.ng))
              .astype(np.float32) if cfg.pathlength else np.zeros((), np.float32))
    # a few empty pixels, where the mean pathlength is 0
    rad[0, 0] = 0.0
    return rad, flux, rad_pl


_CAMERA = dict(camera=dict(zloc=500.0, the=180.0, qmax=60.0, npix=6))


@pytest.mark.parametrize('target,spectral,extra', [
    pytest.param('radiance', 'independent', {}, id='radiance'),
    pytest.param('flux', 'independent', {}, id='flux'),
    pytest.param('heating_rate', 'independent', {}, id='heating_rate'),
    pytest.param('radiance', 'independent', _CAMERA, id='camera'),
    pytest.param('radiance', 'independent', dict(pathlength=True),
                 id='pathlength'),
    pytest.param('radiance', 'correlated', _CAMERA, id='correlated-camera'),
    pytest.param('radiance', 'correlated', dict(pathlength=True),
                 id='correlated-pathlength'),
    pytest.param('radiance', 'correlated', dict(_CAMERA, pathlength=True),
                 id='correlated-camera-pathlength')])
def test_independent_protocol_equals_reference_on_the_same_tallies(
        monkeypatch, atm, target, spectral, extra):
    """With both packages' transport replaced by the same made-up tallies,
    solve(spectral='independent') calls it with the same photons, seeds,
    unit weights and g-sliced absorption, and reduces to the same fields,
    bit for bit; so do the camera reduction and the pathlength ratio, of
    both protocols."""
    ab = abs_synthetic(940.0, atm, ng=4)
    cld = cld_gen_hom(nx=4, ny=3, nz=2, dx=1.0, dy=1.0, cot0=6.0, cer0=10.0,
                      cloud_base=1.0, cloud_top=3.0)
    calls = {'port': [], 'reference': []}

    def record(who, scene, static, cfg, n_photon, seed, flux_w, rad_w):
        calls[who].append((int(n_photon), int(seed), static.ng,
                           np.asarray(scene.kabs).tolist(),
                           None if flux_w is None else np.asarray(flux_w).tolist(),
                           None if rad_w is None else np.asarray(rad_w).tolist()))
        return _fake_tallies(static, cfg, n_photon, seed, rad_w, flux_w)

    def port_run(scene, static, cfg, n_photon, seed, device, chunk=4_000_000,
                 flux_w=None, rad_w=None, mesh=None):
        assert scene.kabs.is_contiguous()
        rad, flux, rad_pl = record('port', scene, static, cfg, n_photon, seed,
                                   flux_w, rad_w)
        return rad, flux, np.zeros((1, 1), np.float32), rad_pl, n_photon - 1

    def ref_run(scene, static, cfg, n_photon, seed, chunk=4_000_000,
                mesh=None, flux_w=None, rad_w=None):
        rad, flux, rad_pl = record('reference', scene, static, cfg, n_photon,
                                   seed, flux_w, rad_w)
        return rad, flux, n_photon - 1, rad_pl, None

    monkeypatch.setattr(solver, '_single_run', port_run)
    monkeypatch.setattr(jsolver, '_single_run', ref_run)
    kw = dict(atm=atm, abs_coef=ab, cld=cld, surface=0.1, target=target,
              spectral=spectral, solar_zenith_angle=30.0, photons=5000,
              n_run=2, seed=9, batch=256, mode='all', diffusion=1, **extra)
    got = solver.solve(device='cpu', **kw)
    ref = jsolver.solve(**kw)
    n_pass = 8 if spectral == 'independent' else 2
    assert calls['port'] == calls['reference'] and len(calls['port']) == n_pass
    assert got.n_photon_effective == ref.n_photon_effective
    assert got.toa == ref.toa
    assert ('plen' in got.data) == ('pathlength' in extra)
    if 'camera' in extra:
        assert got['rad'].shape == (6, 6) and np.isnan(got['rad']).any()
    for a, b in [(got.data, ref.data), (got.std, ref.std)] + list(
            zip(got.runs, ref.runs)):
        assert set(a) == set(b)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# ---- one flight step of a g-sliced scene ----

def _to_port(c):
    lanes = {f: torch.from_numpy(np.array(getattr(c, f)))
             for f in tmf._LANE_FIELDS}
    ng = c.labs.shape[0] - 1
    return tmf.FlightCarry(**lanes, launched=torch.tensor(int(c.launched)),
                           step=int(c.step),
                           rad=torch.from_numpy(np.array(c.rad)),
                           rad_pl=torch.from_numpy(np.array(c.rad_pl)),
                           flux=torch.zeros(1, ng), absorbed=torch.zeros(1, 1))


def test_g_sliced_step_matches_reference():
    """The last g-point of a 4-g broken-cloud scene as the independent
    protocol runs it (ng = 1, unit rad_w): six steps of both packages from
    one carry with JAX's deviates injected, to the tolerances of
    tests/test_torch_flight.py (coordinates to 1e-5 of the domain, or
    1e-6 of the lane's path where that is longer: see below; directions,
    weights and optical paths rtol 1e-4 / atol 1e-5, discrete state on >=
    99.9 % of lanes, the image sum rtol 1e-4)."""
    b = 4096
    levels = np.concatenate([np.arange(0, 3.0, 0.5), np.arange(3.0, 20.1, 1.0)])
    atm_b = atm_atmmod(levels)
    ab = abs_synthetic(940.0, atm_b, ng=4)
    cld = cld_gen_hem(nx=16, ny=16, nz=4, dx=0.2, dy=0.2, dz=0.5,
                      cloud_frac_tgt=0.3, radii=(0.4,), cot_scale=12.0,
                      cloud_base=0.5, seed=3)
    scn, st = jbuild_scene(atm_b, ab, cld=cld, surface=0.05,
                           solar_zenith_angle=30.0, solar_azimuth_angle=45.0)
    g = ab.ng - 1
    jscn = scn._replace(kabs=scn.kabs[:, g:g + 1])
    jst = dataclasses.replace(st, ng=1)
    tscn, tst = solver.g_slice(*scene_from_numpy(scn, st, 'cpu'), g)
    assert tst == scene_from_numpy(jscn, jst, 'cpu')[1]
    assert tscn.kabs.is_contiguous() and tuple(tscn.kabs.shape) == (
        st.nz, 1)
    np.testing.assert_array_equal(tscn.kabs.numpy(), np.asarray(jscn.kabs))
    kw = dict(target='radiance', batch=b, n_scat_max=300, tile_size=8,
              qmc_launch=False)
    n_photon = 20000
    key = jax.random.key(1)
    body, _, c = jmf.make_flight_kernel(jscn, jst, JConfig(**kw),
                                        jnp.int32(n_photon), key,
                                        rad_w=jnp.ones(1, jnp.float32))
    body = jax.jit(body)
    kern = tmf.FlightKernel(tscn, tst, SolverConfig(**kw), n_photon,
                            rad_w=np.ones(1, np.float32))
    scale = {'x': st.nx * st.dx, 'y': st.ny * st.dy,
             'z': float(scn.z_lev[-1])}
    for k in range(6):
        u = jax.random.uniform(jax.random.fold_in(key, c.step), (14, b),
                               minval=1e-7, maxval=1 - 1e-7)
        ref = body(c)
        got = kern.step(_to_port(c), torch.from_numpy(np.array(u)), 0)
        assert tuple(got.labs.shape) == (2, b)
        # a coordinate is its start plus the flight distance, so it carries
        # the distance's f32 rounding: a grazing flight runs far longer
        # than the domain (4.2e6 m over 3.2 km here), so the bound is the
        # larger of 1e-5 of the domain and 1e-6 (8 ulp) of the path
        plen = np.abs(np.asarray(ref.plen))
        for f in ('x', 'y', 'z'):
            a, d = np.asarray(getattr(ref, f)), getattr(got, f).numpy()
            d = np.abs(a - d)
            if f != 'z':
                d = np.minimum(d, scale[f] - d)
            excess = d - np.maximum(1e-5 * scale[f], 1e-6 * plen)
            assert excess.max() <= 0, (k, f, d[excess.argmax()])
        for f in ('ux', 'uy', 'uz', 'wsc', 'labs', 'tau', 'plen'):
            np.testing.assert_allclose(getattr(got, f).numpy(),
                                       np.asarray(getattr(ref, f)),
                                       rtol=1e-4, atol=1e-5, err_msg=f'{k} {f}')
        for f in ('alive', 'nscat', 'direct', 'ix0', 'iy0'):
            same = np.mean(getattr(got, f).numpy() == np.asarray(getattr(ref, f)))
            assert same >= 0.999, (k, f, same)
        assert int(got.launched) == int(ref.launched)
        r_ref = float(np.asarray(ref.rad, np.float64).sum())
        assert float(got.rad.double().sum()) == pytest.approx(r_ref, rel=1e-4)
        c = ref


def test_port_abs_and_atm_copies_feed_the_protocol():
    """The port's own preprocessing objects drive the protocol too (the
    front door is duck-typed): a 4-g radiance run launches every photon."""
    atm_t = tatm_atmmod(np.linspace(0, 20, 21))
    ab = tabs_synthetic(650.0, atm_t, ng=4)
    res = _solve(atm=atm_t, abs_coef=ab, surface=0.2, target='radiance',
                 spectral='independent', photons=4000, n_run=1, batch=1 << 10)
    assert res.n_photon_effective == 4000
    assert np.isfinite(res['rad']).all() and res['rad'].shape == (1, 1)

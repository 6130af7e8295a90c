"""The port's flux branch against er3t_tpu.rtm.mc_flight and er3t_tpu.rtm.out.

1. One step at a time with injected deviates (as tests/test_torch_flight.py
   does for radiance), in the four tally modes: per-column with the
   crossing-count clamp, with and without the in-step contraction
   ``flux_w``; per-column without the clamp; domain average with the
   direct absorbed-energy tally.
2. Whole runs agree statistically; the TOA down-direct entry exactly.
3. The NumPy reductions equal the reference's.
4. The option the flux path still refuses, and short runs of those it
   once refused (forcing, IPA, partial 3D) beside er3t_tpu's.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from er3t_tpu.pre.atm import atm_atmmod
from er3t_tpu.pre.abs import abs_synthetic
from er3t_tpu.pre.cld import cld_gen_hem, cld_gen_hom
from er3t_tpu.pre.pha import pha_mie_wc
from er3t_tpu.pre.sfc import sfc_ocean
from er3t_tpu.rtm import mc_flight as jmf
from er3t_tpu.rtm import out as jout
from er3t_tpu.rtm import solver as jsolver
from er3t_tpu.rtm.mc import SolverConfig as JConfig
from er3t_tpu.rtm.scene import build_scene
from er3t_tpu_torch.rtm import mc_flight as tmf
from er3t_tpu_torch.rtm import out as tout
from er3t_tpu_torch.rtm import solver as tsolver
from er3t_tpu_torch.rtm.mc import SolverConfig as TConfig
from er3t_tpu_torch.rtm.scene import scene_from_numpy

from test_torch_solver import same_result

torch.set_num_threads(2)
B = 4096
BASE = dict(target='flux', batch=B, n_scat_max=300, tile_size=16,
            qmc_launch=True)
MODES = {
    'kx4_flux_w': dict(flux_per_column=True, flux_kcross=4),
    'kx4': dict(flux_per_column=True, flux_kcross=4),
    'kx0': dict(flux_per_column=True, flux_kcross=0),
    'domain_absorbed': dict(flux_per_column=False),
    'ocean_kx4_flux_w': dict(flux_per_column=True, flux_kcross=4),
}


@functools.lru_cache(maxsize=None)
def _broken(ocean=False):
    """32x32 broken-cloud Mie scene, 4 g-points, 20-deg truncation, a
    reflecting surface (the scene of tests/test_torch_flight.py) and its
    (Nz+1, Ng) flux factors; ``ocean``: a Cox-Munk ocean (u10 = 5 m/s) in
    place of the Lambertian surface."""
    levels = np.concatenate([np.arange(0, 3.0, 0.5), np.arange(3.0, 20.1, 1.0)])
    atm = atm_atmmod(levels)
    ab = abs_synthetic(650.0, atm, ng=4)
    cld = cld_gen_hem(nx=32, ny=32, nz=4, dx=0.2, dy=0.2, dz=0.5,
                      cloud_frac_tgt=0.3, radii=(0.4,), cot_scale=12.0,
                      cloud_base=0.5, seed=3)
    surface = sfc_ocean(650.0, u10=5.0, nx=32, ny=32) if ocean else 0.05
    scn, st = build_scene(atm, ab, cld=cld, pha=pha_mie_wc(650.0),
                          surface=surface, solar_zenith_angle=30.0,
                          solar_azimuth_angle=45.0, forward_trunc_deg=20.0)
    flux_w = jout.spectral_factors(ab, nz_out=st.nz + 1)[0]
    return ab, scn, st, flux_w


def _to_port(c, kern):
    """The reference's carry in the port's layout: its packed flux rows
    unpacked to (rows, Ng), or the flat scalar tally as it is."""
    lanes = {f: torch.from_numpy(np.array(getattr(c, f)))
             for f in tmf._LANE_FIELDS}
    flux = np.array(c.flux)
    if flux.ndim == 2:
        n_rows = kern.nxf * kern.nyf * kern.nlev * 3
        flux = flux.reshape(-1, kern.st.ng)[:n_rows]
    return tmf.FlightCarry(**lanes, launched=torch.tensor(int(c.launched)),
                           step=int(c.step),
                           rad=torch.from_numpy(np.array(c.rad)),
                           rad_pl=torch.from_numpy(np.array(c.rad_pl)),
                           flux=torch.from_numpy(np.ascontiguousarray(flux)),
                           absorbed=torch.from_numpy(np.array(c.absorbed)))


def _close(got, ref, what, atol=1e-5):
    """Tallies: total to rel 1e-4 and each element to ``atol`` of the
    largest."""
    got = got.double().numpy()
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    assert got.sum() == pytest.approx(ref.sum(), rel=1e-4), what
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=atol * np.abs(ref).max(), err_msg=what)


@pytest.mark.parametrize('mode', list(MODES))
def test_flux_step_parity_with_injected_deviates(mode):
    ab, scn, st, flux_w = _broken(ocean=mode.startswith('ocean'))
    kw = dict(BASE, **MODES[mode])
    fw = flux_w if mode.endswith('kx4_flux_w') else None
    n_photon = 60000
    key = jax.random.key(0)
    body, _, c = jmf.make_flight_kernel(
        scn, st, JConfig(**kw), jnp.int32(n_photon), key,
        flux_w=None if fw is None else jnp.asarray(fw, jnp.float32))
    body = jax.jit(body)
    q_off = int(jax.random.randint(jax.random.fold_in(key, 0x3FFFFFFF), (),
                                   0, st.nx * st.ny, dtype=jnp.int32))
    kern = tmf.FlightKernel(*scene_from_numpy(scn, st, 'cpu'), TConfig(**kw),
                            n_photon, flux_w=fw)
    assert (kern.kx, kern.scalar_flux, kern.tally_absorbed) == {
        'kx4_flux_w': (4, True, False), 'kx4': (4, False, False),
        'kx0': (0, False, False), 'domain_absorbed': (0, False, True),
        'ocean_kx4_flux_w': (4, True, False)}[mode]
    scale = {'x': st.nx * st.dx, 'y': st.ny * st.dy,
             'z': float(scn.z_lev[-1])}
    for k in range(6):
        u = jax.random.uniform(jax.random.fold_in(key, c.step), (14, B),
                               minval=1e-7, maxval=1 - 1e-7)
        ref = body(c)
        got = kern.step(_to_port(c, kern), torch.from_numpy(np.array(u)),
                        q_off)
        for f in ('x', 'y', 'z'):
            a, b = np.asarray(getattr(ref, f)), getattr(got, f).numpy()
            d = np.abs(a - b)
            if f != 'z':
                d = np.minimum(d, scale[f] - d)           # periodic
            assert d.max() <= 1e-5 * scale[f], (k, f, d.max())
        for f in ('ux', 'uy', 'uz', 'wsc', 'labs', 'tau', 'plen'):
            np.testing.assert_allclose(getattr(got, f).numpy(),
                                       np.asarray(getattr(ref, f)),
                                       rtol=1e-4, atol=1e-5, err_msg=f'{k} {f}')
        for f in ('alive', 'nscat', 'direct', 'ix0', 'iy0'):
            same = np.mean(getattr(got, f).numpy() == np.asarray(getattr(ref, f)))
            assert same >= 0.999, (k, f, same)
        assert int(got.launched) == int(ref.launched)
        ref_port = _to_port(ref, kern)
        # a domain-average row sums all B lanes in f32: against an f64 sum
        # the reference's own rounding there reaches 1.5e-5 (flux) and
        # 2.4e-5 (absorbed) of the largest row, the port's 0.5e-5, so
        # those rows get 3e-5
        atol = 3e-5 if kern.tally_absorbed else 1e-5
        _close(got.flux, ref_port.flux, f'{k} flux', atol)
        _close(got.absorbed, ref_port.absorbed, f'{k} absorbed', atol)
        c = ref
    # the tallies were used: crossings (and absorption) were tallied
    assert float(got.flux.sum()) > 0
    assert (float(got.absorbed.sum()) > 0) == (mode == 'domain_absorbed')


@pytest.mark.parametrize('mode', ['kx4_flux_w', 'domain_absorbed'])
def test_flux_whole_run_matches_reference(mode):
    """60k photons each: TOA down-direct exact, the domain means of the
    surface f_down and the TOA f_up within 2 %."""
    ab, scn, st, flux_w = _broken()
    kw = dict(BASE, **MODES[mode])
    fw = flux_w if mode == 'kx4_flux_w' else None
    a = jmf.run_transport_flight(scn, st, JConfig(**kw), 60000, seed=2,
                                 flux_w=fw)
    b = tmf.run_transport_flight(*scene_from_numpy(scn, st, 'cpu'),
                                 TConfig(**kw), 60000, 2, 'cpu', flux_w=fw)
    assert int(b.n_launched) == int(a.n_launched) == 60000
    fa, fb = np.asarray(a.flux, np.float64), b.flux.double().numpy()
    assert fb.shape == fa.shape
    if fw is None:
        w = ab.weight
        fa, fb = fa @ w, fb @ w
    else:
        fa, fb = fa[..., 0], fb[..., 0]
    nz = st.nz
    np.testing.assert_allclose(fb[:, :, nz, 0], fa[:, :, nz, 0], rtol=1e-6)
    f_dn = lambda f: (f[:, :, 0, 0] + f[:, :, 0, 1]).mean()   # noqa: E731
    assert f_dn(fb) == pytest.approx(f_dn(fa), rel=0.02)
    assert fb[:, :, nz, 2].mean() == pytest.approx(fa[:, :, nz, 2].mean(),
                                                   rel=0.02)
    if mode == 'domain_absorbed':
        assert tuple(b.absorbed.shape) == np.shape(a.absorbed)


def test_flux_reductions_equal_reference():
    atm = atm_atmmod(np.linspace(0, 20, 21))
    ab = abs_synthetic(940.0, atm, ng=4)
    rng = np.random.default_rng(1)
    mu0 = 0.8
    for shape, pre in (((3, 2, 21, 3, 4), False), ((1, 1, 21, 3, 4), False),
                       ((3, 2, 21, 3, 1), True)):
        tally = rng.uniform(0, 5, shape).astype(np.float32)
        a = tout.reduce_flux(tally, 4321, ab, mu0, precontracted=pre)
        b = jout.reduce_flux(tally, 4321, ab, mu0, precontracted=pre)
        assert set(a) == set(b)
        for k in b:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-6)
        np.testing.assert_allclose(tout.heating_rate(a, atm),
                                   jout.heating_rate(b, atm), rtol=1e-6)
    absorbed = rng.uniform(0, 3, (20, 4)).astype(np.float32)
    np.testing.assert_allclose(
        tout.heating_rate_from_absorbed(absorbed, 4321, ab, mu0, atm),
        jout.heating_rate_from_absorbed(absorbed, 4321, ab, mu0, atm),
        rtol=1e-6)


@pytest.fixture(scope='module')
def small_case():
    atm = atm_atmmod(np.linspace(0, 20, 21))
    ab = abs_synthetic(650.0, atm, ng=4)
    cld = cld_gen_hom(nx=4, ny=4, nz=2, dx=1.0, dy=1.0, cot0=6.0, cer0=10.0,
                      cloud_base=1.0, cloud_top=3.0)
    return dict(atm=atm, abs_coef=ab, cld=cld, surface=0.1,
                solar_zenith_angle=30.0)


@pytest.mark.parametrize('bad', [
    dict(target='heating_rate', flux_engine='marching'),
    dict(target='flux', cf_dtau=0.5), dict(target='heating_rate', cf_dtau=0.5),
    dict(target='flux', solver='ipa'), dict(target='heating_rate', solver='ipa'),
    dict(target='flux', solver='p3d')],
    ids=lambda d: '-'.join(f'{k}={v}' for k, v in d.items()))
def test_flux_refuses_unported_options(small_case, bad):
    """The marching engine, forcing, IPA and partial 3D, once refused, run:
    a short solve of each matches the reference's
    (test_torch_solver.same_result); nothing here is refused."""
    kw = dict(photons=2000, n_run=1, batch=1 << 10, seed=5, **bad)
    same_result(tsolver.solve(**small_case, device='cpu', **kw),
                jsolver.solve(**small_case, **kw))


def test_flux_ipa_refused_by_the_flight_entry(small_case):
    """IPA flux through the flight entry, once refused: the
    per-column crossings go to the birth column (reference :783-785,
    887-889); a short run of both packages on one scene launches as many
    photons and gives the same TOA down-direct flux in every column."""
    kw = {k: v for k, v in small_case.items() if k not in ('atm', 'abs_coef')}
    scn, st = build_scene(small_case['atm'], small_case['abs_coef'], **kw)
    st = dataclasses.replace(st, ipa=True)
    cfg = dict(target='flux', batch=256, flux_per_column=True)
    ref = jmf.run_transport_flight(scn, st, JConfig(**cfg), 2000, seed=0)
    got = tmf.run_transport_flight(*scene_from_numpy(scn, st, 'cpu'),
                                   TConfig(**cfg), 2000, 0, 'cpu')
    assert int(got.n_launched) == int(ref.n_launched) == 2000
    a, b = got.flux.numpy(), np.asarray(ref.flux)
    assert a.shape == b.shape == (4, 4, st.nz + 1, 3, st.ng)
    np.testing.assert_allclose(a[:, :, -1, 0], b[:, :, -1, 0], rtol=1e-6)
    assert np.isfinite(a).all() and (a >= 0).all()

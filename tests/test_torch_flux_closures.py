"""Closures of the port's flux path that the reference also passes.  Each
mirrors a reference test (named in its docstring) with the port's flight
engine and front door in place of er3t_tpu's; the reference ran several of
them on its event-marching engine.
"""

import numpy as np
import pytest
import torch

from er3t_tpu.pre.atm import atm_atmmod
from er3t_tpu.pre.abs import abs_synthetic
from er3t_tpu.pre.cld import cld_gen_hom
from er3t_tpu.pre.pha import pha_hg
from er3t_tpu.physics import rayleigh, twostream
from er3t_tpu_torch.rtm import out as tout
from er3t_tpu_torch.rtm.mc import SolverConfig
from er3t_tpu_torch.rtm.mc_flight import run_transport_flight
from er3t_tpu_torch.rtm.scene import build_scene, scene_from_numpy
from er3t_tpu_torch.rtm.solver import solve

torch.set_num_threads(2)


@pytest.fixture(scope='module')
def atm20():
    return atm_atmmod(np.linspace(0, 20, 21))


@pytest.fixture(scope='module')
def clear_run(atm20):
    """tests/test_transport_1d.py:24-39: clear-sky conservative run (pure
    Rayleigh, albedo 0.3, SZA 30), domain-average flux tallies."""
    ab = abs_synthetic(650.0, atm20)
    ab.abso_coef[:] = 0.0
    scn, st = build_scene(atm20, ab, surface=0.3, solar_zenith_angle=30.0,
                          device='cpu')
    cfg = SolverConfig(target='flux', batch=1 << 13)
    tal = run_transport_flight(scn, st, cfg, 60000, 7, 'cpu')
    n = int(tal.n_launched)
    assert n == 60000
    flux = tal.flux[0, 0].numpy() / n
    w = ab.weight
    return {'f_dir': flux[:, 0, :] @ w, 'f_dif': flux[:, 1, :] @ w,
            'f_up': flux[:, 2, :] @ w}


def test_energy_conservation(clear_run):
    """tests/test_transport_1d.py:50-54."""
    f = clear_run
    net_in = f['f_dir'][-1] + f['f_dif'][-1] - f['f_up'][-1]
    absorbed_sfc = (f['f_dir'][0] + f['f_dif'][0]) * (1 - 0.3)
    assert net_in == pytest.approx(absorbed_sfc, rel=0.01)


def test_direct_beam_beer_law(clear_run):
    """tests/test_transport_1d.py:57-60."""
    mu0 = np.cos(np.deg2rad(30.0))
    tau = rayleigh.rayleigh_od(650.0, np.array([1013.25, 55.3]), lat_deg=30.0)[0]
    assert clear_run['f_dir'][0] == pytest.approx(np.exp(-tau / mu0), rel=0.01)


def test_flux_vs_delta_eddington(clear_run, atm20):
    """tests/test_transport_1d.py:63-71."""
    mu0 = np.cos(np.deg2rad(30.0))
    tau_ray = rayleigh.rayleigh_od(650.0, atm20.lev.pressure, lat_deg=30.0)
    de = twostream.delta_eddington_flux(tau_ray, np.ones(20) - 1e-9,
                                        np.zeros(20), mu0=mu0, albedo=0.3)
    assert clear_run['f_up'][-1] == pytest.approx(de['f_up'][-1] / mu0, rel=0.03)
    f_dn_sfc = clear_run['f_dir'][0] + clear_run['f_dif'][0]
    assert f_dn_sfc == pytest.approx(de['f_down'][0] / mu0, rel=0.01)


def test_solver_driver_flux(atm20):
    """tests/test_transport_1d.py:93-103."""
    ab = abs_synthetic(650.0, atm20)
    res = solve(atm=atm20, abs_coef=ab, surface=0.0, target='flux',
                solar_zenith_angle=0.0, photons=30000, n_run=2,
                batch=1 << 12, device='cpu')
    assert res.target == 'flux'
    f_dir_toa = float(res['f_down_direct'][0, 0, -1])
    # physical TOA direct flux = E(650nm)*mu0 ~ 1.60 W/m2/nm
    assert f_dir_toa == pytest.approx(1.60, rel=0.02)
    assert res['f_up'].shape == (1, 1, 21)
    assert set(res.data) == {'f_down_direct', 'f_down_diffuse', 'f_down',
                             'f_up'}
    assert 'f_up_std' in res.std


def test_heating_rate(atm20):
    """tests/test_transport_1d.py:117-127."""
    ab = abs_synthetic(650.0, atm20)
    res = solve(atm=atm20, abs_coef=ab, surface=0.0, target='hr',
                solar_zenith_angle=0.0, photons=30000, n_run=1,
                batch=1 << 12, device='cpu')
    hr = np.asarray(res['hr'])
    assert hr.shape == (20,)      # direct absorbed-energy tally
    assert np.all(np.isfinite(hr))
    assert hr.max() > 0
    assert hr.max() < 5.0
    assert 'hr_std' in res.std


def _column_closure(res, atm):
    """(column absorbed power from hr, net-flux convergence TOA - surface)
    of one result [W/m^2/nm] (tests/test_solver_modes.py:450-456)."""
    cp, rd = 1004.0, 287.0
    dz_m = atm.lay.thickness * 1000.0
    rho = atm.lay.pressure * 100.0 / (rd * atm.lay.temperature)
    col_direct = float(np.sum(np.asarray(res['hr']) / 86400.0 * rho * cp
                              * dz_m))
    f_dn = np.asarray(res['f_down'])[0, 0]
    f_up = np.asarray(res['f_up'])[0, 0]
    col_diff = float((f_dn[-1] - f_up[-1]) - (f_dn[0] - f_up[0]))
    hr_diff = tout.heating_rate({'f_down': f_dn[None, None],
                                 'f_up': f_up[None, None]}, atm)[0, 0]
    return col_direct, col_diff, hr_diff


def test_heating_rate_direct_tally(atm20):
    """tests/test_solver_modes.py:433-461: the direct tally closes against
    the same run's level-flux differencing and is non-negative."""
    ab = abs_synthetic(940.0, atm20)          # H2O band: real absorption
    res = solve(atm=atm20, abs_coef=ab, target='heating_rate', surface=0.2,
                solar_zenith_angle=30.0, photons=2e5, n_run=1, seed=7,
                device='cpu')
    hr = np.asarray(res['hr'])
    assert hr.shape == (atm20.lay.altitude.size,)
    assert np.all(hr > -1e-9)
    assert hr.max() > 1e-3
    col_direct, col_diff, hr_diff = _column_closure(res, atm20)
    assert col_direct == pytest.approx(col_diff, rel=0.03)
    np.testing.assert_allclose(hr, hr_diff, atol=0.05 * max(hr.max(), 1e-6)
                               + 1e-8, rtol=1.0)


def test_heating_rate_absorbing_cloud_closure(atm20):
    """tests/test_solver_modes.py:545-583: with droplets of ssa 0.90 the
    collision deposit carries most of the absorption; the column closes
    within 5 %."""
    p = pha_hg(asy_params=(0.85,))
    p.data['ssa'] = np.array([0.90])
    ab = abs_synthetic(650.0, atm20)
    cld = cld_gen_hom(nx=4, ny=4, dx=1.0, dy=1.0, cot0=6.0, cer0=10.0,
                      cloud_base=1.0, cloud_top=3.0)
    res = solve(atm=atm20, abs_coef=ab, cld=cld, pha=p,
                target='heating_rate', surface=0.2, solar_zenith_angle=30.0,
                photons=2e5, n_run=1, seed=11, device='cpu')
    hr = np.asarray(res['hr'])
    lay_z = atm20.lay.altitude
    in_cld = (lay_z >= 1.0) & (lay_z <= 3.0)
    assert hr[in_cld].sum() > 3.0 * max(hr[~in_cld].sum(), 1e-12)
    col_direct, col_diff, hr_diff = _column_closure(res, atm20)
    assert col_direct == pytest.approx(col_diff, rel=0.05)
    np.testing.assert_allclose(hr, hr_diff, atol=0.08 * max(hr.max(), 1e-6)
                               + 1e-8, rtol=1.0)


@pytest.fixture(scope='module')
def half_cloudy(atm20):
    """The scene of tests/test_cross_native.py:20-30."""
    from er3t_tpu.rtm.scene import build_scene as jax_build_scene
    ab = abs_synthetic(650.0, atm20)
    cld = cld_gen_hom(nx=4, ny=4, nz=2, dx=1.0, dy=1.0, cot0=6.0, cer0=10.0,
                      cloud_base=1.0, cloud_top=3.0)
    cld.extinction[2:] = 0.0   # half cloudy, half clear
    cld.cer[2:] = 0.0
    scn, st = jax_build_scene(atm20, ab, cld=cld, surface=0.15,
                              solar_zenith_angle=30.0)
    return ab, scn, st


def test_flux_cross_validation(half_cloudy):
    """tests/test_cross_native.py:38-58: the port's domain-average fluxes
    against the independent native C++ solver (through the port's bridge)
    on the same scene."""
    from er3t_tpu_torch import native
    ab, scn, st = half_cloudy
    n = 60000
    cfg = SolverConfig(target='flux', batch=1 << 12, flux_per_column=False)
    t = run_transport_flight(*scene_from_numpy(scn, st, 'cpu'), cfg, n, 21,
                             'cpu')
    flux_port = t.flux[0, 0].numpy() / int(t.n_launched)
    _, flux_nat, n_nat = native.mc_ref_run(scn, st, albedo=0.15, sza_deg=30.0,
                                           saa_deg=0.0, n_photon=n, seed=77,
                                           do_radiance=False)
    flux_nat /= n_nat
    w = ab.weight
    for ch, name in [(0, 'down-direct'), (2, 'up')]:
        a = flux_port[:, ch, :] @ w
        b = flux_nat[:, ch, :] @ w
        sel = a > 1e-3
        np.testing.assert_allclose(a[sel], b[sel], rtol=0.05,
                                   err_msg=f'{name} mismatch')
    a = flux_port[0, 1, :] @ w
    b = flux_nat[0, 1, :] @ w
    assert a == pytest.approx(b, rel=0.08)


@pytest.mark.slow
def test_flux_kcross_clamp_equivalence(atm20):
    """tests/test_solver_modes.py:179-216: the crossing-count clamp is
    exact; per-column tallies with flux_kcross 4 match the unclamped path
    and the reference's event-marching engine within MC noise."""
    from er3t_tpu.rtm.mc import SolverConfig as JConfig, run_transport
    from er3t_tpu.rtm.scene import build_scene as jax_build_scene
    ab = abs_synthetic(650.0, atm20, ng=4)
    cld = cld_gen_hom(nx=4, ny=4, nz=2, dx=1.0, dy=1.0, cot0=6.0, cer0=10.0,
                      cloud_base=1.0, cloud_top=3.0)
    scn, st = jax_build_scene(atm20, ab, cld=cld, surface=0.15,
                              solar_zenith_angle=30.0)
    tscn, tst = scene_from_numpy(scn, st, 'cpu')
    n = 120_000
    w = ab.weight

    def profile(flux, n_l):
        return (np.asarray(flux) @ w).mean(axis=(0, 1)) / n_l * (st.nx * st.ny)

    base = dict(target='flux', batch=1 << 12, flux_per_column=True)
    t4 = run_transport_flight(tscn, tst, SolverConfig(**base, flux_kcross=4),
                              n, 41, 'cpu')
    t0 = run_transport_flight(tscn, tst, SolverConfig(**base, flux_kcross=0),
                              n, 42, 'cpu')
    tm = run_transport(scn, st, JConfig(**base), n, seed=43)
    f_k4 = profile(t4.flux.numpy(), int(t4.n_launched))
    f_k0 = profile(t0.flux.numpy(), int(t0.n_launched))
    f_mar = profile(tm.flux, int(tm.n_launched))
    for f in (f_k4, f_k0, f_mar):
        assert f[-1, 0] == pytest.approx(1.0, rel=1e-4)
    for ch in (0, 2):
        sel = f_k0[:, ch] > 1e-3
        np.testing.assert_allclose(f_k4[sel, ch], f_k0[sel, ch], rtol=0.06)
        np.testing.assert_allclose(f_k4[sel, ch], f_mar[sel, ch], rtol=0.06)
    assert f_k4[0, 1] == pytest.approx(f_mar[0, 1], rel=0.08)

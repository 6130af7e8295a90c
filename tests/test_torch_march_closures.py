"""The reference's tests of the event-marching engine, run on the port's
(er3t_tpu_torch.rtm.mc.run_transport and solve(flux_engine='marching'), on
the CPU): the five marching tests of tests/test_transport_1d.py, the two of
tests/test_cross_native.py against the independent C++ solver,
test_flux_engines_agree, the marching leg of
test_flux_kcross_clamp_equivalence and test_hr_fallback_has_std_and_runs
(tests/test_solver_modes.py), test_solve_flux_engines
(tests/test_solve_surface.py), test_distinct_ssa_distinct_flux
(tests/test_aer.py) and test_flight_matches_marching
(tests/test_constituents3d.py).  Tolerances, photon counts and ``slow``
marks are the reference's.  The delta-Eddington reference comes from
er3t_tpu (NumPy), the C++ solver through the port's own bridge
(er3t_tpu_torch.native, on the port's CPU tensors)."""

import numpy as np
import pytest
import torch

from er3t_tpu.physics import twostream
from er3t_tpu_torch.native import mc_ref_run
from er3t_tpu_torch.physics import rayleigh
from er3t_tpu_torch.pre.abs import abs_synthetic
from er3t_tpu_torch.pre.aer import Aerosol1D, Aerosol3D
from er3t_tpu_torch.pre.atm import atm_atmmod
from er3t_tpu_torch.pre.cld import cld_gen_hom
from er3t_tpu_torch.rtm import solver
from er3t_tpu_torch.rtm.mc import SolverConfig, run_transport
from er3t_tpu_torch.rtm.mc_flight import run_transport_flight
from er3t_tpu_torch.rtm.scene import build_scene

torch.set_num_threads(2)


def scene(atm, ab, **kw):
    return build_scene(atm, ab, device='cpu', **kw)


def march(scn, st, cfg, n, seed):
    return run_transport(scn, st, cfg, n, seed=seed, device='cpu')


@pytest.fixture(scope='module')
def atm20():
    return atm_atmmod(np.linspace(0, 20, 21))


# ---- tests/test_transport_1d.py ----

@pytest.fixture(scope='module')
def clear_run(atm20):
    """Shared clear-sky conservative marching run (pure Rayleigh,
    alb=0.3, sza=30)."""
    ab = abs_synthetic(650.0, atm20)
    ab.abso_coef[:] = 0.0
    scn, st = scene(atm20, ab, surface=0.3, solar_zenith_angle=30.0)
    tal = march(scn, st, SolverConfig(target='flux', batch=1 << 13), 60000, 7)
    n = int(tal.n_launched)
    flux = tal.flux.double().numpy()[0, 0] / n
    w = ab.weight
    return {'f_dir': flux[:, 0, :] @ w, 'f_dif': flux[:, 1, :] @ w,
            'f_up': flux[:, 2, :] @ w}


def test_budget_respected(atm20):
    ab = abs_synthetic(650.0, atm20)
    scn, st = scene(atm20, ab, surface=0.0)
    tal = march(scn, st, SolverConfig(target='flux', batch=1 << 12), 10000, 0)
    assert int(tal.n_launched) == 10000


def test_energy_conservation(clear_run):
    f = clear_run
    net_in = f['f_dir'][-1] + f['f_dif'][-1] - f['f_up'][-1]
    absorbed_sfc = (f['f_dir'][0] + f['f_dif'][0]) * (1 - 0.3)
    assert net_in == pytest.approx(absorbed_sfc, rel=0.01)


def test_direct_beam_beer_law(clear_run):
    mu0 = np.cos(np.deg2rad(30.0))
    tau = rayleigh.rayleigh_od(650.0, np.array([1013.25, 55.3]),
                               lat_deg=30.0)[0]
    assert clear_run['f_dir'][0] == pytest.approx(np.exp(-tau / mu0),
                                                  rel=0.01)


def test_flux_vs_delta_eddington(clear_run, atm20):
    mu0 = np.cos(np.deg2rad(30.0))
    tau_ray = rayleigh.rayleigh_od(650.0, atm20.lev.pressure, lat_deg=30.0)
    de = twostream.delta_eddington_flux(tau_ray, np.ones(20) - 1e-9,
                                        np.zeros(20), mu0=mu0, albedo=0.3)
    assert clear_run['f_up'][-1] == pytest.approx(de['f_up'][-1] / mu0,
                                                  rel=0.03)
    f_dn_sfc = clear_run['f_dir'][0] + clear_run['f_dif'][0]
    assert f_dn_sfc == pytest.approx(de['f_down'][0] / mu0, rel=0.01)


def test_radiance_single_scatter_anchor(atm20):
    """Nadir marching radiance over a Lambertian surface: above the
    single-scatter Rayleigh + surface term, within 10 %."""
    ab = abs_synthetic(650.0, atm20)
    ab.abso_coef[:] = 0.0
    alb, sza = 0.3, 30.0
    mu0 = np.cos(np.deg2rad(sza))
    scn, st = scene(atm20, ab, surface=alb, solar_zenith_angle=sza)
    tal = march(scn, st, SolverConfig(target='radiance', batch=1 << 13),
                100000, 3)
    rad = float(tal.rad.double().numpy()[0, 0] @ ab.weight) \
        / int(tal.n_launched)
    tau = rayleigh.rayleigh_od(650.0, np.array([1013.25, 55.3]),
                               lat_deg=30.0)[0]
    p_ray = 0.75 * (1 + mu0 ** 2)
    ss = p_ray / (4 * np.pi) * (1 - np.exp(-tau * (1 + 1 / mu0))) / (1 + mu0)
    sfc = alb / np.pi * np.exp(-tau / mu0) * np.exp(-tau)
    assert rad == pytest.approx(ss + sfc, rel=0.10)
    assert rad > ss + sfc


# ---- tests/test_cross_native.py ----

@pytest.fixture(scope='module')
def native_scene():
    atm = atm_atmmod(np.linspace(0, 20, 21))
    ab = abs_synthetic(650.0, atm)
    cld = cld_gen_hom(nx=4, ny=4, nz=2, dx=1.0, dy=1.0, cot0=6.0, cer0=10.0,
                      cloud_base=1.0, cloud_top=3.0)
    cld.extinction[2:] = 0.0   # half cloudy, half clear
    cld.cer[2:] = 0.0
    scn, st = scene(atm, ab, cld=cld, surface=0.15, solar_zenith_angle=30.0)
    return ab, scn, st


def test_flux_cross_validation(native_scene):
    ab, scn, st = native_scene
    n = 60000
    cfg = SolverConfig(target='flux', batch=1 << 12, flux_per_column=False)
    t = march(scn, st, cfg, n, 21)
    flux_mc = t.flux.double().numpy()[0, 0] / int(t.n_launched)
    _, flux_nat, n_nat = mc_ref_run(scn, st, albedo=0.15, sza_deg=30.0,
                                    saa_deg=0.0, n_photon=n, seed=77,
                                    do_radiance=False)
    flux_nat /= n_nat
    w = ab.weight
    for ch, name in [(0, 'down-direct'), (2, 'up')]:
        a = flux_mc[:, ch, :] @ w
        b = flux_nat[:, ch, :] @ w
        sel = a > 1e-3
        np.testing.assert_allclose(a[sel], b[sel], rtol=0.05,
                                   err_msg=f'{name} mismatch')
    assert flux_mc[0, 1, :] @ w == pytest.approx(flux_nat[0, 1, :] @ w,
                                                 rel=0.08)


def test_per_g_spectral_agreement(native_scene):
    """Per-g surface direct flux of the marching engine against the C++
    solver (not just the weighted sum)."""
    ab, scn, st = native_scene
    n = 60000
    cfg = SolverConfig(target='flux', batch=1 << 12, flux_per_column=False)
    t = march(scn, st, cfg, n, 41)
    f_mc = t.flux.double().numpy()[0, 0, 0, 0, :] / int(t.n_launched)
    _, flux_nat, n_nat = mc_ref_run(scn, st, albedo=0.15, sza_deg=30.0,
                                    saa_deg=0.0, n_photon=n, seed=55,
                                    do_radiance=False)
    np.testing.assert_allclose(f_mc, flux_nat[0, 0, :] / n_nat, rtol=0.05)


# ---- tests/test_solver_modes.py ----

def _hom_scene(atm, ng=16):
    ab = abs_synthetic(650.0, atm, ng=ng)
    cld = cld_gen_hom(nx=4, ny=4, nz=2, dx=1.0, dy=1.0, cot0=6.0, cer0=10.0,
                      cloud_base=1.0, cloud_top=3.0)
    return ab, scene(atm, ab, cld=cld, surface=0.15, solar_zenith_angle=30.0)


@pytest.mark.slow
def test_flux_engines_agree(atm20):
    """Flight flux tallies match the marching engine's within MC noise,
    per channel and level."""
    ab, (scn, st) = _hom_scene(atm20)
    n = 100_000
    w = ab.weight
    cfg = SolverConfig(target='flux', batch=1 << 12, flux_per_column=False)
    fm = march(scn, st, cfg, n, 21).flux.double().numpy()[0, 0] / n
    tf = run_transport_flight(scn, st, cfg, n, 33, 'cpu')
    ff = tf.flux.double().numpy()[0, 0] / int(tf.n_launched)
    for ch in (0, 2):
        a, b = fm[:, ch, :] @ w, ff[:, ch, :] @ w
        sel = a > 1e-3
        np.testing.assert_allclose(b[sel], a[sel], rtol=0.05)
    assert (ff[0, 1, :] @ w) == pytest.approx(fm[0, 1, :] @ w, rel=0.08)


@pytest.mark.slow
def test_flux_kcross_clamp_equivalence_marching_leg(atm20):
    """The marching leg of test_flux_kcross_clamp_equivalence: per-column
    marching tallies (domain mean over columns) agree with the clamped
    flight tallies within 6 % per channel and level; TOA down-direct is
    exactly 1 per photon in both."""
    ab, (scn, st) = _hom_scene(atm20, ng=4)
    n = 120_000
    w = ab.weight

    def profile(tal):
        f = tal.flux.double().numpy() @ w
        return f.mean(axis=(0, 1)) / int(tal.n_launched) * (st.nx * st.ny)

    base = dict(target='flux', batch=1 << 12, flux_per_column=True)
    f_k4 = profile(run_transport_flight(
        scn, st, SolverConfig(**base, flux_kcross=4), n, 41, 'cpu'))
    f_mar = profile(march(scn, st, SolverConfig(**base), n, 43))
    for f in (f_k4, f_mar):
        assert f[-1, 0] == pytest.approx(1.0, rel=1e-4)
    for ch in (0, 2):
        sel = f_k4[:, ch] > 1e-3
        np.testing.assert_allclose(f_k4[sel, ch], f_mar[sel, ch], rtol=0.06)


def test_hr_fallback_has_std_and_runs(atm20):
    """The flux-divergence hr fallback of marching runs populates
    std['hr_std'] and every run's 'hr'."""
    ab = abs_synthetic(650.0, atm20)
    res = solver.solve(atm=atm20, abs_coef=ab, surface=0.1,
                       target='heating_rate', flux_engine='marching',
                       photons=20000, n_run=2, batch=1 << 11, mode='all',
                       device='cpu')
    assert 'hr' in res.data and 'hr_std' in res.std
    assert all('hr' in r for r in res.runs)
    assert np.shape(res['hr'])[-1] == 20 and np.isfinite(res['hr']).all()


def test_qmc_launch_warns_for_marching(atm20):
    """qmc_launch only affects the flight kernel: a marching flux run
    warns, as the reference's solve does (:358-362)."""
    ab = abs_synthetic(650.0, atm20)
    with pytest.warns(UserWarning, match='qmc_launch only affects'):
        solver.solve(atm=atm20, abs_coef=ab, target='flux',
                     flux_engine='marching', qmc_launch=True, photons=500,
                     n_run=1, batch=256, device='cpu')


# ---- tests/test_solve_surface.py ----

def test_solve_flux_engines():
    atm = atm_atmmod(np.linspace(0, 20, 21))
    ab = abs_synthetic(650.0, atm, ng=4)
    cld = cld_gen_hom(nx=8, ny=8, nz=2, dx=0.5, dy=0.5, cot0=6.0, cer0=10.0,
                      cloud_base=1.0, cloud_top=3.0)
    cld.extinction[4:] = 0.0
    kw = dict(atm=atm, abs_coef=ab, cld=cld, surface=0.1,
              solar_zenith_angle=30.0, n_run=1, batch=1 << 12, seed=3,
              target='flux', flux_per_column=False, photons=60000,
              device='cpu')
    rf = solver.solve(flux_engine='flight', **kw)
    rm = solver.solve(flux_engine='marching', **{**kw, 'seed': 11})
    assert float(rf['f_down'][0, 0, 0]) == pytest.approx(
        float(rm['f_down'][0, 0, 0]), rel=0.06)


# ---- tests/test_aer.py ----

def test_distinct_ssa_distinct_flux(atm20):
    """Two aerosol layers of different ssa give different flux profiles,
    and the marching engine agrees with the flight engine per
    constituent."""
    ab = abs_synthetic(650.0, atm20, ng=4)
    kw = dict(atm=atm20, abs_coef=ab, surface=0.2, target='flux',
              solar_zenith_angle=30.0, photons=80000, n_run=1,
              batch=1 << 12, flux_per_column=False, device='cpu')
    absorbing = Aerosol1D(aod=0.8, ssa=0.4, asy=0.7, z_bottom=0.0, z_top=2.0)
    conserv = Aerosol1D(aod=0.8, ssa=1.0, asy=0.7, z_bottom=0.0, z_top=2.0)
    high = Aerosol1D(aod=0.3, ssa=1.0, asy=0.7, z_bottom=3.0, z_top=6.0)
    f_abs = solver.solve(aer_1ds=[absorbing, high], seed=3, **kw)
    f_con = solver.solve(aer_1ds=[conserv, high], seed=4, **kw)
    sfc_abs = float(f_abs['f_down'][0, 0, 0])
    sfc_con = float(f_con['f_down'][0, 0, 0])
    assert sfc_abs < 0.85 * sfc_con
    f_mar = solver.solve(aer_1ds=[absorbing, high], seed=5,
                         flux_engine='marching', **kw)
    assert sfc_abs == pytest.approx(float(f_mar['f_down'][0, 0, 0]), rel=0.06)


# ---- tests/test_constituents3d.py ----

@pytest.mark.slow
def test_flight_matches_marching():
    """The two engines implement the same per-constituent selection
    (overlapping cloud and isotropic 3D aerosol, multiple scattering)."""
    atm = atm_atmmod(np.concatenate([np.arange(0, 5.0, 0.5),
                                     np.arange(5.0, 20.1, 1.0)]))
    ab = abs_synthetic(650.0, atm, ng=2)
    cld = cld_gen_hom(nx=4, ny=4, nz=2, dx=1.0, dy=1.0, cot0=4.0,
                      cer0=10.0, cloud_base=1.0, cloud_top=2.0)
    aer = Aerosol3D(extinction=np.asarray(cld.extinction) * 0.5, ssa=0.9,
                    asy=0.0)
    scn, st = scene(atm, ab, cld=cld, aer_3ds=[aer], surface=0.0,
                    solar_zenith_angle=30.0)
    cfg = SolverConfig(target='radiance', batch=1 << 13, n_scat_max=300)

    def mean_rad(tal):
        return float(tal.rad.double().sum()) / int(tal.n_launched)
    f = mean_rad(run_transport_flight(scn, st, cfg, 300_000, 5, 'cpu'))
    m = mean_rad(march(scn, st, cfg, 300_000, 11))
    assert f == pytest.approx(m, rel=0.05)


@pytest.mark.slow
def test_march_direct_beam_at_scale_matches_reference(capsys):
    """Clear sky, domain-average tallies at 2^14 lanes: in one run of 1.6e6
    photons the port's surface direct flux equals the reference's within
    MC noise (both add every crossing to one f32 row, in one order on the
    CPU, so both drift above Beer's law as the row grows); in 16 runs of
    1e5 photons summed in f64 the port's agrees with Beer's law within 5
    sigma.  Each departure from Beer's law is printed, with the flight
    engine's (which sums a step's lanes before it adds them)."""
    from er3t_tpu.pre.abs import abs_synthetic as jabs
    from er3t_tpu.pre.atm import atm_atmmod as jatm
    from er3t_tpu.rtm import mc as jmc
    from er3t_tpu.rtm.mc_flight import run_transport_flight as jflight
    from er3t_tpu.rtm.scene import build_scene as jbuild
    from er3t_tpu_torch.rtm.scene import scene_from_numpy
    levels = np.concatenate([np.arange(0, 3.0, 0.5), np.arange(3.0, 20.1, 1.0)])
    atm = jatm(levels)
    ab = jabs(650.0, atm)
    scn, st = jbuild(atm, ab, surface=0.03, solar_zenith_angle=30.0)
    s_t, st_t = scene_from_numpy(scn, st, 'cpu')
    mu0 = np.cos(np.deg2rad(30.0))
    dz = np.diff(np.asarray(scn.z_lev))
    tau = (np.asarray(scn.sig_ray)[:, None] + np.asarray(scn.kabs)) \
        * dz[:, None]
    beer = np.exp(-tau.sum(0) / mu0) @ ab.weight
    n = 1_600_000
    cfg = dict(target='flux', batch=1 << 14, flux_per_column=False)

    def direct(tals):
        tot = sum(np.asarray(t.flux, np.float64)[0, 0, 0, 0] @ ab.weight
                  for t in tals)
        return float(tot / sum(int(t.n_launched) for t in tals)) / beer - 1
    d = {'reference': direct([jmc.run_transport(
            scn, st, jmc.SolverConfig(**cfg), n, seed=5)]),
         'port': direct([run_transport(s_t, st_t, SolverConfig(**cfg), n,
                                       seed=5, device='cpu')]),
         'port_16x1e5': direct([run_transport(
             s_t, st_t, SolverConfig(**cfg), n // 16, seed=100 + k,
             device='cpu') for k in range(16)]),
         'flight': direct([jflight(scn, st, jmc.SolverConfig(**cfg), n,
                                   seed=6)])}
    with capsys.disabled():
        print('\nsurface direct flux / Beer - 1:', d)
    # binomial noise of the direct fraction: sqrt((1 - p) / (p n)) ~ 2e-4
    sigma = 2e-4
    assert d['port'] == pytest.approx(d['reference'], abs=5 * sigma)
    assert abs(d['port_16x1e5']) < 5 * sigma

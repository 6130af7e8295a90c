"""The port's 1D doubling-adding solver (er3t_tpu_torch.rtm.oned, a NumPy
copy) against er3t_tpu.rtm.oned bit for bit, and the reference's six
tests of tests/test_oned.py on the port, with the Monte Carlo legs through
the port's solve(device='cpu')."""

import numpy as np
import pytest
import torch

from er3t_tpu.rtm import oned as joned
from er3t_tpu_torch.pre.abs import abs_synthetic
from er3t_tpu_torch.pre.atm import atm_atmmod
from er3t_tpu_torch.pre.cld import cld_gen_hom
from er3t_tpu_torch.rtm import oned as toned
from er3t_tpu_torch.rtm import solver as tsolver
from er3t_tpu_torch.rtm.oned import (hg_moments, rayleigh_moments,
                                     solve_plane_parallel)
from er3t_tpu_torch.rtm.scene import build_scene

torch.set_num_threads(2)


def _same(a, b):
    """Bit for bit: equal values, shapes and types, dicts key by key."""
    if isinstance(b, dict):
        assert set(a) == set(b)
        for k in b:
            _same(a[k], b[k])
        return
    if isinstance(b, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
        return
    assert type(a) is type(b)
    np.testing.assert_array_equal(a, b, strict=True)


def test_oned_public_functions_bit_for_bit():
    assert toned.__all__ == joned.__all__
    for g in (0.0, 0.7, 0.85):
        for n in (1, 3, 64):
            _same(toned.hg_moments(g, n), joned.hg_moments(g, n))
    for n in (1, 2, 3, 32):
        _same(toned.rayleigh_moments(n), joned.rayleigh_moments(n))
    rng = np.random.default_rng(4)
    cases = [
        dict(tau=[0.3], ssa=[1.0], moments=joned.rayleigh_moments(3),
             mu0=0.8, mu_v=0.6, dphi=1.0),
        dict(tau=[0.2, 4.0, 0.05], ssa=[1.0, 0.99, 0.8],
             moments=np.vstack([joned.rayleigh_moments(64),
                                joned.hg_moments(0.85, 64),
                                joned.hg_moments(0.6, 64)]),
             mu0=0.7, mu_v=0.9, dphi=np.array([0.0, 0.5, np.pi]),
             surface_albedo=0.2, flux=True),
        dict(tau=rng.uniform(0.01, 2.0, 5), ssa=rng.uniform(0.5, 1.0, 5),
             moments=joned.hg_moments(0.75, 40), mu0=0.5, mu_v=0.55,
             dphi=0.3, n_streams=8, delta_m=False, tms=False),
        dict(tau=[20.0], ssa=[1.0], moments=joned.hg_moments(0.85, 128),
             mu0=0.8, mu_v=0.5, dphi=0.7, n_streams=12, n_modes=5,
             flux=True),
    ]
    for kw in cases:
        _same(toned.solve_plane_parallel(**kw), joned.solve_plane_parallel(**kw))
    # the private helpers the solver is built from
    mu = np.linspace(0.05, 1.0, 7)
    for m in (0, 1, 4, 9):
        _same(toned._norm_assoc_legendre(m, 8, mu),
              joned._norm_assoc_legendre(m, 8, mu))
    _same(toned._single_scatter_toa([0.1, 0.4], [1.0, 0.9], [1.3, 0.7],
                                    0.6, 0.8),
          joned._single_scatter_toa([0.1, 0.4], [1.0, 0.9], [1.3, 0.7],
                                    0.6, 0.8))


# ---- tests/test_oned.py on the port ----

def test_thin_limit_single_scattering():
    mu0, muv = 0.8, 0.6
    tau = 1e-4
    for dphi in (0.0, 1.0, np.pi):
        cs = -muv * mu0 + np.sqrt((1 - muv ** 2) * (1 - mu0 ** 2)) * np.cos(dphi)
        p = 0.75 * (1 + cs ** 2)
        k = 1 / mu0 + 1 / muv
        i1 = p / (4 * np.pi) * mu0 / (mu0 + muv) * -np.expm1(-tau * k)
        r = solve_plane_parallel([tau], [1.0], rayleigh_moments(3), mu0, muv,
                                 dphi, n_streams=16, delta_m=False, tms=False)
        assert r == pytest.approx(i1, rel=1e-3)


def test_conservation_and_stream_convergence():
    rads = []
    for ns in (8, 16, 32):
        r, fl = solve_plane_parallel([20.0], [1.0], hg_moments(0.85, 128),
                                     0.8, 0.5, 0.7, n_streams=ns, flux=True)
        tot = fl['f_up_toa'] + fl['f_dn_sfc_direct'] + fl['f_dn_sfc_diffuse']
        assert tot == pytest.approx(0.8, rel=3e-3)
        rads.append(r)
    assert rads[0] == pytest.approx(rads[2], rel=2e-3)
    assert rads[1] == pytest.approx(rads[2], rel=1e-3)


def test_lambertian_surface_coupling():
    tau, mu0, muv, alb = 0.5, 0.7, 0.9, 0.4
    r = solve_plane_parallel([tau], [1e-9], hg_moments(0.0, 4), mu0, muv,
                             0.0, surface_albedo=alb, n_streams=8)
    exact = alb / np.pi * mu0 * np.exp(-tau / mu0) * np.exp(-tau / muv)
    assert r == pytest.approx(exact, rel=1e-3)


@pytest.fixture(scope='module')
def mc_env():
    atm = atm_atmmod(np.linspace(0, 20, 21))
    ab = abs_synthetic(650.0, atm, ng=1)
    return atm, ab


def _mc_reflectance_units(res):
    return float(np.asarray(res['rad']).mean()) / res.toa


def test_mc_vs_doubling_adding_clear(mc_env):
    """Clear Rayleigh + gas sky: the port's MC radiance matches the
    deterministic solver within MC noise (tests/test_oned.py:67)."""
    atm, ab = mc_env
    for sza, alb in ((30.0, 0.2), (60.0, 0.05)):
        scn, st = build_scene(atm, ab, surface=alb, solar_zenith_angle=sza,
                              device='cpu')
        dz = (scn.z_lev[1:] - scn.z_lev[:-1]).numpy()
        tau_ray = scn.sig_ray.numpy() * dz
        tau = tau_ray + scn.kabs[:, 0].numpy() * dz
        ssa = tau_ray / np.maximum(tau, 1e-12)
        res = tsolver.solve(atm=atm, abs_coef=ab, surface=alb,
                            target='radiance', solar_zenith_angle=sza,
                            photons=150000, n_run=1, batch=1 << 12, seed=11,
                            device='cpu')
        i_da = solve_plane_parallel(tau, ssa, rayleigh_moments(4),
                                    np.cos(np.deg2rad(sza)), 1.0, 0.0,
                                    surface_albedo=alb, n_streams=16)
        assert _mc_reflectance_units(res) == pytest.approx(i_da, rel=0.02), \
            (sza, alb)


@pytest.mark.slow
def test_mc_vs_doubling_adding_cloud(mc_env):
    """Homogeneous HG cloud: nadir MC radiance matches doubling-adding
    (delta-M + TMS) within MC noise (tests/test_oned.py:91)."""
    atm, ab = mc_env
    cld = cld_gen_hom(nx=2, ny=2, nz=2, dx=1.0, dy=1.0, cot0=8.0, cer0=10.0,
                      cloud_base=1.0, cloud_top=3.0)
    for sza in (30.0, 60.0):
        alb = 0.1
        scn, st = build_scene(atm, ab, cld=cld, surface=alb,
                              solar_zenith_angle=sza, device='cpu')
        dz = (scn.z_lev[1:] - scn.z_lev[:-1]).numpy()
        tau_ray = scn.sig_ray.numpy() * dz
        tau_abs = scn.kabs[:, 0].numpy() * dz
        tau_cld = np.zeros_like(tau_ray)
        tau_cld[st.iz3l:st.iz3l + st.nz3] = \
            scn.ext3d[0, 0].numpy() * dz[st.iz3l:st.iz3l + st.nz3]
        tau = tau_ray + tau_abs + tau_cld
        ssa = (tau_ray + tau_cld) / np.maximum(tau, 1e-12)
        nmom = 128
        wc = tau_cld / np.maximum(tau_ray + tau_cld, 1e-12)
        mom = ((1 - wc)[:, None] * rayleigh_moments(nmom)[None, :]
               + wc[:, None] * hg_moments(0.85, nmom)[None, :])
        res = tsolver.solve(atm=atm, abs_coef=ab, cld=cld, surface=alb,
                            target='radiance', solar_zenith_angle=sza,
                            photons=250000, n_run=1, batch=1 << 12, seed=12,
                            device='cpu')
        i_da = solve_plane_parallel(tau, ssa, mom, np.cos(np.deg2rad(sza)),
                                    1.0, 0.0, surface_albedo=alb,
                                    n_streams=16)
        assert _mc_reflectance_units(res) == pytest.approx(i_da, rel=0.03), \
            sza


def test_multilayer_surface_diffuse_closure():
    mu0 = np.cos(np.deg2rad(30.0))
    mom1 = rayleigh_moments(3)
    results = []
    for taus in ([0.4], [0.2, 0.2], [0.1] * 4):
        n = len(taus)
        _, fl = solve_plane_parallel(np.array(taus), np.ones(n),
                                     np.tile(mom1, (n, 1)), mu0, 0.8,
                                     np.array([0.0]), surface_albedo=0.0,
                                     flux=True)
        total = (fl['f_up_toa'] + fl['f_dn_sfc_direct']
                 + fl['f_dn_sfc_diffuse'])
        assert total == pytest.approx(mu0, rel=1e-4)
        results.append(fl['f_dn_sfc_diffuse'])
    assert results[0] == pytest.approx(results[1], rel=1e-6)
    assert results[0] == pytest.approx(results[2], rel=1e-6)
    kw = dict(mu0=mu0, mu_v=0.8, dphi=np.array([0.0]), surface_albedo=0.2,
              flux=True)
    _, f2 = solve_plane_parallel(
        np.array([0.3, 5.0]), np.array([1.0, 0.99]),
        np.vstack([rayleigh_moments(32), hg_moments(0.85, 32)]), **kw)
    _, f4 = solve_plane_parallel(
        np.array([0.15, 0.15, 2.5, 2.5]), np.array([1.0, 1.0, 0.99, 0.99]),
        np.vstack([rayleigh_moments(32)] * 2 + [hg_moments(0.85, 32)] * 2),
        **kw)
    for k in f2:
        assert f2[k] == pytest.approx(f4[k], rel=1e-6)

"""The flux branch under collision forcing and IPA, against er3t_tpu.

1. One step at a time with injected deviates (the harness of
   tests/test_torch_flight_modes.py) in the three flux tally forms: the
   compact per-column tally (crossing-count clamp, in-step contraction
   ``flux_w``), the full per-column tally (``flux_kcross=0``) and the
   domain average with the direct absorbed-energy tally; with ``cf_dtau``
   (the deterministic escape branch in each form) and under IPA (crossings
   tallied in the birth column).
2. The reference's closures of these options with the port's engine and
   front door in place of er3t_tpu's, each named in its docstring.
"""

import dataclasses

import numpy as np
import pytest
import torch

from er3t_tpu.pre.atm import atm_atmmod
from er3t_tpu.pre.abs import abs_synthetic
from er3t_tpu.pre.cld import cld_gen_hom
from er3t_tpu_torch.rtm import out as tout
from er3t_tpu_torch.rtm.mc import SolverConfig
from er3t_tpu_torch.rtm.mc_flight import run_transport_flight
from er3t_tpu_torch.rtm.scene import build_scene
from er3t_tpu_torch.rtm.solver import solve

from test_torch_flight_modes import FORCED_RTOL, broken, step_parity

torch.set_num_threads(2)
BASE = dict(target='flux', batch=4096, n_scat_max=300, tile_size=16,
            qmc_launch=True)
FORMS = {
    'kx4_flux_w': dict(flux_per_column=True, flux_kcross=4),
    'kx0': dict(flux_per_column=True, flux_kcross=0),
    'domain_absorbed': dict(flux_per_column=False),
}


@pytest.mark.parametrize('form', list(FORMS))
@pytest.mark.parametrize('mode', ['cf_dtau', 'ipa'])
def test_flux_mode_step_parity_with_injected_deviates(mode, form):
    _, scn, st, _, flux_w = broken()
    kw = dict(BASE, **FORMS[form])
    if mode == 'cf_dtau':
        kw['cf_dtau'] = 2.0
    else:
        st = dataclasses.replace(st, ipa=True)
    got, kern = step_parity(
        scn, st, kw, steps=6,
        flux_w=flux_w if form == 'kx4_flux_w' else None,
        flight_rtol=FORCED_RTOL if mode == 'cf_dtau' else 2e-6)
    assert (kern.kx, kern.tally_absorbed) == {
        'kx4_flux_w': (4, False), 'kx0': (0, False),
        'domain_absorbed': (0, True)}[form]
    assert float(got.flux.sum()) > 0


@pytest.fixture(scope='module')
def atm20():
    return atm_atmmod(np.linspace(0, 20, 21))


def test_cf_dtau_surface_up_flux(atm20):
    """tests/test_solver_modes.py:744-764: collision forcing keeps f_up at
    the surface level on the full-crossing tally path within 5 %."""
    ab = abs_synthetic(650.0, atm20)
    ab.abso_coef[:] = 0.0
    scn, st = build_scene(atm20, ab, surface=0.4, solar_zenith_angle=30.0,
                          device='cpu')
    ups = {}
    for cf in (0.0, 0.5):
        cfg = SolverConfig(target='flux', batch=1 << 12, cf_dtau=cf,
                           flux_kcross=0, flux_per_column=False,
                           n_scat_max=200)
        t = run_transport_flight(scn, st, cfg, 120_000, 3, 'cpu')
        flux = t.flux.numpy().reshape(1, 1, st.nz + 1, 3, st.ng)
        ups[cf] = float((flux[0, 0, 0, 2] @ ab.weight) / int(t.n_launched))
    assert ups[0.5] == pytest.approx(ups[0.0], rel=0.05)
    assert ups[0.5] > 0.2


def test_ipa_equals_3d_for_homogeneous(atm20):
    """tests/test_transport_1d.py:106-114: IPA and 3D agree (3 %) on a
    horizontally homogeneous scene."""
    ab = abs_synthetic(650.0, atm20)
    kw = dict(atm=atm20, abs_coef=ab, surface=0.1, target='flux',
              solar_zenith_angle=30.0, photons=40000, n_run=1, batch=1 << 12,
              device='cpu')
    r3d = solve(solver='3d', seed=11, **kw)
    ripa = solve(solver='ipa', seed=12, **kw)
    np.testing.assert_allclose(r3d['f_up'][0, 0, -1], ripa['f_up'][0, 0, -1],
                               rtol=0.03)


@pytest.mark.slow
def test_flux_collision_forcing_unbiased(atm20):
    """tests/test_solver_modes.py:218-256: the forced branch plus the
    deterministic escape branch leave every level and channel flux of both
    the domain-average and the per-column tallies unchanged."""
    ab = abs_synthetic(650.0, atm20, ng=4)
    cld = cld_gen_hom(nx=4, ny=4, nz=2, dx=1.0, dy=1.0, cot0=6.0, cer0=10.0,
                      cloud_base=1.0, cloud_top=3.0)
    scn, st = build_scene(atm20, ab, cld=cld, surface=0.15,
                          solar_zenith_angle=30.0, device='cpu')
    n = 150_000
    w = ab.weight

    def profile(percol, cf, seed):
        cfg = SolverConfig(target='flux', batch=1 << 12,
                           flux_per_column=percol, cf_dtau=cf)
        tal = run_transport_flight(scn, st, cfg, n, seed, 'cpu')
        f = tal.flux.numpy() @ w
        return f.mean(axis=(0, 1)) / int(tal.n_launched) * \
            (f.shape[0] * f.shape[1])

    for percol in (False, True):
        f0 = profile(percol, 0.0, 51)
        f2 = profile(percol, 2.0, 52)
        assert f2[-1, 0] == pytest.approx(1.0, rel=1e-4)
        for ch in (0, 2):
            sel = f0[:, ch] > 1e-3
            np.testing.assert_allclose(f2[sel, ch], f0[sel, ch], rtol=0.06,
                                       atol=5e-4)
        assert f2[0, 1] == pytest.approx(f0[0, 1], rel=0.08)


@pytest.mark.slow
def test_flux_per_column_normalization(atm20):
    """tests/test_solver_modes.py:99-118: per-column fluxes have the
    magnitude of the domain-average ones; TOA down-direct is E mu0 in
    every column."""
    ab = abs_synthetic(650.0, atm20)
    cld = cld_gen_hom(nx=4, ny=4, dx=1.0, dy=1.0, cot0=4.0, cer0=10.0,
                      cloud_base=1.0, cloud_top=2.0)
    kw = dict(atm=atm20, abs_coef=ab, cld=cld, surface=0.2, target='flux',
              solar_zenith_angle=30.0, photons=120000, n_run=1,
              batch=1 << 12, seed=6, device='cpu')
    r_col = solve(flux_per_column=True, **kw)
    r_dom = solve(flux_per_column=False, **kw)
    np.testing.assert_allclose(r_col['f_down_direct'][:, :, -1],
                               r_dom['f_down_direct'][0, 0, -1], rtol=1e-3)
    assert r_col['f_down'][..., 0].mean() == pytest.approx(
        float(r_dom['f_down'][0, 0, 0]), rel=0.05)


@pytest.mark.slow
def test_heating_rate_direct_lower_noise():
    """tests/test_solver_modes.py:586-618: the direct tally's seed spread
    is no worse than 1.15 x that of net-flux differencing."""
    atm2 = atm_atmmod(np.concatenate([np.arange(0, 5.0, 0.5),
                                      np.arange(5.0, 20.1, 1.0)]))
    ab = abs_synthetic(940.0, atm2)
    cld = cld_gen_hom(nx=4, ny=4, dx=1.0, dy=1.0, cot0=8.0, cer0=10.0,
                      cloud_base=1.0, cloud_top=2.0)
    hrs_d, hrs_f = [], []
    for s in range(4):
        res = solve(atm=atm2, abs_coef=ab, cld=cld, target='heating_rate',
                    surface=0.2, solar_zenith_angle=30.0, photons=1e5,
                    n_run=1, seed=100 + s, device='cpu')
        hrs_d.append(np.asarray(res['hr']))
        f_dn = np.asarray(res['f_down'])[0, 0]
        f_up = np.asarray(res['f_up'])[0, 0]
        hrs_f.append(tout.heating_rate(
            {'f_down': f_dn[None, None], 'f_up': f_up[None, None]},
            atm2)[0, 0])
    sd_d = np.stack(hrs_d).std(axis=0).mean()
    sd_f = np.stack(hrs_f).std(axis=0).mean()
    assert sd_d < 1.15 * sd_f

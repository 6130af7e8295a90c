"""The reference's closures of partial 3D, pathlength and the variance knobs
(collision forcing, splitting, tiles, lane sorting and the coherent
launch), with the port's flight engine and front door in place of
er3t_tpu's, each named in its docstring and held to its thresholds."""

import numpy as np
import pytest
import torch

from er3t_tpu.pre.atm import atm_atmmod
from er3t_tpu.pre.abs import abs_synthetic
from er3t_tpu.pre.cld import cld_gen_hem, cld_gen_hom
from er3t_tpu_torch.rtm.mc import SolverConfig
from er3t_tpu_torch.rtm.mc_flight import run_transport_flight
from er3t_tpu_torch.rtm.scene import build_scene
from er3t_tpu_torch.rtm.solver import solve

torch.set_num_threads(2)


@pytest.fixture(scope='module')
def atm20():
    return atm_atmmod(np.linspace(0, 20, 21))


@pytest.fixture(scope='module')
def base(atm20):
    """The scene of tests/test_solve_surface.py:16-25."""
    ab = abs_synthetic(650.0, atm20, ng=4)
    cld = cld_gen_hom(nx=8, ny=8, nz=2, dx=0.5, dy=0.5, cot0=6.0, cer0=10.0,
                      cloud_base=1.0, cloud_top=3.0)
    cld.extinction[4:] = 0.0
    return dict(atm=atm20, abs_coef=ab, cld=cld, surface=0.1,
                solar_zenith_angle=30.0, photons=30000, n_run=1,
                batch=1 << 12, seed=3, device='cpu')


def _broken_atm():
    return atm_atmmod(np.concatenate([np.arange(0, 3.0, 0.5),
                                      np.arange(3.0, 20.1, 2.0)]))


def test_solve_pathlength(base):
    """tests/test_solve_surface.py:54-59: the mean pathlength of detected
    photons spans the TOA-surface-TOA scale."""
    res = solve(pathlength=True, **base)
    plen = res['plen']
    assert plen.shape == res['rad'].shape
    assert 2.0e4 < np.median(plen[plen > 0]) < 3.0e5


def test_solve_forcing_tile_and_split(base):
    """tests/test_solve_surface.py:62-67: forcing, tiles and splitting
    together keep the domain mean within 8 %."""
    r0 = solve(**base)
    r1 = solve(cf_dtau=1.0, tile_size=4, split_wmax=0.5, **{**base, 'seed': 9})
    assert float(r1['rad'].mean()) == pytest.approx(float(r0['rad'].mean()),
                                                    rel=0.08)


@pytest.mark.slow
def test_solve_p3d_limits(base):
    """tests/test_solve_surface.py:38-51: a pinning order no photon reaches
    is full 3D (3 %); order 1 is a columnar approximation of the same
    magnitude."""
    kw = {**base, 'photons': 60000, 'target': 'radiance'}
    r3d = solve(solver='3d', **kw)
    rhi = solve(solver='p3d', p3d_order=500, **kw)
    rp1 = solve(solver='p3d', p3d_order=1, **{**kw, 'seed': 5})
    m3, mh, mp = (float(r['rad'].mean()) for r in (r3d, rhi, rp1))
    assert mh == pytest.approx(m3, rel=0.03)
    assert 0.6 * m3 < mp < 1.6 * m3
    assert np.all(np.isfinite(rp1['rad']))


@pytest.mark.slow
def test_collision_forcing_unbiased():
    """tests/test_solver_modes.py:151-177: cf_dtau leaves the radiance
    domain mean within 3 %."""
    atm_f = _broken_atm()
    ab = abs_synthetic(650.0, atm_f)
    cld = cld_gen_hem(nx=32, ny=32, nz=4, dx=0.2, dy=0.2, dz=0.5,
                      cloud_frac_tgt=0.3, radii=(0.8, 1.6), cot_scale=12.0,
                      cloud_base=0.5, seed=3)
    scn, st = build_scene(atm_f, ab, cld=cld, surface=0.05,
                          solar_zenith_angle=30.0, solar_azimuth_angle=45.0,
                          forward_trunc_deg=20.0, device='cpu')
    out = {}
    for cf in (0.0, 2.0):
        cfg = SolverConfig(target='radiance', batch=1 << 13, tile_size=8,
                           n_scat_max=500, cf_dtau=cf)
        t = run_transport_flight(scn, st, cfg, 250_000, 14, 'cpu')
        out[cf] = (t.rad.numpy() @ ab.weight) / int(t.n_launched)
    assert out[2.0].mean() == pytest.approx(out[0.0].mean(), rel=0.03)


@pytest.mark.slow
def test_photon_splitting_unbiased(atm20):
    """tests/test_solver_modes.py:259-286: splitting keeps the launch
    count and the radiance mean over 4 seeds within 4 %."""
    ab = abs_synthetic(650.0, atm20, ng=4)
    cld = cld_gen_hom(nx=4, ny=4, nz=2, dx=1.0, dy=1.0, cot0=10.0, cer0=10.0,
                      cloud_base=1.0, cloud_top=3.0)
    scn, st = build_scene(atm20, ab, cld=cld, surface=0.3,
                          solar_zenith_angle=30.0, device='cpu')
    n = 40_000
    means = {0.0: [], 0.5: []}
    for sw in (0.0, 0.5):
        for s in range(4):
            cfg = SolverConfig(target='radiance', batch=1 << 12,
                               split_wmax=sw)
            t = run_transport_flight(scn, st, cfg, n, 60 + s, 'cpu')
            assert int(t.n_launched) == n
            means[sw].append(float((t.rad.numpy() @ ab.weight).mean()
                                   / int(t.n_launched)))
    assert np.mean(means[0.5]) == pytest.approx(np.mean(means[0.0]), rel=0.04)


@pytest.mark.slow
def test_sort_every_and_coherent_launch_unbiased():
    """tests/test_solver_modes.py:395-430: lane sorting with the coherent
    launch agrees with the plain loop within 4 seed spreads + 2 %."""
    atm2 = _broken_atm()
    ab = abs_synthetic(650.0, atm2)
    cld = cld_gen_hem(nx=24, ny=24, nz=4, dx=0.2, dy=0.2, dz=0.5,
                      cloud_frac_tgt=0.3, radii=(0.5, 1.0), cot_scale=12.0,
                      cloud_base=0.5, seed=5)
    scn, st = build_scene(atm2, ab, cld=cld, surface=0.1,
                          solar_zenith_angle=30.0, device='cpu')
    kw = dict(target='radiance', batch=1 << 12, n_scat_max=400, tile_size=4)
    means = {}
    for tag, cfg in (('base', SolverConfig(**kw)),
                     ('sort', SolverConfig(**kw, sort_every=4,
                                           launch_coherent=True))):
        ms = []
        for s in (3, 4, 5):
            t = run_transport_flight(scn, st, cfg, 150_000, s, 'cpu')
            ms.append(float((t.rad.numpy() @ ab.weight).mean()
                            / int(t.n_launched)))
        means[tag] = np.array(ms)
    spread = max(means['base'].std(), means['sort'].std(), 1e-12)
    assert abs(means['sort'].mean() - means['base'].mean()) < 4 * spread \
        + 0.02 * means['base'].mean()


@pytest.mark.slow
def test_tile_majorant_equivalence():
    """tests/test_solver_modes.py:66-96: per-tile majorants keep the domain
    mean (3 %) and the cloudy-region mean (5 %)."""
    atm_f = _broken_atm()
    ab = abs_synthetic(650.0, atm_f)
    cld = cld_gen_hem(nx=32, ny=32, nz=4, dx=0.2, dy=0.2, dz=0.5,
                      cloud_frac_tgt=0.3, radii=(0.8, 1.6), cot_scale=12.0,
                      cloud_base=0.5, seed=3)
    scn, st = build_scene(atm_f, ab, cld=cld, surface=0.05,
                          solar_zenith_angle=30.0, solar_azimuth_angle=45.0,
                          device='cpu')
    out = {}
    for ts in (0, 8):
        cfg = SolverConfig(target='radiance', batch=1 << 13, tile_size=ts,
                           n_scat_max=500)
        t = run_transport_flight(scn, st, cfg, 300_000, 11, 'cpu')
        out[ts] = (t.rad.numpy() @ ab.weight) / int(t.n_launched)
    assert out[8].mean() == pytest.approx(out[0].mean(), rel=0.03)
    hi = out[0] > np.percentile(out[0], 75)
    assert out[8][hi].mean() == pytest.approx(out[0][hi].mean(), rel=0.05)

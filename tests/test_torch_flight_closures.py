"""Closures of the port's flight kernel that the reference also passes:
drain compaction is exact, the single-scatter anchor, a surface map on its
own coarser grid, the stratified launch, the in-step radiance contraction,
and agreement with the independent native C++ solver.  Each mirrors a
reference test (named in its docstring) with the port in place of
er3t_tpu's kernel.
"""

import numpy as np
import pytest
import torch

from er3t_tpu.pre.atm import atm_atmmod
from er3t_tpu.pre.abs import abs_synthetic
from er3t_tpu.pre.cld import cld_gen_hem, cld_gen_hom
from er3t_tpu.pre.sfc import sfc_2d_gen
from er3t_tpu.physics import rayleigh
from er3t_tpu_torch.rtm.mc import SolverConfig
from er3t_tpu_torch.rtm.mc_flight import run_transport_flight
from er3t_tpu_torch.rtm.out import spectral_factors
from er3t_tpu_torch.rtm.scene import build_scene, scene_from_numpy

torch.set_num_threads(2)


@pytest.fixture(scope='module')
def atm20():
    return atm_atmmod(np.linspace(0, 20, 21))


def test_drain_compact_equivalence(atm20):
    """tests/test_solver_modes.py:464-486: compaction on and off launch the
    same photons and agree within 1%."""
    ab = abs_synthetic(650.0, atm20)
    cld = cld_gen_hom(nx=8, ny=8, dx=1.0, dy=1.0, cot0=8.0, cer0=10.0,
                      cloud_base=1.0, cloud_top=3.0)
    scn, st = build_scene(atm20, ab, cld=cld, surface=0.15,
                          solar_zenith_angle=30.0, device='cpu')
    means = {}
    for dc in (True, False):
        cfg = SolverConfig(target='radiance', batch=1 << 13,
                           drain_compact=dc, n_scat_max=400)
        t = run_transport_flight(scn, st, cfg, 200_000, 5, 'cpu')
        assert int(t.n_launched) == 200_000
        # compaction shrank the batch for the drain tail
        full = float(t.n_steps) * cfg.batch
        assert (float(t.lane_iters) < full) == dc
        means[dc] = float((t.rad.numpy() @ ab.weight).mean()
                          / int(t.n_launched))
    assert means[True] == pytest.approx(means[False], rel=0.01)


def test_radiance_single_scatter_anchor(atm20):
    """tests/test_transport_1d.py:74-91 through the port's flight kernel:
    nadir radiance over a Lambertian surface ~ SS Rayleigh + surface term."""
    ab = abs_synthetic(650.0, atm20)
    ab.abso_coef[:] = 0.0
    alb, sza = 0.3, 30.0
    mu0 = np.cos(np.deg2rad(sza))
    scn, st = build_scene(atm20, ab, surface=alb, solar_zenith_angle=sza,
                          device='cpu')
    cfg = SolverConfig(target='radiance', batch=1 << 13)
    tal = run_transport_flight(scn, st, cfg, 100000, 3, 'cpu')
    rad = float(tal.rad[0, 0].numpy() @ ab.weight) / int(tal.n_launched)
    tau = rayleigh.rayleigh_od(650.0, np.array([1013.25, 55.3]), lat_deg=30.0)[0]
    p_ray = 0.75 * (1 + mu0 ** 2)
    ss = p_ray / (4 * np.pi) * (1 - np.exp(-tau * (1 + 1 / mu0))) / (1 + mu0)
    sfc = alb / np.pi * np.exp(-tau / mu0) * np.exp(-tau)
    # first-order analytic is a lower bound; multiple scattering adds ~5-8%
    assert rad == pytest.approx(ss + sfc, rel=0.10)
    assert rad > ss + sfc


def test_coarse_surface_grid_flight_kernel(atm20):
    """tests/test_solver_modes.py:712-741: a surface map at half the
    atmosphere's x resolution gives the same radiance (rtol 1e-6, one
    generator seed) as the same field at full resolution, through the
    independent-surface-grid branch of the port's flight kernel; the
    bright half is brighter."""
    ab = abs_synthetic(650.0, atm20)
    cld = cld_gen_hom(nx=8, ny=8, dx=1.0, dy=1.0, cot0=4.0, cer0=10.0,
                      cloud_base=1.0, cloud_top=3.0)
    alb_coarse = np.linspace(0.05, 0.65, 4)[:, None].repeat(8, axis=1)
    alb_fine = np.repeat(alb_coarse, 2, axis=0)          # (8, 8), same field
    imgs = {}
    for tag, alb in (('coarse', alb_coarse), ('fine', alb_fine)):
        scn, st = build_scene(atm20, ab, cld=cld, surface=sfc_2d_gen(alb),
                              solar_zenith_angle=30.0, device='cpu')
        assert st.nxs == alb.shape[0]
        cfg = SolverConfig(target='radiance', batch=1 << 12, n_scat_max=200)
        t = run_transport_flight(scn, st, cfg, 60_000, 9, 'cpu')
        imgs[tag] = t.rad.numpy() @ ab.weight / int(t.n_launched)
    np.testing.assert_allclose(imgs['coarse'], imgs['fine'], rtol=1e-6)
    img = imgs['coarse']
    assert img[4:].mean() > 1.2 * img[:4].mean()


def test_stratified_launch():
    """tests/test_solver_modes.py:329-363: the stratified-jitter launch
    (qmc_launch) is unbiased (2 %) and, with an overhead sun over a bright
    surface, cuts the per-pixel variance of clear-sky nadir radiance below
    a fifth of the uniform launch's (6 seeds each)."""
    atm_f = atm_atmmod(np.concatenate([np.arange(0, 3.0, 0.5),
                                       np.arange(3.0, 20.1, 2.0)]))
    ab = abs_synthetic(650.0, atm_f)
    cld = cld_gen_hem(nx=24, ny=24, nz=3, dx=0.1, dy=0.1, dz=0.5,
                      cloud_frac_tgt=0.0, radii=(0.3,), cot_scale=0.0,
                      cloud_base=0.5, seed=3)
    scene, st = build_scene(atm_f, ab, cld=cld, surface=0.8,
                            solar_zenith_angle=0.0, device='cpu')
    var, mean = {}, {}
    for qmc in (False, True):
        cfg = SolverConfig(target='radiance', batch=1 << 12, qmc_launch=qmc)
        imgs = []
        for k in range(6):
            t = run_transport_flight(scene, st, cfg, 60_000, 20 + k, 'cpu')
            imgs.append(t.rad.numpy().sum(-1) / int(t.n_launched))
        imgs = np.stack(imgs)
        mean[qmc] = imgs.mean()
        var[qmc] = imgs.var(axis=0, ddof=1).mean()
    assert mean[True] == pytest.approx(mean[False], rel=0.02)
    assert var[True] < 0.2 * var[False]


def test_scalar_radiance_contraction_exact():
    """tests/test_solver_modes.py:366-392: the in-step contraction of the
    image deposits (rad_w) equals the contraction after the run on the same
    generator seed (rtol 2e-4, atol 1e-10)."""
    atm_f = atm_atmmod(np.concatenate([np.arange(0, 3.0, 0.5),
                                       np.arange(3.0, 20.1, 1.0)]))
    ab = abs_synthetic(650.0, atm_f, ng=4)
    cld = cld_gen_hem(nx=16, ny=16, nz=4, dx=0.2, dy=0.2, dz=0.5,
                      cloud_frac_tgt=0.3, radii=(0.4,), cot_scale=10.0,
                      cloud_base=0.5, seed=3)
    scn, st = build_scene(atm_f, ab, cld=cld, surface=0.1,
                          solar_zenith_angle=30.0, device='cpu')
    cfg = SolverConfig(target='radiance', batch=1 << 12, n_scat_max=200)
    f, _ = spectral_factors(ab, nz_out=1)
    t_g = run_transport_flight(scn, st, cfg, 30000, 9, 'cpu')
    t_s = run_transport_flight(scn, st, cfg, 30000, 9, 'cpu', rad_w=f[0])
    img_g = t_g.rad.numpy() @ f[0]
    img_s = t_s.rad.numpy()[..., 0]
    assert t_s.rad.shape[-1] == 1
    np.testing.assert_allclose(img_s, img_g, rtol=2e-4, atol=1e-10)


def test_radiance_cross_validation_native():
    """tests/test_cross_native.py:61-75: the native C++ solver (through the
    port's bridge) on the JAX scene, the port on the same scene carried
    across."""
    from er3t_tpu.rtm.scene import build_scene as jax_build_scene
    from er3t_tpu_torch import native

    atm = atm_atmmod(np.linspace(0, 20, 21))
    ab = abs_synthetic(650.0, atm)
    cld = cld_gen_hom(nx=4, ny=4, nz=2, dx=1.0, dy=1.0, cot0=6.0, cer0=10.0,
                      cloud_base=1.0, cloud_top=3.0)
    cld.extinction[2:] = 0.0   # half cloudy, half clear
    cld.cer[2:] = 0.0
    scn, st = jax_build_scene(atm, ab, cld=cld, surface=0.15,
                              solar_zenith_angle=30.0)
    n = 80000
    cfg = SolverConfig(target='radiance', batch=1 << 12)
    t = run_transport_flight(*scene_from_numpy(scn, st, 'cpu'), cfg, n, 31,
                             'cpu')
    rad_port = (t.rad.numpy() @ ab.weight) / int(t.n_launched)
    rad_nat, _, n_nat = native.mc_ref_run(scn, st, albedo=0.15, sza_deg=30.0,
                                          saa_deg=0.0, n_photon=n, seed=99)
    rad_nat = (rad_nat @ ab.weight) / n_nat
    assert rad_port.mean() == pytest.approx(rad_nat.mean(), rel=0.04)
    assert rad_port[:2].mean() == pytest.approx(rad_nat[:2].mean(), rel=0.06)
    assert rad_port[2:].mean() == pytest.approx(rad_nat[2:].mean(), rel=0.06)

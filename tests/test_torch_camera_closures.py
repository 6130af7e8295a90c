"""The reference's all-sky and airborne camera tests (tests/test_camera.py,
all six) with the port's flight engine in place of er3t_tpu's, to the
reference's own thresholds."""

import numpy as np
import pytest
import torch

from er3t_tpu.pre.atm import atm_atmmod
from er3t_tpu.pre.abs import abs_synthetic
from er3t_tpu.pre.cld import cld_gen_hom
from er3t_tpu_torch.rtm.mc import SolverConfig
from er3t_tpu_torch.rtm.mc_flight import run_transport_flight
from er3t_tpu_torch.rtm.out import reduce_camera_radiance
from er3t_tpu_torch.rtm.scene import build_scene

torch.set_num_threads(2)


@pytest.fixture(scope='module')
def atm20():
    return atm_atmmod(np.linspace(0, 20, 21))


def test_camera_clear_sky_radiance(atm20):
    """tests/test_camera.py:14-33: zenith Rayleigh sky brightness, the
    corners outside the fisheye circle masked."""
    ab = abs_synthetic(650.0, atm20)
    ab.abso_coef[:] = 0.0
    sza = 40.0
    scn, st = build_scene(atm20, ab, surface=0.1, solar_zenith_angle=sza,
                          device='cpu')
    cfg = SolverConfig(target='radiance', batch=1 << 12,
                       sensor_type='camera', cam_npix=16, cam_qmax=85.0)
    tal = run_transport_flight(scn, st, cfg, 150000, 21, 'cpu')
    out = reduce_camera_radiance(tal.rad, int(tal.n_launched), ab,
                                 np.cos(np.deg2rad(sza)),
                                 st.nx * st.dx * st.ny * st.dy, 85.0)
    rad = out['rad']
    assert rad.shape == (16, 16)
    zen = rad[8, 8]
    assert 1e-3 < zen < 2e-2
    assert np.isnan(rad[0, 0])
    assert np.isfinite(rad[np.isfinite(rad)]).all()


def test_airborne_nadir_camera_sees_cloud(atm20):
    """tests/test_camera.py:36-61: a down-looking camera above a
    half-cloudy deck sees one half of its image over twice as bright."""
    ab = abs_synthetic(650.0, atm20)
    cld = cld_gen_hom(nx=8, ny=8, nz=2, dx=0.5, dy=0.5, cot0=10.0, cer0=10.0,
                      cloud_base=1.0, cloud_top=3.0)
    cld.extinction[4:] = 0.0
    cld.cer[4:] = 0.0
    scn, st = build_scene(atm20, ab, cld=cld, surface=0.03,
                          solar_zenith_angle=30.0, device='cpu')
    cfg = SolverConfig(target='radiance', batch=1 << 12,
                       sensor_type='camera', cam_npix=16, cam_qmax=60.0,
                       cam_zloc=8000.0, cam_the=180.0, cam_rmin=100.0)
    tal = run_transport_flight(scn, st, cfg, 200000, 4, 'cpu')
    img = tal.rad.numpy() @ ab.weight / int(tal.n_launched)
    img = img.reshape(16, 16)
    assert img.sum() > 0
    half_a, half_b = img[:8].mean(), img[8:].mean()
    assert max(half_a, half_b) > 2.0 * max(min(half_a, half_b), 1e-12)


def test_camera_fov_mask(atm20):
    """tests/test_camera.py:64-79: events outside the field of view do
    not deposit: empty corners, no bright edge ring."""
    ab = abs_synthetic(650.0, atm20)
    scn, st = build_scene(atm20, ab, surface=0.1, solar_zenith_angle=30.0,
                          device='cpu')
    cfg = SolverConfig(target='radiance', batch=1 << 12,
                       sensor_type='camera', cam_npix=16, cam_qmax=20.0)
    tal = run_transport_flight(scn, st, cfg, 100000, 9, 'cpu')
    img = tal.rad.numpy() @ ab.weight / int(tal.n_launched)
    img = img.reshape(16, 16)
    assert img[0, 0] == 0 and img[-1, -1] == 0
    edge = np.concatenate([img[0], img[-1], img[:, 0], img[:, -1]])
    assert edge.mean() <= img[6:10, 6:10].mean() * 2.0 + 1e-12


def test_finite_aperture():
    """tests/test_camera.py:82-106: a finite aperture reproduces the
    pinhole image in the mean (5 %)."""
    atm = atm_atmmod(np.concatenate([np.arange(0, 5.0, 0.5),
                                     np.arange(5.0, 20.1, 1.0)]))
    ab = abs_synthetic(650.0, atm, ng=2)
    cld = cld_gen_hom(nx=8, ny=8, nz=2, dx=0.5, dy=0.5, cot0=5.0, cer0=10.0,
                      cloud_base=1.0, cloud_top=2.0)
    scn, st = build_scene(atm, ab, cld=cld, surface=0.1,
                          solar_zenith_angle=30.0, device='cpu')
    kw = dict(target='radiance', sensor_type='camera', cam_npix=8,
              cam_qmax=60.0, batch=1 << 12, n_scat_max=150)
    t0 = run_transport_flight(scn, st, SolverConfig(**kw), 80000, 3, 'cpu')
    t1 = run_transport_flight(scn, st, SolverConfig(**kw, cam_apsize=50.0),
                              80000, 3, 'cpu')
    m0 = float(t0.rad.sum()) / int(t0.n_launched)
    m1 = float(t1.rad.sum()) / int(t1.n_launched)
    assert m1 == pytest.approx(m0, rel=0.05)


def test_camera_importance_launch_unbiased(atm20):
    """tests/test_camera.py:109-133: the importance-sampled launch
    reproduces the uniform launch's image mean within 6 % (3 seeds of
    120k photons each)."""
    ab = abs_synthetic(650.0, atm20)
    cld = cld_gen_hom(nx=8, ny=8, nz=2, dx=0.5, dy=0.5, cot0=6.0, cer0=10.0,
                      cloud_base=1.0, cloud_top=3.0)
    scn, st = build_scene(atm20, ab, cld=cld, surface=0.1,
                          solar_zenith_angle=30.0, device='cpu')
    kw = dict(target='radiance', batch=1 << 12, sensor_type='camera',
              cam_npix=8, cam_qmax=80.0, n_scat_max=300)
    means = {}
    for sig in (0.0, 1.0):
        acc, n = 0.0, 0
        for s in range(3):
            cfg = SolverConfig(cam_importance_sigma=sig, **kw)
            tal = run_transport_flight(scn, st, cfg, 120000, 50 + s, 'cpu')
            acc += float((tal.rad.numpy() @ ab.weight).sum())
            n += int(tal.n_launched)
        means[sig] = acc / n
    assert means[1.0] == pytest.approx(means[0.0], rel=0.06)


def test_airborne_camera_surface_reflection(atm20):
    """tests/test_camera.py:136-162: a down-looking camera over a bright
    Lambertian surface sees the direct surface-reflected signal, nadir
    ~ alb mu0 E / pi (30 %)."""
    ab = abs_synthetic(650.0, atm20)
    ab.abso_coef[:] = 0.0
    alb, sza = 0.5, 30.0
    scn, st = build_scene(atm20, ab, surface=alb, solar_zenith_angle=sza,
                          device='cpu')
    cfg = SolverConfig(target='radiance', batch=1 << 12,
                       sensor_type='camera', cam_npix=16, cam_qmax=60.0,
                       cam_zloc=1000.0, cam_the=180.0, cam_rmin=50.0)
    tal = run_transport_flight(scn, st, cfg, 200_000, 12, 'cpu')
    mu0 = np.cos(np.deg2rad(sza))
    out = reduce_camera_radiance(tal.rad, int(tal.n_launched), ab, mu0,
                                 st.nx * st.dx * st.ny * st.dy, 60.0)
    rad = out['rad']
    expect = alb * mu0 * out['toa'] / np.pi
    nadir = np.nanmean(rad[7:9, 7:9])
    assert nadir == pytest.approx(expect, rel=0.3)
    assert nadir > 0.5 * expect

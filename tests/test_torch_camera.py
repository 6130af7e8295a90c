"""The fisheye camera of the port against er3t_tpu's.

1. Host code bit for bit: ``camera_rotation`` and
   ``out.reduce_camera_radiance`` on the same inputs.
2. One flight step at a time with injected deviates (the harness of
   tests/test_torch_flight_modes.py): the ground all-sky camera with the
   in-step contraction ``rad_w``, an airborne down-looking camera with a
   finite aperture and pathlength tallies, and the camera-importance
   launch (its own deviate substream).
3. The reference's front-door camera tests with the port's ``solve``.
"""

import numpy as np
import pytest
import torch

from er3t_tpu.pre.atm import atm_atmmod
from er3t_tpu.pre.abs import abs_synthetic
from er3t_tpu.pre.cld import cld_gen_hom
from er3t_tpu.rtm import out as jout
from er3t_tpu.rtm.scene import camera_rotation as jrotation
from er3t_tpu_torch.rtm import out as tout
from er3t_tpu_torch.rtm.scene import camera_rotation as trotation
from er3t_tpu_torch.rtm.solver import solve

from test_torch_flight_modes import KW, broken, step_parity

torch.set_num_threads(2)


@pytest.mark.parametrize('angles', [(0.0, 0.0, 0.0), (0.0, 180.0, 0.0),
                                    (33.0, 71.5, -120.0), (270.0, 95.0, 10.0)])
def test_camera_rotation_equals_reference(angles):
    a, b = trotation(*angles), jrotation(*angles)
    assert a.dtype == b.dtype == np.float32
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('npix,qmax,ng,pre', [(16, 85.0, 4, False),
                                              (64, 89.0, 1, True),
                                              (9, 60.0, 16, False)])
def test_reduce_camera_radiance_equals_reference(npix, qmax, ng, pre):
    atm = atm_atmmod(np.linspace(0, 20, 21))
    ab = abs_synthetic(650.0, atm, ng=4 if ng == 1 else ng)
    rng = np.random.default_rng(npix)
    tally = rng.uniform(0, 5, (npix, npix, ng)).astype(np.float32)
    kw = dict(domain_area_m2=6.4e3 * 6.4e3, qmax_deg=qmax, precontracted=pre)
    a = tout.reduce_camera_radiance(tally, 4321, ab, 0.8, **kw)
    b = jout.reduce_camera_radiance(tally, 4321, ab, 0.8, **kw)
    c = tout.reduce_camera_radiance(torch.from_numpy(tally), 4321, ab, 0.8,
                                    **kw)
    assert set(a) == set(b) == {'rad', 'toa', 'solid_angle'}
    assert a['toa'] == b['toa']
    for k in ('rad', 'solid_angle'):
        np.testing.assert_array_equal(a[k], b[k])
        np.testing.assert_array_equal(c[k], b[k])
    assert np.isnan(a['rad'][0, 0]) and np.isfinite(a['rad'][npix // 2,
                                                             npix // 2])


CAMERAS = {
    # solve's default dict: up-looking at the ground, 89-deg fisheye
    'ground': dict(sensor_type='camera', cam_npix=64, cam_qmax=89.0),
    'air_aperture_pathlength': dict(
        sensor_type='camera', cam_zloc=8000.0, cam_the=180.0, cam_qmax=60.0,
        cam_npix=16, cam_apsize=50.0, pathlength=True),
    'importance': dict(sensor_type='camera', cam_npix=16, cam_qmax=80.0,
                       cam_importance_sigma=500.0),
}


@pytest.mark.parametrize('camera', list(CAMERAS))
def test_camera_step_parity_with_injected_deviates(camera):
    _, scn, st, rad_w, _ = broken()
    kw = dict(KW, **CAMERAS[camera])
    got, kern = step_parity(scn, st, kw, steps=8,
                            rad_w=None if kw.get('pathlength') else rad_w)
    npix = kw['cam_npix']
    assert (kern.nxr, kern.nyr) == (npix, npix)
    assert float(got.rad.sum()) > 0
    if camera == 'importance':
        # the launch weights p_uniform / p_mixture lie in (0, 2]
        assert kern.cam_importance and not kern.strat
        assert float(got.wsc.max()) <= 2.0
    if kw.get('pathlength'):
        assert tuple(got.rad_pl.shape) == (npix * npix, st.ng)


@pytest.fixture(scope='module')
def base():
    """The scene of tests/test_solve_surface.py:16-25."""
    atm = atm_atmmod(np.linspace(0, 20, 21))
    ab = abs_synthetic(650.0, atm, ng=4)
    cld = cld_gen_hom(nx=8, ny=8, nz=2, dx=0.5, dy=0.5, cot0=6.0, cer0=10.0,
                      cloud_base=1.0, cloud_top=3.0)
    cld.extinction[4:] = 0.0
    return dict(atm=atm, abs_coef=ab, cld=cld, surface=0.1,
                solar_zenith_angle=30.0, photons=30000, n_run=1,
                batch=1 << 12, seed=3, device='cpu')


def test_solve_camera(base):
    """tests/test_solve_surface.py:28-35."""
    res = solve(sensor_type='camera',
                camera=dict(zloc=0.0, the=0.0, qmax=80.0, npix=16), **base)
    rad = res['rad']
    assert rad.shape == (16, 16)
    inside = np.isfinite(rad)
    assert inside.sum() > 100 and np.all(rad[inside] >= 0)


def test_solve_refuses_an_unknown_camera_key(base):
    """The reference's check of the camera dict (solver.py:307-311)."""
    with pytest.raises(ValueError, match='unknown camera parameter'):
        solve(camera=dict(zloc=0.0, fov=90.0), **base)


def test_camera_independent_matches_correlated():
    """tests/test_solver_modes.py:669-688: camera images through the
    independent protocol get the camera normalization and match the
    correlated ones within 30 %; both have the NaN mask."""
    atm = atm_atmmod(np.linspace(0, 20, 21))
    ab = abs_synthetic(650.0, atm)
    kw = dict(atm=atm, abs_coef=ab, surface=0.3, target='radiance',
              sensor_type='camera', camera=dict(zloc=0.0, the=0.0,
                                                qmax=60.0, npix=8),
              solar_zenith_angle=30.0, n_run=1, batch=1 << 11, device='cpu')
    rc = solve(spectral='correlated', photons=120000, seed=3, **kw)
    ri = solve(spectral='independent', photons=240000, seed=4, **kw)
    mc = np.nanmean(rc['rad'])
    mi = np.nanmean(ri['rad'])
    assert mi == pytest.approx(mc, rel=0.3)
    assert np.isnan(rc['rad']).any() == np.isnan(ri['rad']).any()

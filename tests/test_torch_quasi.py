"""The port's quasi-radiance renderer (er3t_tpu_torch.rtm.quasi) against
er3t_tpu.rtm.quasi on one scene per case: per pixel within 1e-5 relative,
with equal NaN masks; then the reference's own quasi tests mirrored on the
port (tests/test_quasi.py and test_quasi_uses_slot_mixture of
tests/test_constituents3d.py)."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from er3t_tpu.pre.abs import abs_synthetic
from er3t_tpu.pre.aer import Aerosol3D
from er3t_tpu.pre.atm import atm_atmmod
from er3t_tpu.pre.cld import cld_gen_hom
from er3t_tpu.pre.pha import pha_mie_wc
from er3t_tpu.pre.sfc import sfc_ocean
from er3t_tpu.rtm import quasi as jquasi
from er3t_tpu.rtm.mc import SolverConfig as JConfig
from er3t_tpu.rtm.scene import build_scene
from er3t_tpu_torch.rtm import mc_flight as tmf
from er3t_tpu_torch.rtm import quasi as tquasi
from er3t_tpu_torch.rtm.mc import SolverConfig
from er3t_tpu_torch.rtm.out import reduce_camera_radiance
from er3t_tpu_torch.rtm.scene import scene_from_numpy

torch.set_num_threads(2)


def _atm():
    return atm_atmmod(np.concatenate([np.arange(0, 5.0, 0.5),
                                      np.arange(5.0, 20.1, 1.0)]))


@functools.lru_cache(maxsize=None)
def _scene(kind):
    """An 8x8 broken Mie deck (20-deg truncation) and its variations."""
    atm = _atm()
    ab = abs_synthetic(650.0, atm, ng=4)
    cld = cld_gen_hom(nx=8, ny=8, nz=4, dx=0.5, dy=0.5, cot0=6.0, cer0=10.0,
                      cloud_base=1.0, cloud_top=3.0)
    cld.extinction[4:, :4] = 0.0
    cld.cer[4:, :4] = 0.0
    kw = dict(cld=cld, pha=pha_mie_wc(650.0), surface=0.1,
              solar_zenith_angle=35.0, solar_azimuth_angle=30.0,
              forward_trunc_deg=20.0)
    if kind == 'clear':
        kw.pop('cld')
        kw.pop('pha')
    elif kind == 'slots2':
        kw['aer_3ds'] = [Aerosol3D(extinction=np.asarray(cld.extinction) * 0.5
                                   + 1e-4, ssa=0.9, asy=0.0)]
    elif kind == 'coxmunk':
        kw['surface'] = sfc_ocean(650.0, u10=4.0, nx=4, ny=2)
    scn, st = build_scene(atm, ab, **kw)
    if kind == 'ipa':
        st = dataclasses.replace(st, ipa=True)
    return scn, st


GROUND = dict(sensor_type='camera', cam_npix=16, cam_zloc=0.0, cam_qmax=80.0)
AIRBORNE = dict(sensor_type='camera', cam_npix=16, cam_zloc=8000.0,
                cam_the=180.0, cam_qmax=60.0, cam_xpos=0.3, cam_ypos=0.6)
CASES = {
    'ground': ('base', GROUND),
    'airborne': ('base', AIRBORNE),
    'ipa_ground': ('ipa', GROUND),
    'ipa_airborne': ('ipa', AIRBORNE),
    'no_deck': ('clear', GROUND),
    'slots2': ('slots2', AIRBORNE),
    'coxmunk_grid': ('coxmunk', AIRBORNE),
    'tilted': ('base', dict(GROUND, cam_phi=30.0, cam_the=50.0,
                            cam_psi=10.0)),
}


def both(kind, cam, n_steps=96):
    scn, st = _scene(kind)
    ref = np.asarray(jquasi.quasi_radiance(scn, st, JConfig(**cam),
                                           n_steps=n_steps), np.float64)
    got = tquasi.quasi_radiance(*scene_from_numpy(scn, st, 'cpu'),
                                SolverConfig(**cam), n_steps=n_steps,
                                device='cpu')
    return ref, got


@pytest.mark.parametrize('case', list(CASES))
def test_quasi_image_matches_reference(case):
    kind, cam = CASES[case]
    ref, got = both(kind, cam)
    assert got.dtype == torch.float32
    got = got.double().numpy()
    assert got.shape == ref.shape == (16, 16, 4)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    fin = np.isfinite(ref)
    assert fin.sum() > 100 and (ref[fin] > 0).all()
    np.testing.assert_allclose(got[fin], ref[fin], rtol=1e-5, atol=0)


def test_quasi_runs_on_the_scene_device_only():
    scn, st = _scene('base')
    s_t, st_t = scene_from_numpy(scn, st, 'cpu')
    with pytest.raises(ValueError, match='not meta'):
        tquasi.quasi_radiance(s_t, st_t, SolverConfig(**GROUND), n_steps=8,
                              device='meta')


# ---- the reference's quasi tests, on the port ----

def _port_scene(atm, ab, **kw):
    from er3t_tpu_torch.rtm.scene import build_scene as tbuild
    return tbuild(atm, ab, device='cpu', **kw)


@pytest.fixture(scope='module')
def broken_ng1():
    atm = _atm()
    ab = abs_synthetic(650.0, atm, ng=1)
    cld = cld_gen_hom(nx=8, ny=8, nz=2, dx=0.5, dy=0.5, cot0=2.0, cer0=10.0,
                      cloud_base=1.0, cloud_top=2.0)
    cld.extinction[4:] = 0.0     # broken cloud: half the sky
    return _port_scene(atm, ab, cld=cld, surface=0.0,
                       solar_zenith_angle=40.0, solar_azimuth_angle=0.0)


def test_quasi_finite_and_structured(broken_ng1):
    scn, st = broken_ng1
    cfg = SolverConfig(sensor_type='camera', cam_npix=32, cam_zloc=0.0,
                       cam_qmax=80.0)
    img = tquasi.quasi_radiance(scn, st, cfg, n_steps=160,
                                device='cpu').numpy()
    assert img.shape == (32, 32, st.ng)
    inside = np.isfinite(img[..., 0])
    assert inside.sum() > 500
    vals = img[..., 0][inside]
    assert np.all(vals >= 0) and vals.max() > 0
    # the cloudy half of the sky is brighter than the clear half
    assert img[:16][np.isfinite(img[:16, :, 0])].mean() != pytest.approx(
        img[16:][np.isfinite(img[16:, :, 0])].mean(), rel=0.05)


def test_quasi_matches_mc_single_scatter():
    """For a horizontally homogeneous scene the port's quasi image agrees
    with the port's MC camera restricted to single scattering
    (tests/test_quasi.py:35)."""
    atm = _atm()
    ab = abs_synthetic(650.0, atm, ng=1)
    cld = cld_gen_hom(nx=4, ny=4, nz=2, dx=1.0, dy=1.0, cot0=1.5, cer0=10.0,
                      cloud_base=1.0, cloud_top=2.0)
    scn, st = _port_scene(atm, ab, cld=cld, surface=0.0,
                          solar_zenith_angle=40.0)
    cfg = SolverConfig(target='radiance', sensor_type='camera', cam_npix=16,
                       cam_zloc=0.0, cam_qmax=70.0, batch=1 << 12,
                       n_scat_max=1, cam_rmin=1.0)
    img_q = tquasi.quasi_radiance(scn, st, cfg, n_steps=256,
                                  device='cpu').numpy()[..., 0]
    tal = tmf.run_transport_flight(scn, st, cfg, 200_000, 5, 'cpu')

    class _Ab:
        weight = np.ones(1)
        slit_func = np.ones((st.nz, 1))
        solar = np.ones(1)

    area = (st.nx * st.dx) * (st.ny * st.dy)
    red = reduce_camera_radiance(tal.rad.numpy(), int(tal.n_launched), _Ab(),
                                 float(scn.mu0), domain_area_m2=area,
                                 qmax_deg=cfg.cam_qmax)
    img_m = np.asarray(red['rad']) / red['toa']
    i = (np.arange(16) + 0.5) / 16 * 2 - 1
    px, py = np.meshgrid(i, i, indexing='ij')
    sel = (np.isfinite(img_q) & np.isfinite(img_m) & (img_m > 0)
           & (np.hypot(px, py) < 0.6))
    assert img_q[sel].mean() / img_m[sel].mean() == pytest.approx(1.0,
                                                                  abs=0.08)
    np.testing.assert_allclose(img_q[sel], img_m[sel], rtol=0.3)


def test_quasi_slant_shadow_displacement():
    """Oblique sun: the cloud shadow falls z tan(SZA) downwind, not below
    the cloud (tests/test_quasi.py:83)."""
    atm = _atm()
    ab = abs_synthetic(650.0, atm, ng=1)
    cld = cld_gen_hom(nx=16, ny=4, dx=0.5, dy=0.5, nz=2, cot0=40.0,
                      cer0=10.0, cloud_base=2.0, cloud_top=3.0)
    cld.extinction[:4] = 0.0
    cld.extinction[8:] = 0.0
    scn, st = _port_scene(atm, ab, cld=cld, surface=0.3,
                          solar_zenith_angle=45.0, solar_azimuth_angle=270.0)
    cfg = SolverConfig(sensor_type='camera', cam_npix=48, cam_zloc=19000.0,
                       cam_the=180.0, cam_qmax=12.0)
    img = tquasi.quasi_radiance(scn, st, cfg, n_steps=400,
                                device='cpu').numpy()[..., 0]
    prof = np.nanmean(img, axis=1)
    xpix = np.isfinite(prof)
    assert xpix.sum() > 20
    lx = st.nx * st.dx / 1000.0
    ang = ((np.arange(48) + 0.5) / 48 * 2 - 1) * np.deg2rad(cfg.cam_qmax)
    xg = ((0.5 * lx * 1000.0 - np.tan(ang) * cfg.cam_zloc)
          % (lx * 1000.0)) / 1000.0
    shadow = xpix & (xg > 4.5) & (xg < 6.5)
    sunlit = xpix & ((xg > 7.2) | (xg < 1.6))
    assert shadow.sum() > 5 and sunlit.sum() > 5
    assert np.nanmean(prof[shadow]) < 0.3 * np.nanmean(prof[sunlit])


def test_quasi_uses_slot_mixture():
    """With an isotropic 3D aerosol in the deck the render evaluates each
    slot's own phase (tests/test_constituents3d.py:122): finite, positive
    and different from the cloud-only image."""
    atm = atm_atmmod(np.concatenate([np.arange(0, 5.0, 0.5),
                                     np.arange(5.0, 20.1, 1.0)]))
    ab = abs_synthetic(650.0, atm, ng=2)
    cld = cld_gen_hom(nx=4, ny=4, nz=2, dx=1.0, dy=1.0, cot0=1.0, cer0=10.0,
                      cloud_base=1.0, cloud_top=2.0)
    aer = Aerosol3D(extinction=np.asarray(cld.extinction), ssa=1.0, asy=0.0)
    kw = dict(surface=0.0, solar_zenith_angle=30.0)
    cfg = SolverConfig(sensor_type='camera', cam_npix=16, cam_zloc=0.0,
                       cam_qmax=60.0)
    scn_a, st_a = _port_scene(atm, ab, cld=cld, aer_3ds=[aer], **kw)
    scn_c, st_c = _port_scene(atm, ab, cld=cld, **kw)
    img = tquasi.quasi_radiance(scn_a, st_a, cfg, n_steps=120,
                                device='cpu').numpy()
    img_c = tquasi.quasi_radiance(scn_c, st_c, cfg, n_steps=120,
                                  device='cpu').numpy()
    assert st_a.ns3 == 2
    assert np.isfinite(img[np.isfinite(img)]).all()
    assert np.nanmax(img) > 0
    assert abs(np.nanmean(img) / np.nanmean(img_c) - 1) > 0.05

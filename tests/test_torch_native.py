"""The port's ctypes bridge to the native C++ solver
(er3t_tpu_torch.native) against the JAX package's (er3t_tpu.native): the
same library on the port's scene and on the reference's scene (same
inputs, same seed) gives the same radiance and fluxes to rtol 1e-12 (not
bitwise: native/mc_ref.cpp reduces per-thread buffers filled under
``schedule(dynamic)``), its guards raise alike, and its library is built in
``build/er3t_tpu_torch/`` under a name hashed from the source and flags,
written under a temporary name and renamed into place, so that concurrent
builds never load a half-written file and nothing is written under
``native/``.  The reference's library is redirected to ``tmp_path``."""

import os
import threading

import numpy as np
import pytest
import torch

from er3t_tpu import native as j_native
from er3t_tpu.pre import abs as j_abs
from er3t_tpu.pre import aer as j_aer
from er3t_tpu.pre import atm as j_atm
from er3t_tpu.pre import cld as j_cld
from er3t_tpu.rtm import scene as j_scene
from er3t_tpu_torch import _build
from er3t_tpu_torch import native as t_native
from er3t_tpu_torch.pre import abs as t_abs
from er3t_tpu_torch.pre import aer as t_aer
from er3t_tpu_torch.pre import atm as t_atm
from er3t_tpu_torch.pre import cld as t_cld
from er3t_tpu_torch.rtm import scene as t_scene

torch.set_num_threads(2)

NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'native')


def _scene(pkg, aer=None, aer3d=False):
    """The scene of tests/test_cross_native.py:20-30 built by ``pkg``'s
    modules (optionally with a 1D aerosol or a 3D aerosol field)."""
    atm_m, abs_m, cld_m, aer_m, scene_m = pkg
    atm = atm_m.atm_atmmod(np.linspace(0, 20, 21))
    ab = abs_m.abs_synthetic(650.0, atm)
    cld = cld_m.cld_gen_hom(nx=4, ny=4, nz=2, dx=1.0, dy=1.0, cot0=6.0,
                            cer0=10.0, cloud_base=1.0, cloud_top=3.0)
    cld.extinction[2:] = 0.0   # half cloudy, half clear
    cld.cer[2:] = 0.0
    kw = dict(cld=cld, surface=0.15, solar_zenith_angle=30.0)
    if aer is not None:
        kw['aer_1ds'] = [aer_m.aer_gen(**aer)]
    if aer3d:
        kw['aer_3ds'] = [aer_m.aer_gen(aod=0.0, ssa=0.9, asy=0.7,
                                       aod_2d=np.full((4, 4), 0.3), nz=2)]
    if scene_m is t_scene:
        kw['device'] = 'cpu'
    return scene_m.build_scene(atm, ab, **kw)


JAX = (j_atm, j_abs, j_cld, j_aer, j_scene)
PORT = (t_atm, t_abs, t_cld, t_aer, t_scene)


@pytest.fixture
def reference(monkeypatch, tmp_path):
    """The JAX package's bridge, its library built under tmp_path."""
    monkeypatch.setattr(j_native, '_SO', str(tmp_path / 'libmc_ref.so'))
    monkeypatch.setattr(j_native, '_lib', None)
    return j_native


def test_library_lands_in_the_build_directory():
    before = sorted(os.listdir(NATIVE_DIR))
    path = t_native.ensure_built()
    assert os.path.dirname(path) == str(_build.BUILD_DIR)
    assert path in (str(t_native.lib_path(True)),
                    str(t_native.lib_path(False)))
    assert os.path.basename(path).startswith('libmc_ref-')
    assert sorted(os.listdir(NATIVE_DIR)) == before
    threads = t_native.max_threads()
    assert threads is None or threads >= 1


@pytest.mark.parametrize('port_scene', [True, False],
                         ids=['port_scene', 'reference_scene'])
@pytest.mark.parametrize('radiance', [True, False],
                         ids=['radiance', 'flux'])
def test_bridge_matches_the_reference(reference, port_scene, radiance):
    """The port's bridge on the port's scene (tensors) or on the
    reference's (arrays) against the reference's bridge on its scene."""
    jscn, jst = _scene(JAX)
    scn, st = _scene(PORT) if port_scene else (jscn, jst)
    kw = dict(albedo=0.15, sza_deg=30.0, saa_deg=20.0, n_photon=20000,
              seed=99, do_radiance=radiance)
    rad_r, flux_r, n_r = reference.mc_ref_run(jscn, jst, **kw)
    rad_p, flux_p, n_p = t_native.mc_ref_run(scn, st, **kw)
    assert n_p == n_r == 20000
    assert rad_p.shape == rad_r.shape and flux_p.shape == flux_r.shape
    assert flux_r[-1, 0].sum() > 0 and (rad_r.any() == radiance)
    np.testing.assert_allclose(rad_p, rad_r, rtol=1e-12, atol=0)
    np.testing.assert_allclose(flux_p, flux_r, rtol=1e-12, atol=0)


@pytest.mark.parametrize('case', ['absorbing_aerosol', 'two_3d_constituents'])
def test_guards_raise_alike(reference, case):
    kw = (dict(aer=dict(aod=0.2, ssa=0.9, asy=0.7, z_bottom=0.0, z_top=2.0))
          if case == 'absorbing_aerosol' else dict(aer3d=True))
    errors = []
    for bridge, pkg in ((reference, JAX), (t_native, PORT)):
        scn, st = _scene(pkg, **kw)
        with pytest.raises(NotImplementedError) as e:
            bridge.mc_ref_run(scn, st, albedo=0.15, sza_deg=30.0,
                              saa_deg=0.0, n_photon=100)
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def test_concurrent_builds_publish_one_whole_library(monkeypatch, tmp_path):
    """Four builds of one library at once (as parallel test workers start
    them): each writes its own temporary file and renames it into place;
    the library loads and runs, and no temporary file is left."""
    monkeypatch.setattr(t_native, 'BUILD_DIR', tmp_path)
    monkeypatch.setattr(t_native, '_lib', None)
    lib = t_native.lib_path(openmp=False)
    errors = []

    def build():
        try:
            t_native._compile(lib, openmp=False)
        except Exception as e:            # reported by the assert below
            errors.append(e)
    workers = [threading.Thread(target=build) for _ in range(4)]
    for w in workers:
        w.start()
    for w in workers:
        w.join(timeout=300)
    assert not any(w.is_alive() for w in workers) and not errors
    assert os.listdir(tmp_path) == [lib.name]
    monkeypatch.setattr(t_native, 'lib_path', lambda openmp=True: lib)
    scn, st = _scene(PORT)
    _, flux, _ = t_native.mc_ref_run(scn, st, albedo=0.15, sza_deg=30.0,
                                     saa_deg=0.0, n_photon=1000,
                                     do_radiance=False)
    assert flux[-1, 0].sum() == 1000 * st.ng

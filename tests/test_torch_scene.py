"""The port's scene assembly and config against er3t_tpu's (exact equality).

Both packages run the same NumPy scene body, so every leaf must be equal
bit for bit, in the same 32-bit dtype.
"""

import dataclasses

import numpy as np
import pytest
import torch

from er3t_tpu.pre.aer import Aerosol1D, Aerosol3D
from er3t_tpu.pre.atm import atm_atmmod
from er3t_tpu.pre.abs import abs_synthetic
from er3t_tpu.pre.cld import cld_gen_hem, cld_gen_hom
from er3t_tpu.pre.pha import pha_mie_wc
from er3t_tpu.pre.sfc import sfc_2d_gen
from er3t_tpu.rtm import mc as jmc
from er3t_tpu.rtm import scene as jscene
from er3t_tpu_torch.rtm import mc as tmc
from er3t_tpu_torch.rtm import scene as tscene

torch.set_num_threads(2)


def _mie_broken():
    levels = np.concatenate([np.arange(0, 3.0, 0.5), np.arange(3.0, 20.1, 1.0)])
    atm = atm_atmmod(levels)
    ab = abs_synthetic(650.0, atm, ng=4)
    cld = cld_gen_hem(nx=32, ny=32, nz=4, dx=0.2, dy=0.2, dz=0.5,
                      cloud_frac_tgt=0.3, radii=(0.4,), cot_scale=12.0,
                      cloud_base=0.5, seed=3)
    return (atm, ab), dict(cld=cld, pha=pha_mie_wc(650.0), surface=0.05,
                           solar_zenith_angle=30.0, solar_azimuth_angle=45.0,
                           forward_trunc_deg=20.0)


def _clear():
    atm = atm_atmmod(np.linspace(0, 20, 21))
    return (atm, abs_synthetic(650.0, atm)), dict(surface=0.3,
                                                  solar_zenith_angle=30.0)


def _aerosols():
    atm = atm_atmmod(np.linspace(0, 20, 21))
    ab = abs_synthetic(650.0, atm, ng=4)
    cld = cld_gen_hom(nx=8, ny=8, nz=2, dx=1.0, dy=1.0, cot0=6.0, cer0=10.0,
                      cloud_base=1.0, cloud_top=3.0)
    a1 = Aerosol1D(aod=0.3, ssa=0.9, asy=0.7, z_bottom=0.0, z_top=2.0)
    a3 = Aerosol3D(extinction=np.asarray(cld.extinction) * 0.2, ssa=0.85,
                   asy=0.6)
    rng = np.random.default_rng(4)
    sfc = sfc_2d_gen(rng.uniform(0.0, 0.4, (8, 8)))       # per-pixel albedo
    return (atm, ab), dict(cld=cld, aer_1ds=[a1], aer_3ds=[a3], surface=sfc,
                           solar_zenith_angle=40.0, solar_azimuth_angle=120.0,
                           pfpeak=30.0)


SCENES = {'mie_broken': _mie_broken, 'clear': _clear, 'aerosols': _aerosols}


@pytest.mark.parametrize('name', sorted(SCENES))
def test_build_scene_matches_reference(name):
    (atm, ab), kw = SCENES[name]()
    j_arr, j_st = jscene.build_scene(atm, ab, **kw)
    t_arr, t_st = tscene.build_scene(atm, ab, **kw, device='cpu')
    assert dataclasses.asdict(t_st) == dataclasses.asdict(j_st)
    assert t_arr._fields == j_arr._fields
    for f in j_arr._fields:
        ref = np.asarray(getattr(j_arr, f))
        got = getattr(t_arr, f).numpy()
        assert got.dtype == ref.dtype, f
        assert got.shape == ref.shape, f
        np.testing.assert_array_equal(got, ref, err_msg=f)
    # carrying the JAX leaves across gives identical tensors
    c_arr, c_st = tscene.scene_from_numpy(j_arr, j_st, 'cpu')
    assert c_st == t_st
    for f in j_arr._fields:
        a, b = getattr(c_arr, f), getattr(t_arr, f)
        assert a.dtype == b.dtype and torch.equal(a, b), f


def test_solver_config_fields_and_defaults():
    ref = {f.name: f.default for f in dataclasses.fields(jmc.SolverConfig)}
    got = {f.name: f.default for f in dataclasses.fields(tmc.SolverConfig)}
    assert got == ref
    assert list(got) == [k for k in ref]          # same field order
    with pytest.raises(dataclasses.FrozenInstanceError):
        tmc.SolverConfig().batch = 1

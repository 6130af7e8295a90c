"""The port's NumPy copies of the preprocessing against the reference's.

``er3t_tpu_torch.pre``, ``.physics`` and ``.util`` repeat the arithmetic of
``er3t_tpu.pre``, ``.physics`` and ``.util.grid`` operation for operation,
so every array must be equal bit for bit (``np.array_equal``, same dtype) on
the same inputs: the bench scene's and a few small ones.
"""

import dataclasses
import datetime

import numpy as np
import pytest
import torch

from er3t_tpu.physics import hg as j_hg
from er3t_tpu.physics import rayleigh as j_ray
from er3t_tpu.physics import solar as j_solar
from er3t_tpu.physics import water as j_water
from er3t_tpu.pre import abs as j_abs
from er3t_tpu.pre import aer as j_aer
from er3t_tpu.pre import atm as j_atm
from er3t_tpu.pre import cld as j_cld
from er3t_tpu.pre import pha as j_pha
from er3t_tpu.pre import sfc as j_sfc
from er3t_tpu.util import grid as j_grid
from er3t_tpu_torch.physics import hg as t_hg
from er3t_tpu_torch.physics import rayleigh as t_ray
from er3t_tpu_torch.physics import solar as t_solar
from er3t_tpu_torch.physics import water as t_water
from er3t_tpu_torch.pre import abs as t_abs
from er3t_tpu_torch.pre import aer as t_aer
from er3t_tpu_torch.pre import atm as t_atm
from er3t_tpu_torch.pre import cld as t_cld
from er3t_tpu_torch.pre import pha as t_pha
from er3t_tpu_torch.pre import sfc as t_sfc
from er3t_tpu_torch.rtm import scene as t_scene
from er3t_tpu_torch.util import grid as t_grid

torch.set_num_threads(2)

BENCH_LEVELS = np.concatenate([np.arange(0, 3.0, 0.5),
                               np.arange(3.0, 20.1, 1.0)])
BENCH_HEM = dict(nx=480, ny=480, nz=4, dx=0.1, dy=0.1, dz=0.5,
                 cloud_frac_tgt=0.25, radii=(0.5, 1.0, 2.0), cot_scale=15.0,
                 cloud_base=0.5, seed=7)            # chip_smoke.py / bench.py


def assert_same(ref, got, where='out'):
    """Equal bit for bit, field by field: arrays by ``np.array_equal`` and
    dtype, dataclasses by field, dicts by key, phase objects by ``data``."""
    if dataclasses.is_dataclass(ref):
        assert type(got).__name__ == type(ref).__name__, where
        for f in dataclasses.fields(ref):
            assert_same(getattr(ref, f.name), getattr(got, f.name),
                        f'{where}.{f.name}')
    elif isinstance(ref, dict):
        assert sorted(got) == sorted(ref), where
        for k in ref:
            assert_same(ref[k], got[k], f'{where}[{k!r}]')
    elif isinstance(ref, (tuple, list)):
        assert len(got) == len(ref), where
        for i, (r, g) in enumerate(zip(ref, got)):
            assert_same(r, g, f'{where}[{i}]')
    elif hasattr(ref, 'data') and isinstance(ref.data, dict):
        assert_same(ref.data, got.data, f'{where}.data')
    elif isinstance(ref, np.ndarray) or isinstance(got, np.ndarray):
        ref, got = np.asarray(ref), np.asarray(got)
        assert got.dtype == ref.dtype and got.shape == ref.shape, where
        assert np.array_equal(got, ref, equal_nan=True), where
    else:
        assert type(got) is type(ref) and got == ref, where


_CACHE = {}


def _both(key, ref_fn, port_fn):
    """(reference result, port result), computed once per module."""
    if key not in _CACHE:
        _CACHE[key] = (ref_fn(), port_fn())
    return _CACHE[key]


def _bench_atm(m):
    return m.atm_atmmod(BENCH_LEVELS)


def _atm_file(tmp_path):
    """An AFGL-format profile (z, p, T, air, o3, o2, h2o, co2, no2)."""
    base = j_atm.us_standard_profile(np.arange(0.0, 31.0, 1.0))
    cols = ['altitude', 'pressure', 'temperature', 'air', 'o3', 'o2', 'h2o',
            'co2', 'no2']
    path = tmp_path / 'afglus_small.dat'
    np.savetxt(path, np.stack([base[c] for c in cols], axis=1)[::-1])
    return str(path)


def _mie(m):
    return m.pha_mie_wc(650.0)


def case_atm_bench(tmp_path):
    return _both('atm', lambda: _bench_atm(j_atm), lambda: _bench_atm(t_atm))


def case_atm_file(tmp_path):
    f = _atm_file(tmp_path)
    lev = np.linspace(0.0, 20.0, 11)
    return (j_atm.atm_atmmod(lev, fname_atmmod=f, lat=45.0),
            t_atm.atm_atmmod(lev, fname_atmmod=f, lat=45.0))


def case_us_standard_profile(tmp_path):
    z = np.linspace(0.0, 119.0, 60)
    return j_atm.us_standard_profile(z), t_atm.us_standard_profile(z)


def case_abs_synthetic_bench(tmp_path):
    ja, ta = case_atm_bench(tmp_path)
    return j_abs.abs_synthetic(650.0, ja), t_abs.abs_synthetic(650.0, ta)


def case_abs_synthetic_nir_ng4(tmp_path):
    ja, ta = case_atm_bench(tmp_path)
    return (j_abs.abs_synthetic(1640.0, ja, ng=4),
            t_abs.abs_synthetic(1640.0, ta, ng=4))


def case_cld_gen_hem_bench(tmp_path):
    return _both('hem', lambda: j_cld.cld_gen_hem(**BENCH_HEM),
                 lambda: t_cld.cld_gen_hem(**BENCH_HEM))


def case_cld_gen_hom(tmp_path):
    kw = dict(nx=8, ny=6, nz=3, dx=0.5, dy=0.25, cot0=6.0, cer0=12.0,
              cloud_base=1.0, cloud_top=2.5)
    return j_cld.cld_gen_hom(**kw), t_cld.cld_gen_hom(**kw)


def case_cld_gen_cop_and_coarsen(tmp_path):
    rng = np.random.default_rng(2)
    cot = np.where(rng.uniform(size=(8, 8)) > 0.4,
                   rng.uniform(1, 30, (8, 8)), 0.0)
    cer = rng.uniform(5, 20, (8, 8))
    cth = rng.uniform(0.5, 3.0, (8, 8))
    cth[0, 0] = np.nan
    ref = j_cld.cld_gen_cop(cot, cer, cth, dx=0.5, dy=0.5, dz=0.25)
    got = t_cld.cld_gen_cop(cot, cer, cth, dx=0.5, dy=0.5, dz=0.25)
    fz = next(f for f in (2, 3, 1) if ref.nz % f == 0)
    return ((ref, ref.coarsen((2, 4, fz)), ref.cot_2d,
             j_cld.cal_ext(cot, cer, dz_km=0.5)),
            (got, got.coarsen((2, 4, fz)), got.cot_2d,
             t_cld.cal_ext(cot, cer, dz_km=0.5)))


def case_pha_mie_wc(tmp_path):
    return _both('mie', lambda: _mie(j_pha), lambda: _mie(t_pha))


def case_build_phase_table_bench(tmp_path):
    jm, tm = case_pha_mie_wc(tmp_path)
    return (j_pha.build_phase_table(jm, forward_trunc_deg=25.0),
            t_pha.build_phase_table(tm, forward_trunc_deg=25.0))


def case_pha_hg_table(tmp_path):
    ref = j_pha.pha_hg(asy_params=(0.85, 0.7, -0.3))
    got = t_pha.pha_hg(asy_params=(0.85, 0.7, -0.3))
    return ((ref, j_pha.build_phase_table(ref, n_u=300, n_m=500),
             j_pha.build_phase_table(None)),
            (got, t_pha.build_phase_table(got, n_u=300, n_m=500),
             t_pha.build_phase_table(None)))


def case_sfc_2d_gen(tmp_path):
    rng = np.random.default_rng(3)
    maps = [rng.uniform(-0.1, 1.1, (5, 4)), rng.uniform(0, 0.3, (5, 4, 3)),
            rng.uniform(0, 1.4, (5, 4, 5))]
    return ([j_sfc.sfc_2d_gen(d) for d in maps] + [j_sfc.sfc_lambertian(0.3)],
            [t_sfc.sfc_2d_gen(d) for d in maps] + [t_sfc.sfc_lambertian(0.3)])


def case_sfc_ocean(tmp_path):
    u10 = np.array([0.5, 3.0, 12.0])
    return ((j_sfc.sfc_ocean(wvl=860.0, u10=7.0, nx=3, ny=2),
             j_sfc.cal_ocean_brdf(wvl=550.0, u10=u10),
             j_sfc.cal_ocean_brdf(wvl=550.0, u10=u10, whitecaps=False)),
            (t_sfc.sfc_ocean(wvl=860.0, u10=7.0, nx=3, ny=2),
             t_sfc.cal_ocean_brdf(wvl=550.0, u10=u10),
             t_sfc.cal_ocean_brdf(wvl=550.0, u10=u10, whitecaps=False)))


def case_aerosols(tmp_path):
    ja, ta = case_atm_bench(tmp_path)
    aod2d = np.random.default_rng(4).uniform(0, 0.5, (6, 5))

    def run(m, atm):
        a1 = m.aer_gen(0.3, ssa=0.92, asy=0.65, z_bottom=0.0, z_top=2.0)
        a3 = m.aer_gen(0.2, aod_2d=aod2d, nz=4, z_bottom=0.5, z_top=2.5)
        d1 = m.Aerosol1D(aod=0.1, z_bottom=1.0, z_top=1.0)
        return (a1, a3, d1,
                a1.extinction_profile(atm.lay.altitude, atm.lay.thickness),
                d1.extinction_profile(atm.lay.altitude, atm.lay.thickness))
    return run(j_aer, ja), run(t_aer, ta)


def case_solar(tmp_path):
    dates = [None, datetime.datetime(2019, 9, 2, 18),
             datetime.datetime(2020, 1, 3)]
    wvl = np.array([250.0, 650.0, 1640.0, 3900.0])
    return (([j_solar.sol_fac(d) for d in dates],
             j_solar.solar_irradiance(wvl), j_solar.solar_irradiance(650.0)),
            ([t_solar.sol_fac(d) for d in dates],
             t_solar.solar_irradiance(wvl), t_solar.solar_irradiance(650.0)))


def case_rayleigh(tmp_path):
    ja, ta = case_atm_bench(tmp_path)
    u = np.linspace(0.0, 1.0, 257)

    def run(m, atm):
        return (m.rayleigh_od(650.0, atm.lev.pressure, lat_deg=atm.lat),
                m.rayleigh_od(860.0, atm.lev.pressure,
                              lat_deg=60.0, co2_vmr=400e-6),
                m.gravity_surface(np.array([0.0, 45.0])),
                m.bodhaine_factor(0.65),
                m.sample_rayleigh_mu(np.clip(u, 1e-7, 1 - 1e-7)))
    return run(j_ray, ja), run(t_ray, ta)


def case_water_and_hg(tmp_path):
    mu = np.linspace(-1.0, 1.0, 101)
    wvl = np.array([300.0, 650.0, 2130.0])
    return ((j_water.water_refractive_index(wvl),
             j_hg.hg_phase(0.85, mu), j_hg.hg_phase(np.array([-0.3]), mu)),
            (t_water.water_refractive_index(wvl),
             t_hg.hg_phase(0.85, mu), t_hg.hg_phase(np.array([-0.3]), mu)))


def case_grid(tmp_path):
    ja, ta = case_atm_bench(tmp_path)
    q = np.array([0.26, 0.75, 1.25, 4.4, 19.9])
    d = np.arange(4 * 6 * 2, dtype=np.float64).reshape(4, 6, 2) ** 1.5
    ops = [(m.get_lay_index(q, a.lay.altitude), m.get_lay_index(0.7, [0, 1]),
            m.downscale_3d(d, (2, 3, 1)),
            m.downscale(d, (1, 2, 2), 'sum'), m.downscale(d, (4, 3, 1), 'max'))
           for m, a in ((j_grid, ja), (t_grid, ta))]
    return tuple(ops)


CASES = {name[5:]: fn for name, fn in sorted(globals().items())
         if name.startswith('case_')}


@pytest.mark.parametrize('case', sorted(CASES))
def test_port_copy_equals_reference(case, tmp_path):
    ref, got = CASES[case](tmp_path)
    assert_same(ref, got, case)


def test_sample_hg_mu_numpy_matches_reference():
    """The reference evaluates the HG sampler in JAX (f32); the port's copy
    in NumPy (f64): equal to f32 rounding."""
    g = np.array([0.0, 5e-5, 0.3, 0.85, -0.7])[:, None]
    u = np.linspace(1e-7, 1 - 1e-7, 41)[None, :]
    ref = np.asarray(j_hg.sample_hg_mu(g, u))
    got = t_hg.sample_hg_mu(g, u)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-6)


def test_build_scene_same_from_reference_or_port_objects(tmp_path):
    """build_scene is duck-typed: the reference's er3t_tpu.pre objects and
    the port's copies give identical SceneArrays and SceneStatic."""
    def objects(pre_atm, pre_abs, pre_cld, pre_pha, pre_aer, pre_sfc):
        atm = pre_atm.atm_atmmod(np.linspace(0, 20, 21))
        cld = pre_cld.cld_gen_hom(nx=6, ny=6, nz=2, dx=1.0, dy=1.0, cot0=6.0,
                                  cer0=10.0, cloud_base=1.0, cloud_top=3.0)
        sfc = pre_sfc.sfc_2d_gen(
            np.random.default_rng(5).uniform(0.0, 0.4, (6, 6)))
        return (atm, pre_abs.abs_synthetic(650.0, atm, ng=4)), dict(
            cld=cld, pha=pre_pha.pha_hg(asy_params=(0.8, 0.6)),
            aer_1ds=[pre_aer.Aerosol1D(aod=0.3)],
            aer_3ds=[pre_aer.Aerosol3D(extinction=cld.extinction * 0.2)],
            surface=sfc, solar_zenith_angle=40.0, forward_trunc_deg=15.0)
    (ja, jk), jkw = objects(j_atm, j_abs, j_cld, j_pha, j_aer, j_sfc)
    (ta, tk), tkw = objects(t_atm, t_abs, t_cld, t_pha, t_aer, t_sfc)
    j_arr, j_st = t_scene.build_scene(ja, jk, **jkw, device='cpu')
    t_arr, t_st = t_scene.build_scene(ta, tk, **tkw, device='cpu')
    assert t_st == j_st
    for f in t_scene.SceneArrays._fields:
        a, b = getattr(j_arr, f), getattr(t_arr, f)
        assert a.dtype == b.dtype and torch.equal(a, b), f

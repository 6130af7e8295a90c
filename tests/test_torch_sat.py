"""The port's satellite layer (``er3t_tpu_torch.sat``) against the reference's.

Every test of ``tests/test_sat.py`` is mirrored on the same writer
fixtures: it builds the reader of both packages on the same file, holds
every attribute of the port's object (``data``, ``qa``, ``logic``, ...)
equal to the reference's bit for bit, and asserts the reference test's own
claims on the port's object.  No test reaches the network: the download
functions run offline on injected pages and fetchers, as the reference's
do.  ``test_ahi_clp_writer_round_trip`` reads the granule that phase 11 of
``chip_smoke.py`` writes, and checks that the port reads it with no
``h5py``.
"""

import datetime
import os
import shutil

import h5py
import numpy as np
import pytest
import torch

import chip_smoke_files
from er3t_tpu.pre import cld as j_cld
from er3t_tpu.sat import ahi as j_ahi
from er3t_tpu.sat import calipso as j_calipso
from er3t_tpu.sat import daac as j_daac
from er3t_tpu.sat import modis as j_modis
from er3t_tpu.sat import oco2 as j_oco2
from er3t_tpu.sat import viirs as j_viirs
from er3t_tpu.util import ncio as j_ncio
from er3t_tpu_torch.pre import cld as t_cld
from er3t_tpu_torch.sat import ahi as t_ahi
from er3t_tpu_torch.sat import calipso as t_calipso
from er3t_tpu_torch.sat import daac as t_daac
from er3t_tpu_torch.sat import modis as t_modis
from er3t_tpu_torch.sat import oco2 as t_oco2
from er3t_tpu_torch.sat import viirs as t_viirs
from er3t_tpu_torch.util import geo as t_geo
from er3t_tpu_torch.util import ncio as t_ncio
from test_sat import (GEOMETA, _make_ahi_nc, _write_l1b_1km,  # noqa: F401
                      viirs03_file, viirs_file, viirs_file_full)
from test_torch_pre import assert_same

torch.set_num_threads(2)


def same_reader(ref, got):
    """Every attribute of two reader objects equal, bit for bit."""
    assert type(got).__name__ == type(ref).__name__
    assert sorted(vars(got)) == sorted(vars(ref))
    for k, v in vars(ref).items():
        assert_same(v, vars(got)[k], f'{type(ref).__name__}.{k}')


def both(name, j_mod, t_mod, *a, **kw):
    """(reference object, port object) of reader ``name`` on the same
    arguments, held equal attribute by attribute; port-side reader objects
    (``f03=``) are passed to the port's reader as ``t_<key>``."""
    t_kw = {k[2:]: v for k, v in kw.items() if k.startswith('t_')}
    j_kw = {k: v for k, v in kw.items() if not k.startswith('t_')}
    ref = getattr(j_mod, name)(*a, **j_kw)
    got = getattr(t_mod, name)(*a, **{**j_kw, **t_kw})
    same_reader(ref, got)
    return ref, got


# ---------------- VIIRS ----------------

def test_viirs_03_reader(viirs03_file):
    ext = (-60.5, -60.0, 14.5, 15.5)
    _, obj = both('viirs_03', j_viirs, t_viirs, [viirs03_file], extent=ext,
                  vnames=('height',))
    assert obj.data['sza']['data'].shape[0] < 20 * 16
    assert np.allclose(obj.data['sza']['data'], 30.0)
    assert np.allclose(obj.data['vaa']['data'], -90.0)
    assert np.all(obj.data['land_water_mask']['data'] == 3)
    assert np.allclose(obj.data['height']['data'], 120.0)

    _, obj2 = both('viirs_03', j_viirs, t_viirs, [viirs03_file], extent=ext,
                   keep_dims=True)
    assert obj2.data['lon']['data'].shape == (20, 16)
    mask = obj2.logic[t_viirs.get_fname_pattern(viirs03_file)]['mask']
    assert mask.shape == (20, 16)
    assert mask.sum() == obj.data['lon']['data'].size


def test_viirs_cldprop_f03_and_keep_dims(viirs03_file, tmp_path,
                                         viirs_file_full):
    l2 = os.path.join(tmp_path, 'CLDPROP_L2_VIIRS.A2019241.0942.nc')
    shutil.copy(viirs_file_full, l2)
    ext = (-60.5, -60.0, 14.5, 15.5)
    j03, t03 = both('viirs_03', j_viirs, t_viirs, [viirs03_file], extent=ext)
    _, obj = both('viirs_cldprop_l2', j_viirs, t_viirs, [l2], f03=j03,
                  t_f03=t03)
    n_sel = int(t03.logic['A2019241.0942']['mask'].sum())
    assert obj.data['cot']['data'].shape == (n_sel,)

    _, obj2 = both('viirs_cldprop_l2', j_viirs, t_viirs, [l2],
                   keep_dims=True)
    assert obj2.data['cot']['data'].shape == (20, 16)
    assert obj2.data['cwp']['data'].max() == pytest.approx(120.0, rel=0.01)
    _, obj3 = both('viirs_cldprop_l2', j_viirs, t_viirs, [l2], maskvars=True,
                   quality_assurance=2, keep_dims=True)
    assert obj3.data['land_water_cat']['data'].shape == (20, 16)
    assert obj3.qa['bowtie_qa']['data'].shape == (20, 16)


def test_viirs_l1b_f03_alignment(viirs03_file, tmp_path):
    ny, nx = 20, 16
    fn = os.path.join(tmp_path, 'VNP02MOD.A2019241.0942.nc')
    counts = np.arange(ny * nx, dtype=np.uint16).reshape(ny, nx)
    with h5py.File(fn, 'w') as f:
        g = f.create_group('observation_data')
        d = g.create_dataset('M05', data=counts)
        d.attrs['scale_factor'] = 1e-4
        d.attrs['add_offset'] = 0.0
        d.attrs['_FillValue'] = np.uint16(65535)
        d.attrs['radiance_scale_factor'] = 2e-4
        d.attrs['radiance_add_offset'] = 0.0
    ext = (-60.5, -60.0, 14.5, 15.5)
    j03, f03 = both('viirs_03', j_viirs, t_viirs, [viirs03_file], extent=ext)
    _, o = both('viirs_l1b', j_viirs, t_viirs, [fn], f03=j03, t_f03=f03)
    n_sel = f03.data['lon']['data'].size
    assert o.data['ref']['data'].shape == (n_sel,)
    assert o.data['rad']['data'].shape == (n_sel,)
    assert o.data['lon']['data'].size == n_sel
    mask = f03.logic['A2019241.0942']['mask']
    np.testing.assert_allclose(o.data['ref']['data'],
                               counts[mask] * 1e-4, rtol=1e-6)
    _, o2 = both('viirs_l1b', j_viirs, t_viirs, [fn], f03=j03, t_f03=f03,
                 keep_dims=True)
    assert o2.data['ref']['data'].shape == (ny * nx,) \
        or o2.data['ref']['data'].size == ny * nx


def test_viirs_cldprop_full_sds(viirs_file_full):
    _, obj = both('viirs_cldprop_l2', j_viirs, t_viirs, [viirs_file_full])
    d = obj.data
    assert d['cwp']['data'].max() == pytest.approx(120.0, rel=0.01)
    assert d['cth']['data'].max() == pytest.approx(2.5, rel=0.01)
    pcl = d['pcl']['data']
    assert pcl.sum() == 1
    assert d['cot']['data'][pcl == 1] == pytest.approx(5.0, rel=0.01)
    assert d['cwp']['data'][pcl == 1] == pytest.approx(30.0, rel=0.01)
    cu = d['cot_uct']['data']
    assert cu.max() == pytest.approx(15.0 * (15.0 * 10) / 100.0, rel=0.02)


def test_viirs_cldprop_mask_and_qa(viirs_file_full):
    _, obj = both('viirs_cldprop_l2', j_viirs, t_viirs, [viirs_file_full],
                  maskvars=True, quality_assurance=2)
    d = obj.data
    assert np.all(d['land_water_cat']['data'] == 3)
    assert np.all(d['snow_ice_flag']['data'] == 0)
    assert np.all(d['sunglint_flag']['data'] == 0)
    assert np.all(d['day_night_flag']['data'] == 1)
    assert np.all(d['fov_qa_cat']['data'] == 2)
    assert np.all(d['cloud_mask_flag']['data'] == 1)
    assert np.all(obj.qa['ret_1621_qa']['data'] == 0)
    assert np.all(obj.qa['ret_1621_conf_qa']['data'] == 2)
    assert np.all(obj.qa['ret_1621_data_qa']['data'] == 1)
    assert np.all(obj.qa['ret_std_qa']['data'] == 1)
    assert np.all(obj.qa['ret_std_conf_qa']['data'] == 3)
    assert np.all(obj.qa['ret_std_data_qa']['data'] == 0)
    assert np.all(obj.qa['bowtie_qa']['data'] == 1)
    assert np.all(obj.qa['cot_oob_qa']['data'] == 0)
    assert np.all(obj.qa['cot_bands_qa']['data'] == 1)
    assert np.all(obj.qa['rayleigh_qa']['data'] == 0)
    assert np.all(obj.qa['cld_type_qa']['data'] == 3)


def test_viirs_reader_and_gridding(viirs_file):
    _, obj = both('viirs_cldprop_l2', j_viirs, t_viirs, [viirs_file],
                  extent=(-60.5, -59.5, 14.5, 15.5), nx=30, ny=40)
    assert obj.data['cot_2d']['data'].shape == (30, 40)
    assert obj.data['cot_2d']['data'].max() == pytest.approx(15.0, rel=0.01)
    assert obj.data['cer_2d']['data'].max() == pytest.approx(12.0, rel=0.01)


def test_satellite_pipeline_radiance(viirs_file):
    """reader -> cld_sat -> 3D nadir radiance: cld_sat bit for bit across
    the packages, each package's reader object fed to the other's cld_sat;
    then the port's solve (the reference's budget) and its closure."""
    from er3t_tpu_torch.pre.abs import abs_synthetic
    from er3t_tpu_torch.pre.atm import atm_atmmod
    from er3t_tpu_torch.pre.pha import pha_mie_wc
    from er3t_tpu_torch.rtm.solver import solve

    j_obj, obj = both('viirs_cldprop_l2', j_viirs, t_viirs, [viirs_file],
                      extent=(-60.5, -59.5, 14.5, 15.5), nx=16, ny=16)
    kw = dict(dx=0.25, dy=0.25, cth=2.0, cgt=1.0, dz=0.5)
    cld = t_cld.cld_sat(obj, **kw)
    for c in (j_cld.cld_sat(j_obj, **kw), j_cld.cld_sat(obj, **kw),
              t_cld.cld_sat(j_obj, **kw)):
        assert_same(c, cld, 'cld_sat')
    assert cld.cot_2d.max() > 10.0
    atm = atm_atmmod(np.concatenate([np.arange(0, 3.0, 0.5),
                                     np.arange(3.0, 20.1, 1.0)]))
    ab = abs_synthetic(650.0, atm)
    pha = pha_mie_wc(650.0, n_quad=16)
    res = solve(atm=atm, abs_coef=ab, cld=cld, pha=pha, surface=0.03,
                target='radiance', photons=60000, n_run=1, batch=1 << 12,
                forward_trunc_deg=5.0, device='cpu')
    rad = res['rad']
    assert rad.shape == (16, 16)
    assert np.isfinite(rad).all()
    cloudy = cld.cloud_mask_2d
    assert rad[cloudy].mean() > 2.0 * rad[~cloudy].mean()


def test_viirs_tile_products(tmp_path):
    n = 24
    f1 = tmp_path / 'VNP09A1.A2019241.h09v05.002.h5'
    with h5py.File(f1, 'w') as f:
        f['SurfReflect_M4'] = np.full((n, n), 0.23)
    _, o = both('viirs_09a1', j_viirs, t_viirs, [str(f1)], band='M4')
    assert o.data['ref']['data'].shape == (n, n)
    np.testing.assert_allclose(o.data['ref']['data'], 0.23)
    assert 29.5 <= o.data['lat']['data'].min() <= 30.5
    assert o.data['lat']['data'].max() < 40.01
    lat2, lon2 = o.data['lat']['data'], o.data['lon']['data']
    assert np.all(np.diff(lat2[:, 0]) < 0)
    assert np.allclose(lat2[0, :], lat2[0, 0])
    assert np.all(np.diff(lon2[0, :]) > 0)

    f2 = tmp_path / 'VNP43MA3.A2019241.h09v05.002.h5'
    with h5py.File(f2, 'w') as f:
        f['Albedo_BSA_M4'] = np.full((n, n), 0.11)
        f['Albedo_WSA_M4'] = np.full((n, n), 0.14)
    _, o = both('viirs_43ma3', j_viirs, t_viirs, [str(f2)], channels=('M4',))
    np.testing.assert_allclose(o.data['wsa']['data'][..., 0], 0.14)
    np.testing.assert_allclose(o.data['alb_2d']['data'], 0.14)

    f3 = tmp_path / 'VNP43MA4.A2019241.h09v05.002.h5'
    with h5py.File(f3, 'w') as f:
        f['Nadir_Reflectance_M4'] = np.full((n, n), 0.19)
    _, o = both('viirs_43ma4', j_viirs, t_viirs, [str(f3)], channels=('M4',))
    np.testing.assert_allclose(o.data['ref']['data'][..., 0], 0.19)

    name = 'x/VNP09A1.A2019241.h09v05.002.h5'
    assert t_viirs.get_fname_pattern(name) == 'A2019241.h09v05' \
        == j_viirs.get_fname_pattern(name)


# ---------------- OCO-2, CALIPSO, AHI ----------------

def test_oco2_reader(tmp_path):
    fname = os.path.join(tmp_path, 'oco2_std.h5')
    with h5py.File(fname, 'w') as f:
        f['RetrievalGeometry/retrieval_longitude'] = np.array([-60.1, -60.2])
        f['RetrievalGeometry/retrieval_latitude'] = np.array([15.0, 15.1])
        f['RetrievalResults/xco2'] = np.array([405e-6, 406e-6])
    _, obj = both('oco2_std', j_oco2, t_oco2, [fname])
    assert obj.data['xco2']['data'] == pytest.approx([405.0, 406.0])


def test_photon_radiance_conversion():
    v = t_oco2.photon_to_radiance(1e18, 765.0)
    assert v == j_oco2.photon_to_radiance(1e18, 765.0)
    assert v == pytest.approx(2.6e-4, rel=0.01)
    x = np.linspace(1e17, 1e19, 7)
    assert_same(j_oco2.photon_to_radiance(x, 757.0),
                t_oco2.photon_to_radiance(x, 757.0))


def test_calipso_vfm_machinery(tmp_path):
    url = t_calipso.cmr_vfm_search_url(datetime.date(2019, 8, 1),
                                       (-60, -59, 14, 15))
    assert url == j_calipso.cmr_vfm_search_url(datetime.date(2019, 8, 1),
                                               (-60, -59, 14, 15))
    assert 'C2667982867-LARC_ASDC' in url and 'boundingBox=-60.00' in url

    row = np.arange(5515, dtype=np.uint16)
    blk = t_calipso.vfm_row2block(row)
    assert_same(j_calipso.vfm_row2block(row), blk)
    assert blk.shape == (545, 15)
    assert np.all(blk[:55, 0] == blk[:55, 4])
    assert np.all(blk[:55, 0] == row[:55])
    off = 3 * 55 + 5 * 200
    assert np.all(blk[255:, 3] == row[off + 3 * 290: off + 4 * 290])
    alt = t_calipso.vfm_altitude()
    assert_same(j_calipso.vfm_altitude(), alt)
    assert alt.size == 545 and alt[0] > 29.9 and alt[-1] < -0.4
    flags = np.array([2 + 8, 5 + 64])
    assert t_calipso.extract_type(flags).tolist() == [2, 5]
    assert_same(j_calipso.extract_type(flags), t_calipso.extract_type(flags))
    new_alt = t_calipso.uniform_alt(8.0, alt)
    assert_same(j_calipso.uniform_alt(8.0, alt), new_alt)
    mat = np.random.default_rng(3).integers(0, 8, (545, 15))
    assert_same(j_calipso.regrid_lidar(alt, mat, new_alt),
                t_calipso.regrid_lidar(alt, mat, new_alt))

    fn = tmp_path / 'CAL_LID_L2_VFM.h5'
    nrec = 4
    with h5py.File(fn, 'w') as f:
        f['Longitude'] = np.linspace(-59.9, -59.1, nrec)[:, None]
        f['Latitude'] = np.linspace(14.1, 14.9, nrec)[:, None]
        f['Feature_Classification_Flags'] = \
            np.ones((nrec, 5515), np.uint16) * 2
    out = t_calipso.read_calipso_vfm(str(fn), extent=(-60, -59, 14, 15))
    assert_same(j_calipso.read_calipso_vfm(str(fn), extent=(-60, -59, 14, 15)),
                out)
    assert out['feature_type']['data'].shape[1] == nrec * 15
    assert np.all(out['feature_type']['data'] == 2)


def test_ahi_reader_synthetic(tmp_path):
    fn = str(tmp_path / 'ahi.nc')
    _make_ahi_nc(fn)
    j_a, a = both('ahi_l2', j_ahi, t_ahi, [fn],
                  extent=(121.0, 124.0, 10.5, 13.5), nx=8, ny=8)
    assert a.data['cot']['data'].max() == 12.0
    assert a.data['cot_2d']['data'].shape == (8, 8)
    assert a.data['cot_2d']['data'].max() > 0
    a.read_vars(['CLTH'])
    j_a.read_vars(['CLTH'])
    same_reader(j_a, a)
    assert 'clth' in a.data and a.data['clth']['data'].max() == 2.5
    cld = t_cld.cld_sat(a, cth=2.5, cgt=1.0)
    for c in (j_cld.cld_sat(j_a, cth=2.5, cgt=1.0),
              j_cld.cld_sat(a, cth=2.5, cgt=1.0),
              t_cld.cld_sat(j_a, cth=2.5, cgt=1.0)):
        assert_same(c, cld, 'cld_sat')
    assert cld.extinction.max() > 0


def test_ahi_clp_writer_round_trip(tmp_path):
    """chip_smoke_files.write_ahi_clp at a small grid (with fill beyond the
    disk's edge), read by both packages' ahi_l2 with the whole-degree
    extent's edges on samples: equal arrays.  That the port reads it with
    no h5py loaded is held by test_phase11_path_loads_no_h5py
    (tests/test_torch_imports.py)."""
    fn = chip_smoke_files.write_ahi_clp(
        str(tmp_path / 'clp.nc'), seed=3, lon=(190.0, 200.0),
        lat=(55.0, 45.0))
    ext = (191.0, 199.0, 46.0, 54.0)
    j_a, a = both('ahi_l2', j_ahi, t_ahi, [fn], extent=ext, nx=16, ny=12)
    a.read_vars(['CLTH'])
    j_a.read_vars(['CLTH'])
    same_reader(j_a, a)
    assert a.data['cot']['data'].size == 161 * 161
    cot = a.data['cot']['data']
    assert 0 < (cot > 0).mean() < 1 and cot.max() <= 60.0
    clth = a.data['clth']['data']
    assert 0 < np.isnan(clth).mean() < 1                # beyond the edge


# ---------------- MODIS ----------------

def test_sinusoidal_grid_tags():
    assert t_modis.get_sinusoidal_grid_tag([-105.2], [40.1]) == ['h09v04']
    tags = t_modis.get_sinusoidal_grid_tag([0.1], [0.1])
    assert tags == j_modis.get_sinusoidal_grid_tag([0.1], [0.1])
    assert 'h18v08' in tags
    gx, gy = t_modis.cal_sinusoidal_grid()
    assert_same(j_modis.cal_sinusoidal_grid(), (gx, gy))
    assert gx.size == 37 and gy.size == 19 and gy[0] > gy[-1]
    lon, lat = np.linspace(-170, 170, 9), np.linspace(-80, 80, 9)
    assert_same(j_modis.sinusoidal_xy(lon, lat), t_modis.sinusoidal_xy(lon, lat))


def test_upscale_modis_lonlat():
    ny, nx = 8, 10
    lat0, lon0 = np.meshgrid(np.linspace(10, 11.4, ny),
                             np.linspace(-40, -38.2, nx), indexing='ij')
    lon, lat = t_modis.upscale_modis_lonlat(lon0.copy(), lat0, scale=5,
                                            extra_grid=True)
    assert_same(j_modis.upscale_modis_lonlat(lon0.copy(), lat0, scale=5,
                                             extra_grid=True), (lon, lat))
    assert lon.shape == (ny * 5, nx * 5 + 4)
    assert lat[7, 0] == pytest.approx(lat0[1, 0], abs=1e-9)
    assert lon[0, 7] == pytest.approx(lon0[0, 1], abs=1e-9)
    assert np.all(np.diff(lat[:, 0]) > 0)
    assert np.all(np.diff(lon[0, :]) > 0)


def test_modis_07_reader(tmp_path):
    fn = tmp_path / 'MYD07_L2.A2019245.h5'
    ny, nx, nlev = 6, 5, 20
    with h5py.File(fn, 'w') as f:
        f['Longitude'] = np.full((ny, nx), -59.9)
        f['Latitude'] = np.full((ny, nx), 15.1)
        f['Pressure_Levels'] = np.linspace(5, 1000, nlev)
        f['Retrieved_Temperature_Profile'] = \
            np.linspace(200, 290, nlev)[:, None, None] * np.ones((1, ny, nx))
        f['Surface_Pressure'] = np.full((ny, nx), 1013.0)
        f['Solar_Zenith'] = np.full((ny, nx), 30.0)
    _, obj = both('modis_07', j_modis, t_modis, fnames=[str(fn)],
                  extent=(-60.5, -59.5, 14.5, 15.5))
    assert obj.data['T_level_retrieved']['data'].shape == (ny * nx, nlev)
    assert obj.data['p_level']['data'].size == nlev
    assert obj.data['p_sfc']['data'][0] == 1013.0


def test_modis_l1b_1km_emissive(tmp_path):
    fn = _write_l1b_1km(str(tmp_path / 'MYD021KM.A2019226.h5'))
    _, obj = both('modis_l1b', j_modis, t_modis, [fn], band=31)
    rad = obj.data['rad']['data'].reshape(8, 10)
    assert rad[1, 1] == pytest.approx((2000.0 - 100.0) * 0.02 / 1000.0)
    assert np.isnan(rad[0, 0])
    assert np.isnan(obj.data['ref']['data']).all()
    uct = obj.data['uct']['data'].reshape(8, 10)
    assert uct[1, 1] == pytest.approx(1.5 * np.exp(5.0 / 7.0))
    assert obj.data['wvl']['data'] == 11030.0


def test_modis_l1b_multiband_mixed(tmp_path):
    fn = _write_l1b_1km(str(tmp_path / 'MYD021KM.A2019226.h5'))
    _, obj = both('modis_l1b', j_modis, t_modis, [fn], bands=[1, 6, 26, 31])
    rad = obj.data['rad']['data']
    assert rad.shape == (4, 80)
    assert rad[0, 11] == pytest.approx((1000 - 100) * 0.01 / 1000)
    assert rad[1, 11] == pytest.approx((1300 - 100) * 0.01 / 1000)
    assert rad[2, 11] == pytest.approx((2200 - 100) * 0.01 / 1000)
    assert rad[3, 11] == pytest.approx((2000 - 100) * 0.02 / 1000)
    assert np.isfinite(obj.data['ref']['data'][0, 11])
    assert obj.data['cnt']['data'][0, 11] == pytest.approx(1000.0)
    assert np.isnan(obj.data['ref']['data'][3, 11])
    np.testing.assert_allclose(obj.data['wvl']['data'],
                               [650.0, 1640.0, 1380.0, 11030.0])


def test_modis_l1b_band_validation(tmp_path):
    fn = _write_l1b_1km(str(tmp_path / 'MYD02QKM.A2019226.h5'))
    bad = str(tmp_path / 'MYD02XYZ.A2019226.h5')
    for mod in (j_modis, t_modis):
        with pytest.raises(KeyError):
            mod.modis_l1b([fn], band=31)
        with pytest.raises(ValueError):
            mod.modis_l1b([bad], band=1)


def test_modis_l2_qa_phase_pcl(tmp_path):
    fname = str(tmp_path / 'MOD06_L2.synthetic.h5')
    n = 10
    lon = np.linspace(-60.0, -59.0, n)[None, :].repeat(n, axis=0)
    lat = np.linspace(10.0, 11.0, n)[:, None].repeat(n, axis=1)
    cot = np.full((n, n), 8.0)
    cer = np.full((n, n), 12.0)
    cwp = np.full((n, n), 50.0)
    ctp = np.full((n, n), 2, np.int16)
    cot[0, 0] = -1.0
    ctp[0, 1] = 0
    cot[1, 0] = 0.0; cer[1, 0] = 0.0; cwp[1, 0] = 0.0; ctp[1, 0] = 1
    cot[2, 2] = 0.0; cer[2, 2] = 0.0; cwp[2, 2] = 0.0
    cot_pcl = np.zeros((n, n)); cer_pcl = np.zeros((n, n))
    cwp_pcl = np.zeros((n, n))
    cot_pcl[2, 2] = 5.0; cer_pcl[2, 2] = 9.0; cwp_pcl[2, 2] = 30.0
    with h5py.File(fname, 'w') as f:
        f['Longitude'] = lon
        f['Latitude'] = lat
        f['Cloud_Optical_Thickness'] = cot
        f['Cloud_Effective_Radius'] = cer
        f['Cloud_Water_Path'] = cwp
        f['Cloud_Top_Height'] = np.full((n, n), 2000.0)
        f['Cloud_Phase_Optical_Properties'] = ctp
        f['Cloud_Optical_Thickness_PCL'] = cot_pcl
        f['Cloud_Effective_Radius_PCL'] = cer_pcl
        f['Cloud_Water_Path_PCL'] = cwp_pcl
        f['Cloud_Optical_Thickness_Uncertainty'] = np.full((n, n), 10.0)
        f['Cloud_Effective_Radius_Uncertainty'] = np.full((n, n), 5.0)
        f['Cloud_Water_Path_Uncertainty'] = np.full((n, n), 20.0)
        f['Extra_QA'] = np.arange(n * n, dtype=np.float32).reshape(n, n)
    _, m = both('modis_l2', j_modis, t_modis, fname, vnames=('Extra_QA',))
    d = {k: m.data[k]['data'].reshape(n, n) for k in
         ('cot', 'cer', 'cwp', 'pcl', 'cot_err', 'cer_err')}
    assert d['cot'][0, 0] == 0.0 and d['cer'][0, 0] == 0.0
    assert d['cot'][0, 1] == 0.0
    assert d['cot'][1, 0] == 0.0 and d['pcl'][1, 0] == 0
    assert d['pcl'][2, 2] == 1
    assert d['cot'][2, 2] == 5.0 and d['cer'][2, 2] == 9.0
    assert d['cwp'][2, 2] == 30.0
    assert d['cot_err'][5, 5] == pytest.approx(8.0 * 10.0 / 100.0)
    assert d['cer_err'][5, 5] == pytest.approx(12.0 * 5.0 / 100.0)
    assert 'extra_qa' in m.data and m.data['extra_qa']['data'].size == n * n


def test_modis_03_vnames_keepdims(tmp_path):
    fname = os.path.join(tmp_path, 'MOD03.h5')
    ny, nx = 10, 8
    lon, lat = np.meshgrid(np.linspace(-60.4, -59.6, nx),
                           np.linspace(14.6, 15.4, ny))
    with h5py.File(fname, 'w') as f:
        f.create_dataset('Longitude', data=lon.astype(np.float32))
        f.create_dataset('Latitude', data=lat.astype(np.float32))
        for k in ('SolarZenith', 'SolarAzimuth', 'SensorZenith',
                  'SensorAzimuth'):
            d = f.create_dataset(k, data=np.full((ny, nx), 3000, np.int16))
            d.attrs['scale_factor'] = 0.01
        f.create_dataset('Height', data=np.full((ny, nx), 123.0, np.float32))
    _, obj = both('modis_03', j_modis, t_modis, [fname],
                  extent=(-61, -59, 14, 16), vnames=['Height'])
    assert obj.data['height']['data'].shape == (ny * nx,)
    assert obj.data['height']['data'][0] == pytest.approx(123.0)
    assert obj.data['vza']['data'][0] == pytest.approx(30.0)
    _, obj2 = both('modis_03', j_modis, t_modis, [fname],
                   extent=(-61, -59, 14, 16), keep_dims=True)
    assert obj2.data['lon']['data'].shape == (ny, nx)
    assert obj2.logic[fname]['1km'].shape == (ny, nx)


def test_modis_l2_5km_geolocation_upscale(tmp_path):
    ny5, nx5 = 8, 10
    ny1, nx1 = ny5 * 5, nx5 * 5 + 4
    lat5, lon5 = np.meshgrid(np.linspace(10, 11.4, ny5),
                             np.linspace(-40, -38.2, nx5), indexing='ij')
    fname = str(tmp_path / 'MOD06_L2.5km.h5')
    with h5py.File(fname, 'w') as f:
        f['Longitude'] = lon5
        f['Latitude'] = lat5
        f['Cloud_Optical_Thickness'] = np.full((ny1, nx1), 8.0)
        f['Cloud_Effective_Radius'] = np.full((ny1, nx1), 12.0)
        f['Cloud_Phase_Optical_Properties'] = np.full((ny1, nx1), 2,
                                                      np.int16)
    _, m = both('modis_l2', j_modis, t_modis, fname)
    assert m.data['cot']['data'].size == ny1 * nx1
    assert m.data['lon']['data'].size == ny1 * nx1
    lon = m.data['lon']['data']
    assert lon.min() >= lon5.min() - 0.3 and lon.max() <= lon5.max() + 0.3


def test_download_modis_rgb_offline(tmp_path):
    d = datetime.date(2019, 8, 25)
    ext = (-61.0, -59.0, 14.0, 16.0)
    seen = {}
    for mod, sub in ((j_modis, 'j'), (t_modis, 't')):
        fetched = {}

        def fake_get(url, headers):
            fetched['url'] = url
            yield b'x' * 256
        fdir = tmp_path / sub
        fdir.mkdir()
        fn = mod.download_modis_rgb(d, ext, which='aqua', fdir=str(fdir),
                                    _get=fake_get)
        assert os.path.exists(fn) and 'aqua_rgb_2019-08-25' in fn
        assert 'MODIS_Aqua_CorrectedReflectance_TrueColor' in fetched['url']
        assert '2019-08-25' in fetched['url']
        fn2 = mod.download_modis_rgb(d, ext, fdir=str(fdir), run=False)
        assert fn2.endswith('.png') and not os.path.exists(fn2)
        with pytest.raises(ValueError):
            mod.download_modis_rgb(d, ext, which='suomi', run=False)
        seen[sub] = (os.path.basename(fn), fetched['url'],
                     os.path.basename(fn2))
    assert seen['t'] == seen['j']


# ---------------- DAAC (offline) ----------------

def test_geometa_search_offline():
    text = (
        '# GranuleID,StartDateTime,ArchiveSet,OrbitNumber,DayNightFlag,'
        'EastBoundingCoord,NorthBoundingCoord,SouthBoundingCoord,'
        'WestBoundingCoord,GRingLongitude1,GRingLongitude2,GRingLongitude3,'
        'GRingLongitude4,GRingLatitude1,GRingLatitude2,GRingLatitude3,'
        'GRingLatitude4\n'
        'MYD03.A2019237.1755.061.h5,2019-08-25 17:55,61,1,D,'
        '-55,20,10,-65,-65,-55,-55,-65,10,10,20,20\n'
        'MYD03.A2019237.1800.061.h5,2019-08-25 18:00,61,1,D,'
        '0,60,50,-10,-10,0,0,-10,50,50,60,60\n')
    kw = dict(lon=-60.0, lat=15.0, geometa_text=text)
    hits = t_daac.find_granules('MYD03', datetime.date(2019, 8, 25), **kw)
    assert_same(j_daac.find_granules('MYD03', datetime.date(2019, 8, 25),
                                     **kw), hits)
    assert_same(j_daac.parse_geometa(text), t_daac.parse_geometa(text))
    assert len(hits) == 1
    assert hits[0]['granule'].endswith('1755.061.h5')


def test_granule_and_worldview_urls():
    d = datetime.date(2019, 8, 25)
    url = t_daac.granule_url('MOD06_L2', d, 'g.hdf')
    assert url == j_daac.granule_url('MOD06_L2', d, 'g.hdf')
    assert '/61/MOD06_L2/2019/237/g.hdf' in url
    wv = t_daac.worldview_image_url(d, (-61, -59, 14, 16))
    assert wv == j_daac.worldview_image_url(d, (-61, -59, 14, 16))
    assert 'GetSnapshot' in wv and '2019-08-25' in wv
    assert t_daac.geometa_url('MYD06_L2', d) == \
        j_daac.geometa_url('MYD06_L2', d)


def test_daac_url_builders():
    d = datetime.date(2019, 9, 2)
    cases = (('lance_url', (d, '61/MYD06_L2',
                            'MYD06_L2.A2019245.0400.061.nrt.hdf')),
             ('nsidc_url', (d, 'MYD29', '61', 'MYD29.A2019245.0400.061.h5')),
             ('oco2_url', (datetime.datetime(2019, 9, 2, 4),
                           'OCO2_L2_Standard.11r', 'oco2_L2StdND_27502a.h5')))
    urls = {}
    for name, a in cases:
        urls[name] = getattr(t_daac, name)(*a)
        assert urls[name] == getattr(j_daac, name)(*a)
    assert urls['lance_url'] == (
        'https://nrt3.modaps.eosdis.nasa.gov/archives/allData/'
        '61/MYD06_L2/2019/245/MYD06_L2.A2019245.0400.061.nrt.hdf')
    assert '/MOSA/MYD29.061/2019.09.02/' in urls['nsidc_url']
    assert urls['oco2_url'].endswith(
        '/OCO2_DATA/OCO2_L2_Standard.11r/2019/245/oco2_L2StdND_27502a.h5')


def test_final_file_check(tmp_path):
    good = tmp_path / 'good.h5'
    with h5py.File(good, 'w') as f:
        f['x'] = np.arange(3)
    bad = tmp_path / 'bad.h5'
    bad.write_bytes(b'not an hdf5 file')
    for mod in (j_daac, t_daac):
        assert mod.final_file_check(str(good))
        assert not mod.final_file_check(str(bad))
        assert not mod.final_file_check(str(tmp_path / 'missing.h5'))


def test_daac_catalog_breadth():
    assert_same(j_daac.SAT_TAGS, t_daac.SAT_TAGS)
    assert len(t_daac.SAT_TAGS) >= 44
    for tag, meta in t_daac.SAT_TAGS.items():
        for key in ('dataset_tag', 'dict_key', 'description', 'satellite',
                    'instrument', 'website', 'daac', 'archive', 'sat'):
            assert key in meta, (tag, key)
    assert t_daac.SAT_TAGS['VNP_CLDPROP_L2']['dataset_tag'] == \
        '5111/CLDPROP_L2_VIIRS_SNPP'
    assert t_daac.SAT_TAGS['MYD_CLDMSK_L2']['dataset_tag'] == \
        '5110/CLDMSK_L2_MODIS_Aqua'
    assert t_daac.SAT_TAGS['oco2_L2StdND']['daac'] == 'gesdisc'


def test_daac_find_granules_offline():
    d = datetime.date(2019, 8, 25)
    hits = t_daac.find_granules('MYD06_L2', d, -60.0, 15.0,
                                geometa_text=GEOMETA)
    assert_same(j_daac.find_granules('MYD06_L2', d, -60.0, 15.0,
                                     geometa_text=GEOMETA), hits)
    assert [h['granule'] for h in hits] == ['MYD06_L2.A2019237.1830.061.x.hdf']
    hits_n = t_daac.find_granules('MYD06_L2', d, -60.0, 35.0,
                                  geometa_text=GEOMETA, day_only=False)
    assert_same(j_daac.find_granules('MYD06_L2', d, -60.0, 35.0,
                                     geometa_text=GEOMETA, day_only=False),
                hits_n)
    assert len(hits_n) == 1 and hits_n[0]['day_night'] == 'N'


def test_daac_dateline_swath():
    d = datetime.date(2019, 8, 25)
    for lon in (178.0, -178.0):
        hits = t_daac.find_granules('MYD06_L2', d, lon, 0.0,
                                    geometa_text=GEOMETA)
        assert_same(j_daac.find_granules('MYD06_L2', d, lon, 0.0,
                                         geometa_text=GEOMETA), hits)
        assert len(hits) == 1, lon
    assert not t_daac.find_granules('MYD06_L2', d, 150.0, 0.0,
                                    geometa_text=GEOMETA)


def test_daac_granules_over_extent():
    d = datetime.date(2019, 8, 25)
    out = {}
    for ext in ((-62, -58, 12, 16), (-62, -58, 17.5, 21)):
        out[ext] = t_daac.granules_over_extent('MYD06_L2', d, ext,
                                               geometa_text=GEOMETA)
        assert_same(j_daac.granules_over_extent('MYD06_L2', d, ext,
                                                geometa_text=GEOMETA),
                    out[ext])
    recs, recs2 = out.values()
    assert len(recs) == 1 and recs[0]['coverage'] > 0.5
    assert recs2 and 0.0 < recs2[0]['coverage'] < 1.0


def test_daac_swath_lonlat_utc():
    rec = t_daac.find_granules('MYD06_L2', datetime.date(2019, 8, 25),
                               -60.0, 15.0, geometa_text=GEOMETA)[0]
    lon, lat, utc = t_daac.swath_lonlat_utc(rec, nx=16, ny=16)
    assert_same(j_daac.swath_lonlat_utc(rec, nx=16, ny=16), (lon, lat, utc))
    assert lon.shape == lat.shape == utc.shape == (16, 16)
    assert lon.min() >= -66 and lon.max() <= -55
    assert 10 <= lat.min() and lat.max() <= 20
    np.testing.assert_allclose(utc[:, 0], 18.5)
    assert np.all(np.diff(utc[0]) > 0)


def test_download_retry_and_validation(tmp_path):
    """The port's download_url with a stubbed fetch: a flaky server
    succeeds on the third attempt, a short payload raises after the
    retries; the reference's makes the same calls."""
    for mod, sub in ((j_daac, 'j'), (t_daac, 't')):
        calls = {'n': 0}

        def flaky(url, headers):
            calls['n'] += 1
            if calls['n'] < 3:
                raise IOError('connection reset')
            return [b'x' * 4096]
        fdir = tmp_path / sub
        fdir.mkdir()
        out = mod.download_url('https://example.invalid/fake.bin', str(fdir),
                               min_size=1024, retries=3, backoff=0.0,
                               _get=flaky)
        assert calls['n'] == 3 and out.endswith('fake.bin')
        assert os.path.getsize(out) == 4096

        def short(url, headers):
            return [b'tiny']
        with pytest.raises(IOError, match='after 2 attempts'):
            mod.download_url('https://example.invalid/fake2.bin', str(fdir),
                             min_size=1024, retries=2, backoff=0.0,
                             _get=short)


def test_worldview_stamped_download(tmp_path):
    dt = datetime.datetime(2019, 8, 25, 18, 30)
    ext = (-61.0, -59.0, 14.0, 16.0)
    url, fname = t_daac.download_worldview_image(
        dt, ext, product='MYDRGB', fdir_out=str(tmp_path), run=False)
    assert (url, fname) == j_daac.download_worldview_image(
        dt, ext, product='MYDRGB', fdir_out=str(tmp_path), run=False)
    assert fname == j_daac.worldview_image_fname('MYDRGB', dt, ext,
                                                 fdir_out=str(tmp_path)) \
        == t_daac.worldview_image_fname('MYDRGB', dt, ext,
                                        fdir_out=str(tmp_path))
    assert 'MODIS_Aqua_CorrectedReflectance' in url and '2019-08-25' in url
    assert 'MYDRGB_2019-08-25-1830Z_' in fname
    url2, fname2 = t_daac.download_worldview_image(
        dt, ext, product='MYDRGB', fdir_out=str(tmp_path),
        _get=lambda u, h: [b'p' * 256])
    assert os.path.isfile(fname2) and os.path.getsize(fname2) == 256


def test_nsidc_oco2_downloaders_offline():
    html = '''<html><a href="../">up</a>
    <a href="MOD29.A2019237.0355.061.h5">x</a>
    <a href="MOD29.A2019237.0400.061.h5">x</a>
    <a href="MOD29.A2019237.0400.061.h5">dup</a>
    <a href="MOD29.A2019237.1200.061.h5">x</a>
    <a href="MOD29.A2019237.0400.061.h5.xml">meta</a>
    <a href="browse/">dir</a></html>'''
    names = t_daac.list_remote_dir('http://x/', html_text=html)
    assert names == j_daac.list_remote_dir('http://x/', html_text=html)
    assert names == ['MOD29.A2019237.0355.061.h5',
                     'MOD29.A2019237.0400.061.h5',
                     'MOD29.A2019237.1200.061.h5',
                     'MOD29.A2019237.0400.061.h5.xml']

    d = datetime.date(2019, 8, 25)
    kw = dict(product_dict={'short_name': 'MOD29', 'version': '61'},
              filename_tags='A2019237', data_format='h5', run=False,
              start_dt_hhmm=datetime.datetime(2019, 8, 25, 3, 0),
              end_dt_hhmm=datetime.datetime(2019, 8, 25, 5, 0),
              html_text=html)
    urls = t_daac.download_nsidc_https(d, **kw)
    assert urls == j_daac.download_nsidc_https(d, **kw)
    assert len(urls) == 2
    assert urls[0].startswith(
        'https://n5eil01u.ecs.nsidc.org/MOST/MOD29.061/2019.08.25/')

    html_oco = '''<a href="oco2_L2StdND_26301a_190806_B10004r.h5">x</a>
    <a href="oco2_L2StdND_26301a_190806_B10004r.h5.xml">m</a>'''
    dt = datetime.datetime(2019, 8, 6, 4, 0)
    u = t_daac.download_oco2_https(dt, 'OCO2_L2_Standard.11r', run=False,
                                   data_format='h5', html_text=html_oco)
    assert u == j_daac.download_oco2_https(
        dt, 'OCO2_L2_Standard.11r', run=False, data_format='h5',
        html_text=html_oco)
    assert u == ['https://oco2.gesdisc.eosdis.nasa.gov/data/OCO2_DATA/'
                 'OCO2_L2_Standard.11r/2019/218/'
                 'oco2_L2StdND_26301a_190806_B10004r.h5']
    u2 = t_daac.download_oco2_https(dt, 'OCO2_L2_Lite_FP.11.1r', run=False,
                                    html_text=html_oco)
    assert '/OCO2_L2_Lite_FP.11.1r/2019/oco2' in u2[0]
    with pytest.raises(ValueError, match='unsupported'):
        t_daac.download_oco2_https(dt, 'OCO2_Bogus.1r', run=False,
                                   html_text=html_oco)


# ---------------- ncio and geo (as tests/test_sat.py has them) ----------------

def test_ncio_scaling(tmp_path):
    fname = os.path.join(tmp_path, 'scaled.h5')
    with h5py.File(fname, 'w') as f:
        d = f.create_dataset('v', data=np.array([100, 200, -999], np.int16))
        d.attrs['scale_factor'] = 0.1
        d.attrs['_FillValue'] = np.int16(-999)
    v = t_ncio.read_var(fname, 'v')
    assert_same(j_ncio.read_var(fname, 'v'), v)
    assert v[0] == pytest.approx(10.0)
    assert np.isnan(v[2])


def test_ncio_cf_packing_convention(tmp_path):
    fn = os.path.join(tmp_path, 'cf.nc')
    with h5py.File(fn, 'w') as f:
        d = f.create_dataset('ctt', data=np.array([12000], np.int16))
        d.attrs['scale_factor'] = 0.01
        d.attrs['add_offset'] = 150.0
    f = t_ncio.open_any(fn)
    try:
        raw, attrs = f.var('ctt')
        val = t_ncio.apply_scaling(raw, attrs)
    finally:
        f.close()
    assert_same(j_ncio.read_var(fn, 'ctt'), val)
    assert val[0] == pytest.approx(270.0)
    assert t_ncio.apply_scaling(np.array([1000.0]),
                                {'scale_factor': 0.01, 'add_offset': 100.0}
                                )[0] == pytest.approx(9.0)


def test_geodesic_vincenty():
    d = t_geo.cal_geodesic_dist([144.424868], [-37.951033],
                                [143.926496], [-37.652821])
    assert d[0] == pytest.approx(54972.2, abs=1.0)
    assert t_geo.cal_geodesic_dist([0], [0], [0], [1])[0] == \
        pytest.approx(110574.39, abs=0.1)
    lon1, lat1 = t_geo.cal_geodesic_lonlat([12.3], [45.6], [250000], [37.0])
    back = t_geo.cal_geodesic_dist([12.3], [45.6], lon1, lat1)
    assert back[0] == pytest.approx(250000.0, abs=0.01)

"""The port's file-backed loaders against the reference's, bit for bit.

``er3t_tpu_torch.common``, ``util.ncio``, ``util.logger``, ``pre.pmom``,
``pre.abs_16g_db``, ``pre.abs`` (``abs_16g``, ``abs_rep``),
``pre.abs_rep_db``, ``pre.abs_gen``, ``pre.abs_oco``, ``pre.abs_rrtmg``,
``pre.cld.cld_les`` and ``pre.aer.aer_les``/``aer_lasso`` repeat the
reference's arithmetic operation for operation, so each result must equal
the reference's (``assert_same`` of ``tests/test_torch_pre.py``: same dtype,
``np.array_equal``) on files the tests write themselves: the mini 16-g
databases of ``tests/test_abs_db.py`` in HDF5 and text layouts, a
generated database (``tests/test_abs_gen.py``), the RRTMG file of
``tests/test_abs_rrtmg.py``, the OCO inputs of ``tests/test_abs_oco.py``, a
REPTRAN main file with its lookups, a libRadtran moment table, and a small
LES snapshot in classic netCDF (SciPy's reader) and in HDF5 (h5py's).  The
reference's solver closures of those files run on the port's
``solve``/``run_transport`` at ``device='cpu'``.
"""

import logging
import os

import h5py
import numpy as np
import pytest
import torch
from scipy.io import netcdf_file

import chip_smoke_files
from er3t_tpu import common as j_common
from er3t_tpu.pre import abs as j_abs
from er3t_tpu.pre import abs_16g_db as j_db
from er3t_tpu.pre import abs_gen as j_gen
from er3t_tpu.pre import abs_oco as j_oco
from er3t_tpu.pre import abs_rep_db as j_rep
from er3t_tpu.pre import abs_rrtmg as j_rrtmg
from er3t_tpu.pre import aer as j_aer
from er3t_tpu.pre import atm as j_atm
from er3t_tpu.pre import cld as j_cld
from er3t_tpu.pre import pmom as j_pmom
from er3t_tpu.util import logger as j_logger
from er3t_tpu.util import ncio as j_ncio
from er3t_tpu_torch import common as t_common
from er3t_tpu_torch.pre import abs as t_abs
from er3t_tpu_torch.pre import abs_16g_db as t_db
from er3t_tpu_torch.pre import abs_gen as t_gen
from er3t_tpu_torch.pre import abs_oco as t_oco
from er3t_tpu_torch.pre import abs_rep_db as t_rep
from er3t_tpu_torch.pre import abs_rrtmg as t_rrtmg
from er3t_tpu_torch.pre import aer as t_aer
from er3t_tpu_torch.pre import atm as t_atm
from er3t_tpu_torch.pre import cld as t_cld
from er3t_tpu_torch.pre import pmom as t_pmom
from er3t_tpu_torch.util import logger as t_logger
from er3t_tpu_torch.util import ncio as t_ncio
from test_abs_db import _make_mini_db, _make_mini_txt_db
from test_abs_rrtmg import K_LOW, K_UPP, NG, _make_rrtmg_nc
from test_torch_pre import assert_same

torch.set_num_threads(2)

LEVELS_1KM = np.linspace(0, 20, 21)
LES_SHAPE = (12, 10, 16)           # x, y, levels of the small snapshot


def _pair(fn_name, j_mod, t_mod, *a, **kw):
    """(reference result, port result) of one function on one input."""
    return getattr(j_mod, fn_name)(*a, **kw), getattr(t_mod, fn_name)(*a, **kw)


@pytest.fixture(scope='module')
def atms():
    return j_atm.atm_atmmod(LEVELS_1KM), t_atm.atm_atmmod(LEVELS_1KM)


@pytest.fixture(scope='module')
def files(tmp_path_factory):
    """Every file of the module, written once: the mini 16-g databases,
    the RRTMG file, the REPTRAN files, a moment table and the LES
    snapshot in both layouts."""
    d = tmp_path_factory.mktemp('absdb')
    out = {'h5': str(d / 'abs_16g.h5'), 'txt': str(d / 'txtdb'),
           'rrtmg': str(d / 'rrtmg_sw.nc'), 'les_nc': str(d / 'les.nc'),
           'les_h5': str(d / 'les.h5'), 'pmom': str(d / 'wc.sol.mie.cdf'),
           'rep': str(d / 'reptran_solar_coarse.cdf')}
    _make_mini_db(out['h5'])
    _make_mini_txt_db(out['txt'])
    _make_rrtmg_nc(out['rrtmg'])
    _make_reptran(out['rep'])
    _make_pmom_cdf(out['pmom'])
    chip_smoke_files.write_les_snapshot(out['les_nc'], seed=3,
                                        shape=LES_SHAPE, dz_m=200.0,
                                        base_km=0.5, top_km=2.5)
    with netcdf_file(out['les_nc'], 'r', mmap=False) as src, \
            h5py.File(out['les_h5'], 'w') as dst:
        for name, v in src.variables.items():
            dst[name] = np.array(v[:])
    return out


def _make_reptran(fname):
    """A REPTRAN main file with two bands over six representative
    wavelengths and two species, and its O2 and H2O lookup files (the H2O
    one with a vmr axis), in classic netCDF."""
    rng = np.random.default_rng(11)
    wvl = np.array([645.0, 650.0, 655.0, 760.0, 765.0, 770.0])
    with netcdf_file(fname, 'w') as f:
        for name, n in (('nband', 2), ('nchar', 8), ('nwvl', 6),
                        ('niwvl', 3), ('nspecies', 2)):
            f.createDimension(name, n)
        names = np.array([list(s.ljust(8)) for s in ('band_a', 'band_b')],
                         dtype='S1')
        f.createVariable('band_name', 'c', ('nband', 'nchar'))[:] = names
        f.createVariable('wvlmin', 'd', ('nband',))[:] = [640.0, 750.0]
        f.createVariable('wvlmax', 'd', ('nband',))[:] = [660.0, 780.0]
        f.createVariable('iwvl', 'i', ('niwvl', 'nband'))[:] = \
            [[1, 4], [2, 5], [3, 6]]
        f.createVariable('iwvl_weight', 'd', ('niwvl', 'nband'))[:] = \
            [[0.25, 0.6], [0.5, 0.4], [0.25, 0.0]]
        f.createVariable('wvl', 'd', ('nwvl',))[:] = wvl
        f.createVariable('extra', 'd', ('nwvl',))[:] = \
            rng.uniform(1200.0, 1600.0, 6)
        f.createVariable('cross_section_source', 'i',
                         ('nwvl', 'nspecies'))[:] = [[0, 1]] * 3 + [[1, 1]] * 3
        sp = np.array([list(s.ljust(8)) for s in ('O2', 'H2O')], dtype='S1')
        f.createVariable('species_name', 'c', ('nspecies', 'nchar'))[:] = sp
    stem = fname.rsplit('.', 1)[0]
    p = np.array([105000.0, 70000.0, 30000.0, 5000.0, 100.0])   # Pa, down
    for gas, shape in (('O2', (3, 6, 5)), ('H2O', (3, 4, 6, 5))):
        with netcdf_file(f'{stem}.lookup.{gas}.cdf', 'w') as f:
            dims = (('nt', 3), ('nvmr', 4), ('nwvl', 6), ('np', 5))
            for name, n in dims:
                f.createDimension(name, n)
            xdims = ('nt', 'nwvl', 'np') if gas == 'O2' \
                else ('nt', 'nvmr', 'nwvl', 'np')
            f.createVariable('xsec', 'd', xdims)[:] = \
                rng.uniform(1e-6, 1e-3, shape)
            f.createVariable('t_ref', 'd', ('np',))[:] = \
                [288.0, 270.0, 230.0, 215.0, 250.0]
            f.createVariable('t_pert', 'd', ('nt',))[:] = [-20.0, 0.0, 20.0]
            f.createVariable('wvl', 'd', ('nwvl',))[:] = wvl
            f.createVariable('pressure', 'd', ('np',))[:] = p
            if gas == 'H2O':
                f.createVariable('vmrs', 'd', ('nvmr',))[:] = \
                    [1e-6, 1e-4, 1e-3, 3e-2]


def _make_pmom_cdf(fname):
    """A libRadtran moment table: (wvl, reff, 1, mom) pmom in classic
    netCDF, wavelengths in um."""
    rng = np.random.default_rng(5)
    with netcdf_file(fname, 'w') as f:
        for name, n in (('nlam', 2), ('nreff', 3), ('nphamat', 1),
                        ('nmom', 40)):
            f.createDimension(name, n)
        f.createVariable('wavelen', 'd', ('nlam',))[:] = [0.6, 0.65]
        f.createVariable('reff', 'd', ('nreff',))[:] = [5.0, 10.0, 20.0]
        f.createVariable('ssa', 'd', ('nlam', 'nreff'))[:] = \
            rng.uniform(0.99, 1.0, (2, 3))
        g = np.array([0.82, 0.85, 0.87])
        mom = 2.0 * g[None, :, None, None] ** np.arange(40)
        f.createVariable('pmom', 'd', ('nlam', 'nreff', 'nphamat',
                                       'nmom'))[:] = np.broadcast_to(
            mom, (2, 3, 1, 40))


# ---- 1-3: common, ncio, logger ----

def test_common_copies_the_reference_settings():
    for name in ('f_dtype', 'i_dtype', 'params', 'references',
                 'has_abs_16g', 'has_mie_cdf', 'fdir_data_tmp'):
        assert_same(getattr(j_common, name), getattr(t_common, name), name)
    assert t_common.fdir_data == os.path.join(
        os.path.dirname(os.path.abspath(t_common.__file__)), 'data')
    for name in ('fname_abs_16g_h5', 'fname_mie_cdf'):
        if os.environ.get({'fname_abs_16g_h5': 'ER3T_ABS_16G_H5',
                           'fname_mie_cdf': 'ER3T_MIE_CDF'}[name]) is None:
            assert os.path.dirname(getattr(t_common, name)) == \
                t_common.fdir_data
        assert os.path.basename(getattr(t_common, name)) == \
            os.path.basename(getattr(j_common, name))


@pytest.mark.parametrize('attrs', [
    {'scale_factor': 0.1, '_FillValue': np.int16(-999)},
    {'scale_factor': 0.01, 'add_offset': 150.0, '__convention__': 'cf'},
    {'scale_factor': 0.01, 'add_offset': 100.0},
    {'valid_range': np.array([0, 150]), 'missing_value': 200},
    {}], ids=['fill', 'cf', 'hdf4', 'valid_range', 'plain'])
def test_ncio_apply_scaling(attrs):
    raw = np.array([100, 200, -999, 12000, 0], np.int16)
    assert_same(*_pair('apply_scaling', j_ncio, t_ncio, raw, dict(attrs)))


@pytest.mark.parametrize('layout', ['les_nc', 'les_h5'])
def test_ncio_reads_both_layouts(files, layout):
    """The classic netCDF file opens through SciPy, the HDF5 one through
    h5py: the same format tag, variables and attributes as the
    reference's reader."""
    fname = files[layout]
    assert_same(*_pair('sniff_format', j_ncio, t_ncio, fname))
    for name in ('x', 'QC', 'TABS'):
        assert_same(*_pair('read_var', j_ncio, t_ncio, fname, name))
        assert_same(*_pair('read_var', j_ncio, t_ncio, fname, name,
                           scaled=False))
    jf, tf = j_ncio.open_any(fname), t_ncio.open_any(fname)
    try:
        assert type(tf).__name__ == type(jf).__name__ == (
            '_NC3Adapter' if layout == 'les_nc' else '_H5Adapter')
        assert_same(jf.var('p'), tf.var('p'))
    finally:
        jf.close()
        tf.close()
    with pytest.raises(FileNotFoundError):
        t_ncio.open_any(fname + '.missing')


def test_logger_copy():
    assert t_logger.FRAMEWORK == j_logger.FRAMEWORK == 25
    assert logging.getLevelName(25) == 'FRAMEWORK'
    lg = t_logger.Er3tLogger('er3t_tpu_torch.test', verbose=False)
    lg.tic('t')
    lg.framework('hello %d', 3)
    assert lg.toc('t', n_items=10, unit='photons') >= 0.0
    assert isinstance(t_logger.get_logger(), t_logger.Er3tLogger)
    assert t_logger.get_logger() is t_logger.get_logger()


# ---- 4: pmom ----

def test_pmom_functions():
    from er3t_tpu.physics.hg import hg_phase
    ang = np.linspace(0.0, 180.0, 721)
    p = hg_phase(0.7, np.cos(np.deg2rad(ang)))
    mom = _pair('phase2mom', j_pmom, t_pmom, ang, p, 48)
    assert_same(*mom)
    w = mom[0] * (2.0 * np.arange(48) + 1.0)
    mu = np.linspace(-1.0, 1.0, 33)
    assert_same(*_pair('mom2phase', j_pmom, t_pmom, w, mu))
    assert_same(*_pair('mom2phaseint', j_pmom, t_pmom, w, mu))
    for kw in (dict(), dict(deltascaling=False, normalize=True),
               dict(angle=ang[::7], step=0.5)):
        assert_same(*_pair('legendre2phase', j_pmom, t_pmom, mom[0], **kw))


def test_pmom_tables(files):
    assert_same(*_pair('read_pmom', j_pmom, t_pmom, files['pmom']))
    assert_same(*_pair('pha_mie_wc_pmom', j_pmom, t_pmom, 650.0, n_mom=32,
                       fname_pmom=files['pmom']))
    assert_same(*_pair('pha_mie_wc_pmom', j_pmom, t_pmom, 650.0, n_mom=64,
                       reff_grid=np.array([5.0, 10.0])))


# ---- 5-6: the 16-g database and abs_16g ----

@pytest.mark.parametrize('wvl', [310.0, 470.0, 560.0, 630.0, 650.0, 720.0,
                                 765.0, 860.0, 1000.0, 1260.0, 1350.0,
                                 1600.0, 2300.0])
def test_abs_16g_regions(wvl):
    assert_same(*_pair('_regions', j_db, t_db, wvl))


def test_abs_16g_grid_and_factors(atms):
    assert_same(j_db.reference_atmosphere(), t_db.reference_atmosphere())
    fac = [m.interpolation_factors(a.lay.pressure, a.lay.temperature,
                                   a.lay.h2o / a.lay.factor)
           for m, a in ((j_db, atms[0]), (t_db, atms[1]))]
    assert_same(*fac)


def test_abs_16g_from_both_layouts(files, atms):
    ja, ta = atms
    h5 = (j_db.abs_16g_from_h5(650.0, ja, files['h5']),
          t_db.abs_16g_from_h5(650.0, ta, files['h5']))
    txt = (j_db.abs_16g_from_txt(650.0, ja, fdir_k=files['txt']),
           t_db.abs_16g_from_txt(650.0, ta, fdir_k=files['txt']))
    assert_same(*h5)
    assert_same(*txt)
    assert not h5[1].synthetic and not txt[1].synthetic
    with pytest.raises(FileNotFoundError, match='ER3T_ABS16G_TXT_DIR'):
        t_db.abs_16g_from_txt(650.0, ta, fdir_k=files['txt'] + '_nope')


def test_abs_16g_and_abs_rep_fall_back_as_the_reference(files, atms, tmp_path):
    ja, ta = atms
    got = (j_abs.abs_16g(650.0, ja, fname_h5=files['h5']),
           t_abs.abs_16g(650.0, ta, fname_h5=files['h5']))
    assert_same(*got)
    assert not got[1].synthetic
    missing = str(tmp_path / 'none.h5')
    got = (j_abs.abs_16g(650.0, ja, fname_h5=missing),
           t_abs.abs_16g(650.0, ta, fname_h5=missing))
    assert_same(*got)
    assert got[1].synthetic
    assert_same(j_abs.abs_rep(860.0, ja), t_abs.abs_rep(860.0, ta))
    with pytest.raises(FileNotFoundError, match='REPTRAN'):
        t_abs.abs_rep('band_a', ta)


def test_abs_rep_from_cdf(files, atms):
    ja, ta = atms
    for band in (650.0, 'band_b'):
        got = (j_abs.abs_rep(band, ja, fname_cdf=files['rep']),
               t_abs.abs_rep(band, ta, fname_cdf=files['rep']))
        assert_same(*got)
        assert not got[1].synthetic and got[1].abso_coef.max() > 0
    stem = files['rep'].rsplit('.', 1)[0]
    p_pa = ta.lay.pressure * 100.0
    for gas, h2o in (('O2', None), ('H2O', ta.lay.h2o / ta.lay.factor)):
        assert_same(*_pair('_interp_xsec', j_rep, t_rep,
                           f'{stem}.lookup.{gas}.cdf', 762.0, p_pa,
                           ta.lay.temperature, h2o_vmr=h2o))
    with pytest.raises(KeyError, match='unknown REPTRAN band'):
        t_rep.abs_rep_from_cdf('band_z', ta, files['rep'])


# ---- 8: the database generator ----

def test_abs_gen_cross_sections_and_solar(tmp_path):
    t = np.array([220.0, 250.0, 290.0])
    o3 = tmp_path / 'crs_o3.dat'
    np.savetxt(o3, np.array([[500.0, 1.0, 0.01, 1e-4],
                             [700.0, 3.0, 0.02, 0.0]]))
    tab = tmp_path / 'tab.dat'
    np.savetxt(tab, np.array([[400.0, 2e-19], [800.0, 1e-20]]))
    kur = tmp_path / 'kurudz.dat'
    np.savetxt(kur, np.stack([np.arange(300.0, 2501.0, 1.0),
                              np.linspace(1.0, 2.0, 2201) * 1000.0], axis=1))
    slit = {'wavelength': np.array([-1.0, 0.0, 1.0]),
            'weight': np.array([0.25, 0.5, 0.25])}
    for args, kw in (((602.0, t), {}), ((602.0, 250.0), {}),
                     ((600.0, t), dict(fname=str(o3)))):
        assert_same(*_pair('cal_xsec_o3_molina', j_gen, t_gen, *args, **kw))
    for name in ('cal_xsec_o4_greenblatt', 'cal_xsec_no2_burrows'):
        assert_same(*_pair(name, j_gen, t_gen, 577.0))
        assert_same(*_pair(name, j_gen, t_gen, 577.0, fname=str(tab)))
    for kw in ({}, dict(kurudz_file=str(kur)),
               dict(kurudz_file=str(kur), slit_func=slit)):
        assert_same(*_pair('cal_solar_kurudz', j_gen, t_gen, 650.0, **kw))
    for gas in ('o3', 'no2', 'h2o', 'o2', 'co2', 'ch4'):
        for ng in (16, 4):
            assert_same(*_pair('_sigma_g', j_gen, t_gen, gas, 760.0, 500.0,
                               240.0, ng))


def _h5_tree(fname):
    out = {}
    with h5py.File(fname, 'r') as f:
        f.visititems(lambda k, v: out.__setitem__(k, v[...])
                     if isinstance(v, h5py.Dataset) else None)
    return out


def test_gen_abs_16g_h5_same_database(tmp_path, atms):
    """Both generators write the same datasets at two wavelengths (one
    with the water-vapour axis), and both loaders read the same AbsCoef
    from the port's file, from the reference's, and from its text tree
    (chip_smoke_files.write_abs_16g_txt, the layout phase 10 reads on a
    card machine without h5py)."""
    wv = [650.0, 1280.0]
    jf, tf = str(tmp_path / 'j.h5'), str(tmp_path / 't.h5')
    assert j_gen.gen_abs_16g_h5(jf, wv, compression=None) == jf
    assert t_gen.gen_abs_16g_h5(tf, wv, compression=None) == tf
    assert_same(_h5_tree(jf), _h5_tree(tf))
    txt = chip_smoke_files.write_abs_16g_txt(str(tmp_path / 'txt'), wv,
                                             t_gen.gen_abs_16g_h5)
    ja, ta = atms
    for w in wv:
        ref = j_db.abs_16g_from_h5(w, ja, jf)
        assert_same(ref, t_db.abs_16g_from_h5(w, ta, tf))
        assert_same(ref, t_db.abs_16g_from_txt(w, ta, fdir_k=txt))
        assert_same(ref, j_db.abs_16g_from_txt(w, ja, fdir_k=txt))


# ---- 9: OCO ----

def _oco_db(nz_db):
    ng, nwl = 11, 5
    rng = np.random.default_rng(0)
    db = {'wvls': np.linspace(757.0, 773.0, nwl),
          'abso': rng.uniform(0.01, 1.0, (ng, nz_db, nwl)),
          'slit': np.abs(rng.normal(1.0, 0.1, (ng, nwl))),
          'solar': rng.uniform(1.0, 2.0, (nwl, ng))}
    db['weight'] = db['slit'] / db['slit'].sum(axis=0, keepdims=True)
    return db


def test_abs_oco_idl(monkeypatch, tmp_path, atms):
    """load_oco_idl on a stand-in for SciPy's readsav (the IDL save is
    read-only in SciPy), then abs_oco_idl on the reference test's mocked
    database, with and without the layer interpolation."""
    import scipy.io
    db = _oco_db(10)
    sav = type('Sav', (), dict(lamx=db['wvls'] / 1000.0, absgl=db['abso'],
                               absgy=db['slit'], solx=db['solar'].T))
    monkeypatch.setattr(scipy.io, 'readsav', lambda f: sav)
    assert_same(*_pair('load_oco_idl', j_oco, t_oco, 'o2a.out'))
    fake = tmp_path / 'o2a.out'
    fake.write_bytes(b'x')
    ja, ta = atms
    for nz_db in (10, 20):
        db = _oco_db(nz_db)
        monkeypatch.setattr(j_oco, 'load_oco_idl', lambda f: db)
        monkeypatch.setattr(t_oco, 'load_oco_idl', lambda f: db)
        assert_same(j_oco.abs_oco_idl(765.0, ja, str(fake)),
                    t_oco.abs_oco_idl(765.0, ta, str(fake)))
    with pytest.raises(ValueError):
        t_oco.abs_oco_idl(800.0, ta, str(fake))
    with pytest.raises(FileNotFoundError):
        t_oco.abs_oco_idl(765.0, ta, str(tmp_path / 'none.out'))


def test_abs_oco_h5(tmp_path, atms):
    rng = np.random.default_rng(1)
    fn = str(tmp_path / 'oco.h5')
    with h5py.File(fn, 'w') as f:
        f['lamx'] = np.array([0.758, 0.760, 0.762])
        f['absgn'] = np.array([5, 4, 5])
        f['absgx'] = np.tile(np.linspace(0.7599, 0.7601, 5), (3, 1))
        f['absgl'] = rng.uniform(0.1, 1.0, (10, 3, 5))
        f['absgy'] = rng.uniform(0.5, 1.5, (3, 5))
        f['solx'] = np.full((3, 5), 1.2)
    ja, ta = atms
    got = (j_oco.abs_oco_h5(760.05, ja, fn), t_oco.abs_oco_h5(760.05, ta, fn))
    assert_same(*got)
    assert got[1].ng == 4
    with pytest.raises(ValueError, match='nearest'):
        t_oco.abs_oco_h5(780.0, ta, fn)


# ---- 10: RRTMG ----

@pytest.mark.parametrize('iband', [0, 9])
def test_abs_rrtmg_sw(files, atms, iband):
    ja, ta = atms
    ref = j_rrtmg.abs_rrtmg_sw(iband=iband, atm_obj=ja, fname=files['rrtmg'])
    got = t_rrtmg.abs_rrtmg_sw(iband=iband, atm_obj=ta, fname=files['rrtmg'])
    for name in ('iband', 'wavelength', 'band_range', 'wvl', 'abso_coef',
                 'slit_func', 'solar', 'weight', 'coef', 'ng'):
        assert_same(getattr(ref, name), getattr(got, name), name)
    assert_same(j_rrtmg.RRTMG_SW_WEIGHTS, t_rrtmg.RRTMG_SW_WEIGHTS)
    assert_same(*_pair('_names', j_rrtmg, t_rrtmg,
                       np.array([list('h2o  '), list('co2  ')], dtype='S1')))
    assert_same(*_pair('_lin', j_rrtmg, t_rrtmg, [1.0, 2.0, 4.0], 3.0))
    with pytest.raises(ValueError, match='g_mode'):
        t_rrtmg.abs_rrtmg_sw(atm_obj=ta, fname=files['rrtmg'], g_mode=1)


def test_rrtmg_constant_tables_reproduce_columns(files, atms):
    """tests/test_abs_rrtmg.py's exact closure on the port's loader."""
    atm = atms[1]
    ab = t_rrtmg.abs_rrtmg_sw(iband=0, atm_obj=atm, fname=files['rrtmg'])
    dz_cm = atm.lay.thickness * 1e5
    col_low = (atm.lay.h2o + atm.lay.co2) * dz_cm
    expect = np.where(atm.lay.pressure >= 96.0, K_LOW * col_low,
                      K_UPP * atm.lay.o3 * dz_cm)
    np.testing.assert_allclose(ab.abso_coef[:, 0], expect, rtol=1e-6)
    assert ab.ng == NG


def test_rrtmg_drives_the_port(files, atms):
    """tests/test_abs_rrtmg.py:93-105 on the port: an ng = 4 RRTMG
    coefficient through build_scene and the marching engine, and through
    solve (flight engine, flux), on the CPU."""
    from er3t_tpu_torch.rtm.mc import SolverConfig, run_transport
    from er3t_tpu_torch.rtm.scene import build_scene
    from er3t_tpu_torch.rtm.solver import solve
    atm = atms[1]
    ab = t_rrtmg.abs_rrtmg_sw(iband=0, atm_obj=atm, fname=files['rrtmg'])
    scene, st = build_scene(atm, ab, surface=0.2, solar_zenith_angle=30.0,
                            device='cpu')
    assert st.ng == NG == 4
    t = run_transport(scene, st, SolverConfig(target='flux', batch=1 << 12),
                      20000, seed=3, device='cpu')
    f_dn = t.flux.numpy()[0, 0, 0, 0] @ ab.weight / int(t.n_launched)
    assert 0.0 < f_dn <= 1.0
    res = solve(atm=atm, abs_coef=ab, surface=0.2, target='flux',
                solar_zenith_angle=30.0, photons=2e4, n_run=1, batch=1 << 12,
                seed=4, device='cpu')
    mu0 = np.cos(np.deg2rad(30.0))
    toa = float(np.sum(ab.solar * ab.weight))
    assert float(res['f_down_direct'][0, 0, -1]) == pytest.approx(
        toa * mu0, rel=1e-5)
    assert 0.0 < float(res['f_down'][0, 0, 0]) < toa * mu0


# ---- 11: LES cloud and aerosol ----

@pytest.mark.parametrize('layout', ['les_nc', 'les_h5'])
@pytest.mark.parametrize('coarsen', [(1, 1, 1), (2, 2, 4), (1, 1, 3)],
                         ids=['whole', 'coarsened', 'by_three'])
def test_cld_les_and_aer_les(files, layout, coarsen):
    fname = files[layout]
    got = _pair('cld_les', j_cld, t_cld, fname, coarsen=coarsen,
                q_factor=2.1)
    assert_same(*got)
    assert got[1].nz >= 2 and got[1].extinction.max() > 0
    kw = dict(ssa=0.85, asy=0.65, coarsen=coarsen, ext_scale=0.1)
    assert_same(*_pair('aer_les', j_aer, t_aer, fname, **kw))
    assert_same(*_pair('aer_lasso', j_aer, t_aer, fname, **kw))


def test_cld_les_refuses_a_grid_it_cannot_coarsen(files):
    with pytest.raises(ValueError, match='not coarsenable'):
        t_cld.cld_les(files['les_nc'], coarsen=(1, 1, 9))


def test_les_scene_through_the_port(files):
    """tests/test_aer.py:99-113 on the port: cld_les + aer_les through
    solve at batch 2^12, 2e4 photons, on the CPU."""
    from er3t_tpu_torch.rtm.solver import solve
    atm = t_atm.atm_atmmod(np.concatenate([np.arange(0, 3.0, 0.4),
                                           np.arange(3.0, 20.1, 1.0)]))
    ab = t_abs.abs_synthetic(650.0, atm, ng=4)
    cld = t_cld.cld_les(files['les_nc'], coarsen=(1, 1, 2))
    aer = t_aer.aer_les(files['les_nc'], ssa=0.7, asy=0.6, coarsen=(1, 1, 2),
                        ext_scale=0.3)
    res = solve(atm=atm, abs_coef=ab, cld=cld, aer_3ds=[aer], surface=0.1,
                target='radiance', photons=20000, n_run=1, batch=1 << 12,
                seed=6, device='cpu')
    assert res['rad'].shape == (cld.nx, cld.ny)
    assert np.all(np.isfinite(res['rad'])) and res['rad'].mean() > 0


def test_db_solver_flux_matches_synthetic(files, atms, tmp_path):
    """tests/test_abs_gen.py's solver closure on the port: a generated
    database and abs_synthetic drive the same domain-average flux within
    MC noise (flight engine, 4e4 photons at batch 2^11, on the CPU)."""
    from er3t_tpu_torch.rtm.mc import SolverConfig
    from er3t_tpu_torch.rtm.mc_flight import run_transport_flight
    from er3t_tpu_torch.rtm.scene import build_scene
    db = t_gen.gen_abs_16g_h5(str(tmp_path / 'g.h5'), [650.0],
                              compression=None)
    atm = atms[1]
    outs = {}
    for tag, ab in (('syn', t_abs.abs_synthetic(650.0, atm)),
                    ('db', t_db.abs_16g_from_h5(650.0, atm, db))):
        scn, st = build_scene(atm, ab, surface=0.2, solar_zenith_angle=30.0,
                              device='cpu')
        cfg = SolverConfig(target='flux', batch=1 << 11, n_scat_max=200)
        t = run_transport_flight(scn, st, cfg, 40000, seed=8, device='cpu')
        outs[tag] = t.flux.numpy()[0, 0] @ ab.weight / int(t.n_launched)
    assert outs['syn'][-1, 0] == pytest.approx(1.0, rel=1e-5)
    assert outs['db'][-1, 0] == pytest.approx(1.0, rel=1e-5)
    s_dn = outs['syn'][0, 0] + outs['syn'][0, 1]
    d_dn = outs['db'][0, 0] + outs['db'][0, 1]
    assert d_dn == pytest.approx(s_dn, rel=0.03)
    assert outs['db'][-1, 2] == pytest.approx(outs['syn'][-1, 2], rel=0.05)


def test_loaders_keep_h5py_and_netcdf4_out_of_module_import(files):
    """No module of the port imports h5py or netCDF4 at its top, and a
    classic netCDF LES file loads with neither importable."""
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ('import sys\n'
            "sys.modules['h5py'] = None\n"
            "sys.modules['netCDF4'] = None\n"
            'import er3t_tpu_torch.pre.abs_16g_db, er3t_tpu_torch.pre.abs_gen\n'
            'import er3t_tpu_torch.pre.abs_oco, er3t_tpu_torch.pre.abs_rrtmg\n'
            'import er3t_tpu_torch.pre.abs_rep_db, er3t_tpu_torch.pre.pmom\n'
            'import er3t_tpu_torch.apps, er3t_tpu_torch.apps.spectral\n'
            'from er3t_tpu_torch.pre.cld import cld_les\n'
            f"print(cld_les({files['les_nc']!r}).nz)\n")
    proc = subprocess.run([sys.executable, '-c', code], cwd=repo,
                          env=dict(os.environ, PYTHONPATH=repo),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout) >= 2

"""The port's applications (``er3t_tpu_torch.apps``) and their NumPy
physics against the reference's.

``apps.cldpos``, ``physics.twostream``, ``physics.cloud_optics`` and the
host solvers of ``apps.spectral`` (``spec_flx``, ``spec_rad``,
``slit_convolve``, ``triangular_slit``) are NumPy copies: equal bit for bit
(``assert_same`` of ``tests/test_torch_pre.py``) on the inputs of
``tests/test_cldpos.py``, ``tests/test_spectral.py`` and
``tests/test_physics.py``.  The Monte Carlo wrappers of ``apps.lut`` and
``apps.spectral`` are held bit for bit on their own arithmetic (the grid
cloud, the reflectance, the inversion, the two-stream companion, the
spectral stacking) with both packages' ``solve`` replaced by the same
made-up results; their calls of ``solve`` must carry the same inputs, and
the port's ``device``.  The reference's statistical tests of
``tests/test_apps.py`` and ``test_spec_flx_matches_mc`` run on the port at
``device='cpu'``, ``slow`` as there, and one small reflectance curve stays
in the fast set.
"""

import inspect

import numpy as np
import pytest
import torch

from er3t_tpu.apps import cldpos as j_cldpos
from er3t_tpu.apps import lut as j_lut
from er3t_tpu.apps import spectral as j_spec
from er3t_tpu.physics import cloud_optics as j_co
from er3t_tpu.physics import twostream as j_ts
from er3t_tpu.pre.atm import atm_atmmod as j_atmmod
from er3t_tpu_torch.apps import cldpos as t_cldpos
from er3t_tpu_torch.apps import lut as t_lut
from er3t_tpu_torch.apps import spectral as t_spec
from er3t_tpu_torch.physics import cloud_optics as t_co
from er3t_tpu_torch.physics import twostream as t_ts
from er3t_tpu_torch.pre.abs import abs_synthetic
from er3t_tpu_torch.pre.atm import atm_atmmod
from test_torch_pre import assert_same

torch.set_num_threads(2)

CLD_CFG = dict(cloud_base=1.0, cloud_top=2.0, cloud_optical_thickness=10.0,
               cloud_effective_radius=10.0)
AER_CFG = dict(aerosol_optical_depth=0.5, single_scattering_albedo=0.9,
               asymmetry_parameter=0.7)


@pytest.fixture(scope='module')
def atms():
    lev = np.linspace(0, 20, 21)
    return j_atmmod(lev), atm_atmmod(lev)


def _pair(fn_name, j_mod, t_mod, *a, **kw):
    return getattr(j_mod, fn_name)(*a, **kw), getattr(t_mod, fn_name)(*a, **kw)


def _blob(nx, i0, j0, r, value):
    f = np.zeros((nx, nx))
    ii, jj = np.meshgrid(np.arange(nx), np.arange(nx), indexing='ij')
    f[(ii - i0) ** 2 + (jj - j0) ** 2 <= r * r] = value
    return f


# ---- NumPy copies, bit for bit ----

def test_cldpos_bit_for_bit():
    """The inputs of tests/test_cldpos.py."""
    a = _blob(48, 20, 24, 5, 1.0) > 0
    b = np.roll(np.roll(a, -3, axis=0), 5, axis=1)
    assert_same(*_pair('move_correlate', j_cldpos, t_cldpos, a, b))
    assert_same(*_pair('move_correlate', j_cldpos, t_cldpos, a,
                       np.zeros_like(a)))
    for args in ((4.0, 0.0, 45.0, 90.0, 0.5, 0.5),
                 (np.array([[0.0, 3.0], [1.5, 4.0]]), 0.2, 30.0, 37.0, 0.25,
                  0.3)):
        assert_same(*_pair('parallax_shift', j_cldpos, t_cldpos, *args))
    assert_same(*_pair('wind_shift', j_cldpos, t_cldpos, 10.0, -5.0, 600.0,
                       0.5, 0.5))
    nx, dx = 64, 0.25
    true = _blob(nx, 30, 30, 6, 18.0)
    cth = np.where(true > 0, 3.0, 0.0)
    dip, djp = j_cldpos.parallax_shift(cth, 0.0, 45.0, 90.0, dx, dx)
    diw, djw = j_cldpos.wind_shift(-5.0 / 3, 0.0, 600.0, dx, dx)
    app = _pair('shift_fields', j_cldpos, t_cldpos, [true, cth],
                -(dip + diw), -(djp + djw))
    assert_same(*app)
    (cot_app, cth_app), _ = app[0]
    cer_app = np.where(cot_app > 0, 12.0, 0.0)
    kw = dict(sfh_km=0.0, vza_deg=45.0, vaa_deg=90.0, u10=-5.0 / 3, v10=0.0,
              dt_s=600.0, dx_km=dx, dy_km=dx)
    for extra in (dict(mode='3d'), dict(mode='ipa'),
                  dict(mode='3d', align_mask=true > 0, align_max_offset=4)):
        assert_same(*_pair('correct_cloud_map', j_cldpos, t_cldpos, cot_app,
                           cer_app, cth_app, **kw, **extra))


def test_twostream_and_cloud_optics_bit_for_bit():
    """The inputs of tests/test_physics.py:88-103 and
    tests/test_spectral.py's cloud optics, and a wider sweep."""
    tau = np.array([0.0, 0.3, 10.0, 80.0])
    for fn in ('r_twostream', 't_twostream'):
        assert_same(*_pair(fn, j_ts, t_ts, tau, a=0.2, g=0.85, mu=0.8))
        assert_same(*_pair(fn, j_ts, t_ts, 10.0, g=0.85, mu=1.0))
    for args in ((np.array([0.1, 0.5, 5.0]), np.ones(3) * (1 - 1e-9),
                  np.array([0.0, 0.5, 0.85]), 0.7, 0.2),
                 (np.array([2.0, 0.05, 30.0, 0.4]),
                  np.array([0.5, 0.99, 1.0, 0.9]),
                  np.array([0.7, 0.0, 0.86, 0.3]), 0.3, 0.0)):
        assert_same(*_pair('delta_eddington_flux', j_ts, t_ts, *args))
        assert_same(*_pair('_layer_de', j_ts, t_ts, args[0], args[1],
                           args[2], args[3]))
    for wvl, reff in ((550.0, 10.0), (1650.0, 5.0), (2130.0, 20.0),
                      (300.0, 3.0), (940.0, 14.0), (2600.0, 30.0)):
        assert_same(*_pair('water_cloud_optics', j_co, t_co, wvl, reff))


def test_slits_bit_for_bit():
    wvl = np.arange(400.0, 500.1, 1.0)
    spec = np.where(wvl == 450.0, 1.0, 0.0)
    off = _pair('triangular_slit', j_spec, t_spec, 8.0)
    assert_same(*off)
    assert_same(*_pair('slit_convolve', j_spec, t_spec, wvl, spec, *off[0],
                       wvl))
    two = np.stack([spec, spec[::-1]], axis=1)
    assert_same(*_pair('slit_convolve', j_spec, t_spec, wvl, two, *off[0],
                       [420.5, 450.0]))
    mixed = np.array([600.0, 800.0, 1000.0, 1200.0])
    for slit in ('auto', 'vis', 'nir', None,
                 (np.array([-2.0, 0.0, 2.0]), np.array([1.0, 2.0, 1.0]))):
        assert_same(*_pair('_apply_slit', j_spec, t_spec, mixed,
                           np.array([1.0, 2.0, 4.0, 3.0]), slit))


def test_spec_flx_and_spec_rad_bit_for_bit(atms):
    """spec_flx and spec_rad on tests/test_spectral.py's cases: clear sky
    with several wavelengths (the default 16-g gases: synthetic in both
    packages, there being no database), then, on 4-g gases, a cloud with
    a tabulated albedo, an aerosol, and a cloudy radiance."""
    ja, ta = atms
    alb_tab = np.array([[350.0, 0.1], [950.0, 0.5]])
    g4 = dict(abs_fn=lambda w, a: abs_synthetic(w, a, ng=4))
    for kw in (dict(wavelengths=[450.0, 1000.0], solar_zenith_angle=30.0,
                    surface_albedo=0.2, n_streams=6),
               dict(wavelengths=[650.0], solar_zenith_angle=30.0,
                    surface_albedo=alb_tab, slit=None, n_streams=6,
                    cld_cfg=CLD_CFG, **g4),
               dict(wavelengths=[550.0], solar_zenith_angle=30.0, slit=None,
                    n_streams=6, aer_cfg=AER_CFG,
                    surface_albedo=lambda w: 0.1 + 1e-4 * w, **g4)):
        assert_same(j_spec.spec_flx(ja, **kw), t_spec.spec_flx(ta, **kw))
    kw = dict(wavelengths=[860.0], solar_zenith_angle=30.0,
              sensor_zenith_angle=20.0, relative_azimuth=30.0,
              surface_albedo=0.03, slit=None, n_streams=8, **g4)
    assert_same(j_spec.spec_rad(ja, cld_cfg=CLD_CFG, **kw),
                t_spec.spec_rad(ta, cld_cfg=CLD_CFG, **kw))


# ---- the Monte Carlo wrappers on made-up results ----

class _Made:
    """A Result of the fields the apps read: data by key, std, toa."""

    def __init__(self, data, toa, std):
        self.data, self.toa, self.std = data, toa, std

    def __getitem__(self, k):
        return self.data[k]


def _made_up(kw):
    """A result computed from solve's inputs alone, the same for both
    packages: radiance from the cloud's column optical depth and radius,
    fluxes from the gas optical depth."""
    ab = kw['abs_coef']
    toa = float(np.sum(ab.solar * ab.weight))
    if kw['target'] == 'radiance':
        cld = kw['cld']
        cot = cld.extinction.sum(axis=-1) * 1000.0
        rad = toa * (0.02 + cot / (cot + 8.0) + 1e-3 * cld.cer[..., 0]
                     + 1e-4 * kw['seed'] + 1e-5 * kw['solar_zenith_angle'])
        return _Made({'rad': rad}, toa, {'rad_std': 0.01 * rad})
    tau = ab.abso_coef.sum(axis=0) @ ab.weight
    lev = np.linspace(1.0, 0.5, 4)[None, None, :] * np.exp(-tau)
    data = {'f_down': toa * lev, 'f_up': 0.2 * toa * lev[..., ::-1],
            'f_down_direct': 0.8 * toa * lev,
            'f_down_diffuse': 0.2 * toa * lev}
    return _Made(data, toa, {})


class _Mie:
    """A stand-in for pha_mie_wc's object, shared by both packages: the
    wrappers read its radius grid and asymmetry parameters only."""

    def __init__(self, wavelength=650.0):
        ref = np.arange(1.0, 25.1, 1.5)
        self.data = {'id': 'Mie', 'wvl': float(wavelength), 'ref': ref,
                     'asy': 0.8 + 0.003 * ref + 1e-5 * wavelength,
                     'ssa': np.ones_like(ref)}


@pytest.fixture
def made_up(monkeypatch):
    """Both packages' solve replaced by _made_up, and their Mie tables by
    _Mie; returns the lists of each package's calls (keywords)."""
    from er3t_tpu.pre import pha as j_pha
    from er3t_tpu_torch.pre import pha as t_pha
    monkeypatch.setattr(j_pha, 'pha_mie_wc', _Mie)
    monkeypatch.setattr(t_pha, 'pha_mie_wc', _Mie)
    calls = {'ref': [], 'port': []}

    def fake(tag):
        def solve(**kw):
            calls[tag].append(kw)
            return _made_up(kw)
        return solve
    monkeypatch.setattr(j_lut.solver, 'solve', fake('ref'))
    monkeypatch.setattr(t_lut.solver, 'solve', fake('port'))
    return calls


def _same_calls(calls, atms, devices):
    """Each package's calls of solve carried the same keywords, the
    port's also ``device`` (one entry of ``devices`` a call); the lists
    are emptied for the next wrapper."""
    assert len(calls['port']) == len(calls['ref']) == len(devices)
    for jk, tk, device in zip(calls['ref'], calls['port'], devices):
        assert tk.pop('device') == device
        assert jk.pop('atm') is atms[0] and tk.pop('atm') is atms[1]
        assert_same(jk, tk, 'solve keywords')
    calls['ref'].clear()
    calls['port'].clear()


def test_lut_wrappers_on_made_up_results(made_up, atms):
    """gen_bispectral_lookup_table at its default grids, retrieve_cot_cer,
    func_ref_vs_cot with its inverter, and func_ref_vs_cot_multi_pixel with
    both inversion modes: the same tables, curves and calls of solve."""
    ja, ta = atms
    lut = (j_lut.gen_bispectral_lookup_table(ja, seed=3),
           t_lut.gen_bispectral_lookup_table(ta, seed=3, device='cpu'))
    assert_same(*lut)
    assert lut[1]['ref_vis'].shape == (25, 11)
    _same_calls(made_up, atms, ['cpu'] * 2)
    picks = ([2, 9, 17], [1, 4, 8])
    got = [m.retrieve_cot_cer(t, t['ref_vis'][picks], t['ref_nir'][picks])
           for m, t in ((j_lut, lut[0]), (t_lut, lut[1]))]
    assert_same(*got)
    assert_same(got[1], (lut[1]['cot'][picks[0]], lut[1]['cer'][picks[1]]))

    curves = (j_lut.func_ref_vs_cot(ja, cot_grid=[0.0, 1.0, 5.0, 20.0, 80.0],
                                    seed=2),
              t_lut.func_ref_vs_cot(ta, cot_grid=[0.0, 1.0, 5.0, 20.0, 80.0],
                                    seed=2, device='cuda'))
    for name in ('cot', 'ref', 'ref_2s', 'toa'):
        assert_same(getattr(curves[0], name), getattr(curves[1], name), name)
    assert_same(curves[0].get_cot_from_ref([0.3, 0.5]),
                curves[1].get_cot_from_ref([0.3, 0.5]))
    _same_calls(made_up, atms, ['cuda'])

    multi = (j_lut.func_ref_vs_cot_multi_pixel([0.0, 2.0, 8.0, 30.0], atm=ja,
                                               n_run=2, seed=5),
             t_lut.func_ref_vs_cot_multi_pixel([0.0, 2.0, 8.0, 30.0], atm=ta,
                                               n_run=2, seed=5,
                                               device='cpu'))
    for name in ('cot', 'cer0', 'mu0', 'toa0', 'rad', 'rad_std', 'ref',
                 'ref_std', 'ref_2s'):
        assert_same(getattr(multi[0], name), getattr(multi[1], name), name)
    for mode in ('rt', '2s'):
        for method in ('cubic', 'linear'):
            assert_same(multi[0].get_cot_from_ref(0.4, method, mode),
                        multi[1].get_cot_from_ref(0.4, method, mode))
            assert_same(multi[0].get_ref_from_cot(8.0, method, mode),
                        multi[1].get_ref_from_cot(8.0, method, mode))
    _same_calls(made_up, atms, ['cpu'] * 4)


def test_spectral_wrappers_on_made_up_results(made_up, atms):
    ja, ta = atms
    for fn, tgt in (('spectral_flux', 'flux'),
                    ('spectral_radiance', 'radiance')):
        jkw = tkw = dict(photons=1e4, n_run=1, seed=4,
                         solar_zenith_angle=30.0)
        if tgt == 'radiance':
            from er3t_tpu.pre.cld import cld_gen_hom as j_hom
            from er3t_tpu_torch.pre.cld import cld_gen_hom as t_hom
            jkw = dict(jkw, cld=j_hom(nx=3, ny=2, cot0=5.0))
            tkw = dict(tkw, cld=t_hom(nx=3, ny=2, cot0=5.0))
        got = (getattr(j_spec, fn)(ja, [650.0, 762.0], **jkw),
               getattr(t_spec, fn)(ta, [650.0, 762.0], device='cpu', **tkw))
        assert_same(*got)
        assert all(k['target'] == tgt for k in made_up['port'])
        _same_calls(made_up, atms, ['cpu'] * 2)


def test_apps_default_to_the_card():
    for fn in (t_lut.gen_bispectral_lookup_table, t_lut.func_ref_vs_cot,
               t_lut.func_ref_vs_cot_multi_pixel, t_spec.spectral_flux,
               t_spec.spectral_radiance):
        assert inspect.signature(fn).parameters['device'].default == 'cuda'
    for fn in (t_spec.spec_flx, t_spec.spec_rad, t_cldpos.correct_cloud_map):
        assert 'device' not in inspect.signature(fn).parameters


# ---- the port's transport under the apps ----

def test_ref_vs_cot_small_port_run(atms):
    """A small reflectance curve on the port's solve at device='cpu': five
    COT nodes, 2e4 photons; it rises with COT, inverts its own nodes and
    stays near the two-stream curve."""
    cot = np.array([0.0, 1.0, 5.0, 20.0, 80.0])
    c = t_lut.func_ref_vs_cot(atms[1], cot_grid=cot, photons=2e4,
                              solar_zenith_angle=30.0, seed=1, device='cpu')
    assert c.ref.shape == (5,) and np.all(np.isfinite(c.ref))
    assert np.all(np.diff(c.ref) > 0) and c.ref[-1] > 0.5
    assert abs(c.ref[3] - c.ref_2s[3]) < 0.25
    np.testing.assert_allclose(c.get_cot_from_ref(c.ref[1:]), cot[1:],
                               rtol=1e-12)


@pytest.mark.slow
def test_ref_vs_cot_monotone(atms):
    """tests/test_apps.py::test_ref_vs_cot_monotone on the port."""
    cot = np.array([0.0, 1.0, 5.0, 20.0, 80.0])
    c = t_lut.func_ref_vs_cot(atms[1], cot_grid=cot, photons=100000,
                              solar_zenith_angle=30.0, device='cpu')
    assert c.ref.shape == (5,)
    assert np.all(np.diff(c.ref) > 0)
    assert c.ref[-1] > 0.5
    assert abs(c.ref[3] - c.ref_2s[3]) < 0.25
    cot_hat = c.get_cot_from_ref(c.ref[2])
    assert cot_hat[0] == pytest.approx(5.0, rel=0.25)


@pytest.mark.slow
def test_bispectral_lut_and_retrieval(atms):
    """tests/test_apps.py::test_bispectral_lut_and_retrieval on the port."""
    cot = np.array([0.0, 2.0, 8.0, 30.0])
    cer = np.array([6.0, 12.0, 20.0])
    lut = t_lut.gen_bispectral_lookup_table(atms[1], cot_grid=cot,
                                            cer_grid=cer, photons=80000,
                                            wvl_nir=1600.0, device='cpu')
    assert lut['ref_vis'].shape == (4, 3)
    assert np.all(np.isfinite(lut['ref_vis']))
    assert np.all(np.diff(lut['ref_vis'], axis=0) > -0.02)
    cot_hat, cer_hat = t_lut.retrieve_cot_cer(lut, lut['ref_vis'][2, 1],
                                              lut['ref_nir'][2, 1])
    assert cot_hat[0] == pytest.approx(8.0)
    assert cer_hat[0] == pytest.approx(12.0)


@pytest.mark.slow
def test_ref_vs_cot_multi_pixel(atms):
    """tests/test_apps.py::test_ref_vs_cot_multi_pixel on the port."""
    atm = atms[1]
    cot = np.array([0.0, 2.0, 8.0, 30.0])
    c = t_lut.func_ref_vs_cot_multi_pixel(cot, atm=atm, photons=6e4, n_run=2,
                                          solar_zenith_angle=30.0, seed=5,
                                          device='cpu')
    assert c.ref.shape == c.ref_std.shape == (4,)
    assert np.all(np.diff(c.ref) > 0)
    assert np.all(c.ref_std[1:] > 0)
    assert np.all(c.ref_std < 0.2 * (c.ref + 0.05))
    cot_hat = c.get_cot_from_ref(c.get_ref_from_cot(8.0))
    assert float(cot_hat[0]) == pytest.approx(8.0, rel=0.15)
    r2 = c.get_ref_from_cot(2.0, mode='2s')
    assert float(r2[0]) == pytest.approx(float(c.ref_2s[1]), rel=1e-6)
    c2 = t_lut.func_ref_vs_cot_multi_pixel(np.array([0.0, 8.0]), atm=atm,
                                           photons=3e4, n_run=1,
                                           sensor_zenith_angle=30.0,
                                           sensor_azimuth_angle=45.0, seed=6,
                                           device='cpu')
    assert c2.ref[1] > c2.ref[0]


@pytest.mark.slow
def test_spec_flx_matches_mc(atms):
    """tests/test_spectral.py::test_spec_flx_matches_mc on the port, through
    spectral_flux (the port's solve at device='cpu')."""
    atm = atms[1]
    out = t_spec.spec_flx(atm, wavelengths=[650.0], solar_zenith_angle=30.0,
                          surface_albedo=0.2, slit=None, n_streams=8,
                          abs_fn=abs_synthetic)
    r = t_spec.spectral_flux(atm, [650.0], abs_fn=abs_synthetic, surface=0.2,
                             solar_zenith_angle=30.0, photons=1.5e5, n_run=1,
                             seed=2, device='cpu')
    assert out['f_down'][0] == pytest.approx(float(r['f_down'][0, 0, 0, 0]),
                                             rel=0.03)
    assert out['f_up'][0] == pytest.approx(float(r['f_up'][0, 0, 0, -1]),
                                           rel=0.06)

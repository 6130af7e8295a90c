"""The port's grid, geo, misc and physics helpers, ``cld_sat`` and
``sfc_sat`` against the reference's, bit for bit (``np.array_equal``, same
dtype), and the reference's closures of them on the port: the solar
position (``tests/test_physics.py:105``) and the COT conservation of the
2D-to-3D cloud stacking (``tests/test_cld_stack.py``).
"""

import datetime
import email
import json
import sys
import types

import numpy as np
import pytest
import torch

from er3t_tpu.physics import rayleigh as j_ray
from er3t_tpu.physics import solar as j_solar
from er3t_tpu.pre import cld as j_cld
from er3t_tpu.pre import sfc as j_sfc
from er3t_tpu.util import geo as j_geo
from er3t_tpu.util import grid as j_grid
from er3t_tpu.util import misc as j_misc
from er3t_tpu_torch.physics import rayleigh as t_ray
from er3t_tpu_torch.physics import solar as t_solar
from er3t_tpu_torch.pre import cld as t_cld
from er3t_tpu_torch.pre import sfc as t_sfc
from er3t_tpu_torch.util import geo as t_geo
from er3t_tpu_torch.util import grid as t_grid
from er3t_tpu_torch.util import misc as t_misc
from test_torch_pre import assert_same

torch.set_num_threads(2)


def _swath(seed, n=400, extent=(-61.0, -59.0, 14.0, 16.0)):
    """Seeded swath samples over ``extent`` and a margin, with NaN samples,
    and the extent's corners and edges among them."""
    rng = np.random.default_rng(seed)
    lon0, lon1, lat0, lat1 = extent
    lon = rng.uniform(lon0 - 0.2, lon1 + 0.2, n)
    lat = rng.uniform(lat0 - 0.2, lat1 + 0.2, n)
    lon[:4] = [lon0, lon1, lon0, lon1]
    lat[:4] = [lat0, lat0, lat1, lat1]
    data = rng.gamma(2.0, 5.0, n)
    data[rng.random(n) < 0.05] = np.nan
    lon[10] = np.nan
    return lon, lat, data


def both(name, *a, **kw):
    ref = getattr(j_grid, name)(*a, **kw)
    got = getattr(t_grid, name)(*a, **kw)
    assert_same(ref, got, name)
    return got


# ---------------- util/grid.py ----------------

@pytest.mark.parametrize('seed', [0, 1])
def test_grid_by_extent_and_core(seed):
    lon, lat, data = _swath(seed)
    ext = (-61.0, -59.0, 14.0, 16.0)
    _, _, grid = both('grid_by_extent', lon, lat, data, ext, nx=12, ny=9)
    assert grid.shape == (12, 9) and np.isfinite(grid).any()
    both('grid_by_extent', lon, lat, data, ext)             # default nx, ny
    edges = (np.linspace(-61, -59, 5), np.linspace(14, 16, 4))
    both('_grid_core', lon, lat, data, *edges)


def test_grid_by_extent_on_a_regular_grid_edges():
    """Samples on a 0.05-degree grid whose whole-degree values are the
    extent's edges (phase 11's AHI case): binning of the edge samples."""
    lon1 = (120.0 + np.arange(41) / 20.0).astype(np.float32)
    lat1 = (17.0 - np.arange(41) / 20.0).astype(np.float32)
    lon, lat = np.meshgrid(lon1, lat1)
    data = np.random.default_rng(2).uniform(0, 30, lon.shape)
    _, _, grid = both('grid_by_extent', lon, lat, data,
                      (120.0, 122.0, 15.0, 17.0), nx=48, ny=48)
    assert np.isnan(grid).any() and np.isfinite(grid).any()


@pytest.mark.parametrize('flip', ['none', 'lon', 'lat', 'both'])
def test_grid_by_lonlat_descending_axes(flip):
    lon, lat, data = _swath(3)
    lon_1d = np.linspace(-60.9, -59.1, 10)
    lat_1d = np.linspace(14.1, 15.9, 7)
    if flip in ('lon', 'both'):
        lon_1d = lon_1d[::-1]
    if flip in ('lat', 'both'):
        lat_1d = lat_1d[::-1]
    lon2, lat2, grid = both('grid_by_lonlat', lon, lat, data, lon_1d, lat_1d)
    assert grid.shape == (10, 7) and lon2[0, 0] == lon_1d[0]
    # flipping an axis flips the grid: the same samples land in the same cells
    asc = t_grid.grid_by_lonlat(lon, lat, data, np.sort(lon_1d),
                                np.sort(lat_1d))[2]
    if lon_1d[0] > lon_1d[-1]:
        asc = asc[::-1]
    if lat_1d[0] > lat_1d[-1]:
        asc = asc[:, ::-1]
    assert np.array_equal(asc, grid, equal_nan=True)


def test_grid_by_dxdy():
    lon, lat, data = _swath(4)
    both('grid_by_dxdy', lon, lat, data, extent=(-61.0, -59.0, 14.0, 16.0),
         dx_km=20.0, dy_km=25.0)
    ok = np.isfinite(lon)
    both('grid_by_dxdy', lon[ok], lat[ok], data[ok], dx_km=30.0, dy_km=30.0)


def test_upscale_find_nearest_combine_alt():
    a = np.arange(12.0).reshape(3, 4)
    both('upscale_2d', a)
    both('upscale_2d', a, scale=(3, 1))
    arr = np.random.default_rng(5).uniform(0, 10, 50)
    for v in (-1.0, 3.3, 7.77, 11.0):
        assert t_grid.find_nearest(arr, v) == j_grid.find_nearest(arr, v)
        assert type(t_grid.find_nearest(arr, v)) is int
    base = np.arange(0, 5.01, 0.5)
    both('combine_alt', base, np.array([0.25, 1.0 + 1e-8, 2.2, 7.0]))
    both('combine_alt', base, base + 1e-5, tol=1e-4)
    both('get_lay_index', np.array([0.1, 2.6, 9.0]), base)
    both('downscale', np.arange(24.0).reshape(4, 6), (2, 3), 'max')


# ---------------- util/geo.py ----------------

def test_geodesics_bit_for_bit():
    rng = np.random.default_rng(6)
    lon0, lat0 = rng.uniform(-180, 180, 64), rng.uniform(-80, 80, 64)
    lon1, lat1 = rng.uniform(-180, 180, 64), rng.uniform(-80, 80, 64)
    lon1[:2], lat1[:2] = lon0[:2], lat0[:2]             # zero distance
    assert_same(j_geo.cal_geodesic_dist(lon0, lat0, lon1, lat1),
                t_geo.cal_geodesic_dist(lon0, lat0, lon1, lat1))
    dist, az = rng.uniform(0, 5e6, 64), rng.uniform(0, 360, 64)
    assert_same(j_geo.cal_geodesic_lonlat(lon0, lat0, dist, az),
                t_geo.cal_geodesic_lonlat(lon0, lat0, dist, az))


def test_parse_geojson(tmp_path):
    ring = [[-60.0, 14.0], [-59.0, 14.0], [-59.0, 15.0], [-60.0, 14.0]]
    path = tmp_path / 'box.geojson'
    path.write_text(json.dumps({'features': [
        {'geometry': {'type': 'Polygon', 'coordinates': [ring]}}]}))
    got = t_geo.parse_geojson(str(path))
    assert_same(j_geo.parse_geojson(str(path)), got)
    assert got[0].tolist() == [-60.0, -59.0, -59.0, -60.0]


# ---------------- util/misc.py ----------------

def test_nice_array_str_and_h5dset(tmp_path):
    import h5py
    x = np.random.default_rng(7).normal(size=17)
    assert t_misc.nice_array_str(x) == j_misc.nice_array_str(x)
    assert t_misc.nice_array_str(x, 4) == j_misc.nice_array_str(x, 4)
    with pytest.raises(ValueError):
        t_misc.nice_array_str(x.reshape(1, -1))
    with h5py.File(tmp_path / 'd.h5', 'w') as f:
        d = f.create_dataset('grp/cot', data=np.arange(5.0))
        d.attrs['units'] = b'N/A'
        d.attrs['scale'] = 2.0
        f.create_dataset('plain', data=np.arange(3))
    with h5py.File(tmp_path / 'd.h5', 'r') as f:
        for name in ('grp/cot', 'plain'):
            assert_same(j_misc.h5dset_to_pydict(f[name]),
                        t_misc.h5dset_to_pydict(f[name]))


def _smtp_recorder(sent):
    """A stand-in for ``smtplib.SMTP`` that appends to ``sent`` the calls
    of each connection, in order, instead of sending anything."""
    class SMTP:
        def __init__(self, host, port):
            self.calls = [('connect', host, port)]

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            sent.append(self.calls)
            return False

        def starttls(self):
            self.calls.append(('starttls',))

        def login(self, user, password):
            self.calls.append(('login', user, password))

        def sendmail(self, sender, receiver, text):
            self.calls.append(('sendmail', sender, receiver, text))
    return SMTP


def test_send_email_with_a_stubbed_smtp(tmp_path, monkeypatch):
    """send_email of both packages against a recording stand-in for
    smtplib.SMTP (no mail leaves the process): the same calls and the same
    message, apart from its date and boundary."""
    sent = []
    monkeypatch.setitem(sys.modules, 'smtplib',
                        types.SimpleNamespace(SMTP=_smtp_recorder(sent)))
    att = tmp_path / 'log.txt'
    att.write_text('done\n')
    for k in ('ER3T_SMTP_HOST', 'ER3T_SMTP_USER', 'ER3T_SMTP_PASS',
              'ER3T_EMAIL_TO'):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError):
        t_misc.send_email('x')
    monkeypatch.setenv('ER3T_SMTP_HOST', 'smtp.example.invalid')
    monkeypatch.setenv('ER3T_SMTP_USER', 'a@example.invalid')
    monkeypatch.setenv('ER3T_SMTP_PASS', 'pw')
    monkeypatch.setenv('ER3T_EMAIL_TO', 'b@example.invalid')
    for mod in (j_misc, t_misc):
        mod.send_email('run finished', files=[str(att)])
    j_calls, t_calls = sent
    assert [c[:3] for c in t_calls] == [c[:3] for c in j_calls] == [
        ('connect', 'smtp.example.invalid', 587), ('starttls',),
        ('login', 'a@example.invalid', 'pw'),
        ('sendmail', 'a@example.invalid', 'b@example.invalid')]

    def parts(text):
        msg = email.message_from_string(text)
        return ([msg['From'], msg['To'], msg['Subject'].split(' ')[0]],
                [(p.get_content_type(), p.get_payload(decode=True))
                 for p in msg.walk() if not p.is_multipart()])
    assert parts(t_calls[-1][3]) == parts(j_calls[-1][3])
    assert parts(t_calls[-1][3])[1] == [('text/plain', b'run finished'),
                                        ('application/octet-stream',
                                         b'done\n')]


# ---------------- physics ----------------

def test_solar_angles_bit_for_bit():
    lon = np.linspace(-180, 180, 13)
    lat = np.linspace(-80, 80, 13)
    for dt in (datetime.datetime(2017, 8, 13, 18, 0),
               datetime.datetime(2019, 1, 3, 4, 30,
                                 tzinfo=datetime.timezone(
                                     datetime.timedelta(hours=8)))):
        assert_same(j_solar.solar_angles(dt, lon, lat),
                    t_solar.solar_angles(dt, lon, lat))


def test_solar_angles_sane():
    sza, saa = t_solar.solar_angles(datetime.datetime(2017, 8, 13, 18, 0),
                                    -105.0, 40.0)
    assert 25.0 < sza < 33.0
    assert 120.0 < saa < 180.0


def test_gravity_at_alt_and_rayleigh_phase():
    lat = np.linspace(-90, 90, 7)
    g0 = t_ray.gravity_surface(lat)
    z = np.linspace(0, 50000, 11)[:, None]
    assert_same(j_ray.gravity_at_alt(g0, lat, z), t_ray.gravity_at_alt(
        g0, lat, z))
    mu = np.linspace(-1, 1, 101)
    assert_same(j_ray.rayleigh_phase(mu), t_ray.rayleigh_phase(mu))
    assert np.trapezoid(t_ray.rayleigh_phase(mu), mu) == pytest.approx(
        2.0, rel=1e-3)


# ---------------- cld_sat, sfc_sat ----------------

class _Reader:
    """A reader object of the ``data[key]['data']`` contract."""

    def __init__(self, **arrays):
        self.data = {k: {'data': v, 'name': k, 'units': 'N/A'}
                     for k, v in arrays.items()}


def test_cld_sat_and_sfc_sat_bit_for_bit():
    rng = np.random.default_rng(8)
    cot = np.where(rng.random((9, 7)) < 0.4, rng.uniform(1, 40, (9, 7)), 0.0)
    cer = np.where(cot > 0, rng.uniform(6, 20, (9, 7)), 0.0)
    cth = np.where(cot > 0, rng.uniform(0.8, 3.2, (9, 7)), np.nan)
    kw = dict(dx=0.5, dy=0.5, cth=2.0, cgt=1.0, dz=0.25)
    got = t_cld.cld_sat(cot_2d=cot, cer_2d=cer, **kw)
    assert_same(j_cld.cld_sat(cot_2d=cot, cer_2d=cer, **kw), got)
    for obj in (_Reader(cot_2d=cot, cer_2d=cer),
                _Reader(cot_2d=cot, cer_2d=cer, cth_2d=cth)):
        assert_same(j_cld.cld_sat(obj, **kw), t_cld.cld_sat(obj, **kw))
    for mod in (j_cld, t_cld):
        with pytest.raises(ValueError):
            mod.cld_sat(_Reader(cot_2d=cot))
    alb = _Reader(alb_2d=rng.uniform(0, 0.4, (9, 7)))
    assert_same(j_sfc.sfc_sat(alb), t_sfc.sfc_sat(alb))


# ---------------- tests/test_cld_stack.py on the port ----------------

def _total_cot(cld):
    return (cld.extinction * 1000.0 * cld.thickness[None, None, :]).sum(-1)


@pytest.mark.parametrize('cth,cgt,dz', [
    (0.55, 0.05, 0.1),
    (0.55, 0.15, 0.1),
    (0.55, 0.55, 0.1),
    (2.0, 1.0, 0.1),
    (2.0, 0.0, 0.1),
    (2.5, 1.0, 0.3),
])
def test_cot_conserved(cth, cgt, dz):
    cot = 10.0
    args = (np.full((3, 2), cot), np.full((3, 2), 12.0),
            np.full((3, 2), cth), np.full((3, 2), cgt))
    c = t_cld.cld_gen_cop(*args, dz=dz)
    assert_same(j_cld.cld_gen_cop(*args, dz=dz), c)
    np.testing.assert_allclose(_total_cot(c), cot, rtol=1e-9)
    zmax = c.altitude[np.where(c.extinction[0, 0] > 0)[0]]
    if zmax.size:
        assert zmax.max() <= cth + dz
        assert zmax.min() >= cth - max(cgt, dz) - dz


def test_nan_cth_is_clear():
    cot = np.full((2, 2), 5.0)
    cth = np.full((2, 2), np.nan)
    c = t_cld.cld_gen_cop(cot, np.full((2, 2), 12.0), cth, dz=0.1)
    assert np.isfinite(c.extinction).all()
    assert _total_cot(c).max() == 0.0
    cth[0, 0] = 1.5
    c = t_cld.cld_gen_cop(cot, np.full((2, 2), 12.0), cth, dz=0.1)
    assert_same(j_cld.cld_gen_cop(cot, np.full((2, 2), 12.0), cth, dz=0.1), c)
    t = _total_cot(c)
    assert t[0, 0] == pytest.approx(5.0, rel=1e-9)
    assert t[1, 1] == 0.0


def test_partial_layer_split():
    c = t_cld.cld_gen_cop(np.full((1, 1), 6.0), np.full((1, 1), 10.0),
                          np.full((1, 1), 0.65), np.full((1, 1), 0.2), dz=0.1)
    ext = c.extinction[0, 0] * 1000.0 * 0.1
    k = np.where(ext > 0)[0]
    frac = ext[k] / 6.0
    np.testing.assert_allclose(sorted(frac), [0.25, 0.25, 0.5], rtol=1e-9)

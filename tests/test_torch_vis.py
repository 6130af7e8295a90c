"""The port's plots and comparison page (er3t_tpu_torch.vis) against the JAX
package's (er3t_tpu.vis): each PNG writer of both packages draws the same
seeded fields with Agg (the port's given torch tensors) into equal files,
and compare_data_2d_html writes the same page byte for byte, from a torch
tensor too and on a field above ``max_px`` (the block-average branch),
whose page data are the fields' block means."""

import json
import re

import numpy as np
import pytest
import torch

from er3t_tpu import vis as j_vis
from er3t_tpu_torch import vis as t_vis

torch.set_num_threads(2)


def _fields(shape, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.gamma(2.0, 0.05, shape).astype(np.float32)
    return a, (a * rng.uniform(0.9, 1.1, shape)).astype(np.float32)


def _flux(seed=1):
    rng = np.random.default_rng(seed)
    return {k: rng.uniform(0.1, 1.5, (3, 4, 21)).astype(np.float32)
            for k in ('f_down', 'f_down_direct', 'f_down_diffuse', 'f_up')}


def _draw(vis, name, fname, as_tensor):
    t = torch.from_numpy if as_tensor else (lambda a: a)
    a, b = _fields((24, 16))
    if name == 'quicklook_radiance':
        return vis.quicklook_radiance(t(a), fname=fname, title='rad')
    if name == 'plot_flux_profile':
        return vis.plot_flux_profile({k: t(v) for k, v in _flux().items()},
                                     np.linspace(0, 20, 21), fname=fname)
    return vis.compare_data_2d(t(a), t(b), labels=('IPA', '3D'), fname=fname)


@pytest.mark.parametrize('name', ['quicklook_radiance', 'plot_flux_profile',
                                  'compare_data_2d'])
def test_png_writers_match_the_reference(name, tmp_path):
    ref, got = tmp_path / 'ref.png', tmp_path / 'port.png'
    _draw(j_vis, name, str(ref), as_tensor=False)
    _draw(t_vis, name, str(got), as_tensor=True)
    assert ref.stat().st_size > 0
    assert got.read_bytes() == ref.read_bytes()


def _page_data(fname):
    """The two fields a page of compare_data_2d_html holds."""
    text = open(fname).read()
    return [np.array(json.loads(re.search(rf'const {k} = (.*);', text)[1]))
            for k in ('A', 'B')]


@pytest.mark.parametrize('shape,max_px,kind', [
    ((40, 30), 480, 'numpy'), ((40, 30), 480, 'tensor'),
    ((100, 70), 32, 'tensor'), ((33, 21), 480, 'nan')],
    ids=['numpy', 'tensor', 'block_average', 'nan'])
def test_compare_html_matches_the_reference(shape, max_px, kind, tmp_path):
    a, b = _fields(shape, seed=2)
    if kind == 'nan':
        a[3, 4] = np.nan
    ref, got = tmp_path / 'ref.html', tmp_path / 'port.html'
    j_vis.compare_data_2d_html(a, b, name0='IPA', name1='3D', fname=str(ref),
                               max_px=max_px)
    conv = torch.from_numpy if kind in ('tensor', 'block_average') \
        else (lambda x: x)
    out = t_vis.compare_data_2d_html(conv(a), conv(b), name0='IPA',
                                     name1='3D', fname=str(got),
                                     max_px=max_px)
    assert out == str(got)
    assert got.read_bytes() == ref.read_bytes()
    step = int(np.ceil(max(shape) / max_px))
    n0, n1 = shape[0] // step * step, shape[1] // step * step
    for field, page in zip((a, b), _page_data(got)):
        want = field.astype(np.float64)[:n0, :n1].reshape(
            n0 // step, step, n1 // step, step).mean((1, 3))
        assert page.shape == want.shape
        assert np.array_equal(page, np.round(np.nan_to_num(want), 7))


def test_compare_html_rejects_unequal_fields(tmp_path):
    a, b = _fields((8, 6))
    with pytest.raises(ValueError, match='same shape'):
        t_vis.compare_data_2d_html(torch.from_numpy(a), b[:4],
                                   fname=str(tmp_path / 'x.html'))

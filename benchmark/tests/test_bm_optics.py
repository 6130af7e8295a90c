"""The optics that the reference shares with the port (frozen copies of
``pre/pha.py`` and ``rtm/scene.py``) held to forms worked out here on
their own: Henyey-Greenstein rows against their closed forms, and a Mie
row's truncated fraction, its normalisation and the delta-scaled
extinction and albedo of the scene against a quadrature of the Mie table
in scattering angle.

The tables take the truncated fraction by the trapezoid rule in mu over
the source angles, whose segment across the cone's edge counts half its
edge value to the cone: the fraction comes out above the cone's own by a
quarter of P(edge) times that segment's width in mu, with the rest of the
row renormalised to match.  The checks hold the rows to the closed forms
with that edge term, and to nothing looser.
"""

import dataclasses

import numpy as np
import pytest

from benchmark.frozen import cld, pha, scene_np
from benchmark.lib.inputs import make_inputs

from conftest import tiny_cell

G = 0.85
TRUNC = 5.0


def _hg(mu):
    return (1 - G * G) / (1 + G * G - 2 * G * mu) ** 1.5


def _hg_cdf(mu):
    """Integral of P/2 from -1 to mu."""
    return (1 - G * G) / (2 * G) * ((1 + G * G - 2 * G * mu) ** -0.5
                                    - 1 / (1 + G))


def _hg_inv_cdf(u):
    return (1 + G * G - ((1 - G * G) / (1 - G + 2 * G * u)) ** 2) / (2 * G)


def _bins(n):
    """Edges and widths of the tables' uniform-mu bins."""
    grid = np.linspace(-1.0, 1.0, n)
    e = np.empty(n + 1)
    e[1:-1] = 0.5 * (grid[1:] + grid[:-1])
    e[0], e[-1] = -1.0, 1.0
    return e, np.diff(e)


def _edge_term(ang_deg, p, trunc_deg):
    """A quarter of P at the cone's edge node times the width in mu of the
    segment past it."""
    i = int(np.argmin(np.abs(ang_deg - trunc_deg)))
    th = np.deg2rad(ang_deg[i:i + 2])
    return 0.25 * p[i] * (np.cos(th[0]) - np.cos(th[1]))


@pytest.mark.parametrize('trunc', [None, TRUNC])
def test_hg_rows_against_their_closed_forms(trunc):
    obj = pha.pha_hg((G,))
    t = pha.build_phase_table(obj, forward_trunc_deg=trunc)
    e, w = _bins(t.p_eval.shape[1])
    mu_t = np.cos(np.deg2rad(trunc)) if trunc else 1.0
    f_cone = 1.0 - _hg_cdf(mu_t)
    edge = _edge_term(obj.data['ang'], obj.data['pha'][:, 0], trunc) \
        if trunc else 0.0
    f = float(t.trunc_f[1])
    assert f == pytest.approx(f_cone + edge, rel=1e-3, abs=1e-9)
    # bin averages of the full phase function over 1 - f: the TMS row, and
    # the working row in every bin below the cone
    full = 2.0 * np.diff(_hg_cdf(e)) / w
    np.testing.assert_allclose(t.p_tms[1], full / (1 - f), rtol=2e-3)
    below = e[1:] <= mu_t
    np.testing.assert_allclose(t.p_eval[1][below], full[below] / (1 - f),
                               rtol=2e-3)
    assert float(np.sum(t.p_eval[1] * w)) == pytest.approx(2.0, abs=1e-5)
    # the sampling row: the inverse of the (truncated) CDF
    u = np.linspace(0.0, 1.0, t.mu_sample.shape[1])
    want = np.minimum(_hg_inv_cdf(u * (1 - f)), mu_t)
    np.testing.assert_allclose(t.mu_sample[1], want, atol=2e-4)


@pytest.fixture(scope='module')
def mie10():
    """A water-cloud Mie row at r_eff 10 um, 650 nm."""
    return pha.pha_mie_wc(650.0, reff_grid=np.array([10.0]), n_quad=16)


def _mie_cone_fraction(obj):
    """The share of the Mie row scattered within TRUNC degrees of forward,
    by the trapezoid rule in angle (P sin(theta) d theta / 2) over the
    table's nodes, with the tables' edge term."""
    ang = np.asarray(obj.data['ang'])
    p = np.asarray(obj.data['pha'])[:, 0]
    m = ang <= TRUNC
    th = np.deg2rad(ang[m])
    cone = np.trapezoid(p[m] * np.sin(th), th) / 2.0
    return cone + _edge_term(ang, p, TRUNC)


def test_mie_truncation_and_normalisation(mie10):
    t = pha.build_phase_table(mie10, forward_trunc_deg=TRUNC)
    f = float(t.trunc_f[1])
    assert 0.3 < f < 0.6
    assert f == pytest.approx(_mie_cone_fraction(mie10), rel=1e-3)
    _, w = _bins(t.p_eval.shape[1])
    assert float(np.sum(t.p_eval[1] * w)) == pytest.approx(2.0, abs=1e-4)
    assert float(np.sum(t.p_tms[1] * w)) * (1 - f) == pytest.approx(
        2.0, abs=1e-4)
    mu_t = np.cos(np.deg2rad(TRUNC))
    assert float(t.mu_sample[1].max()) <= mu_t + 1e-7


def test_delta_scaled_extinction_and_albedo(mie10):
    """Every cloudy voxel of a uniform r_eff 10 um cloud: ext' = ext (1 -
    f ssa) and ssa' = ssa (1 - f) / (1 - f ssa), with f from the
    quadrature above and ssa from the Mie row."""
    cell = tiny_cell('rad_les.run1e6')
    inp = make_inputs(cell.config)
    c = cld.cld_gen_hem(nx=12, ny=12, nz=4, dx=0.1, dy=0.1, dz=0.5,
                        cloud_frac_tgt=0.3, radii=(0.5,), cot_scale=15.0,
                        cer0=10.0, cloud_base=0.5, seed=3)
    inp = dataclasses.replace(inp, cld=c)

    def build(trunc):
        leaves, _ = scene_np._build_numpy(
            inp.atm, inp.abs_coef, c, mie10, (), (), 0.03, 30.0, 45.0,
            False, trunc, None, None)
        return leaves
    plain, cut = build(None), build(TRUNC)
    cloudy = plain['ext3d'] > 0
    assert cloudy.sum() > 10
    ssa = float(np.asarray(mie10.data['ssa'])[0])
    f = _mie_cone_fraction(mie10)
    np.testing.assert_allclose(cut['ext3d'][cloudy],
                               plain['ext3d'][cloudy] * (1 - f * ssa),
                               rtol=1e-3)
    np.testing.assert_allclose(cut['ssa3d'][..., 0][cloudy],
                               ssa * (1 - f) / (1 - f * ssa), rtol=1e-3)
    np.testing.assert_array_equal(cut['ext3d'][~cloudy], 0.0)

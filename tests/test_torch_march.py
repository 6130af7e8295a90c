"""The port's event-marching engine (er3t_tpu_torch.rtm.mc.transport) against
er3t_tpu.rtm.mc.transport under the reference's own deviates.

1. Whole runs: the reference runs with ``cfg.max_events = k``, the port the
   same k steps with the reference's draws injected
   (``jax.random.uniform(fold_in(key, step), (B, 9))``, transposed); every
   tally (the image, the unpacked flux rows, the launched count and the
   steps) must agree within 1e-5 of its largest row.
2. Complete runs, step by step: every step of the reference's run, taken by
   the port from the reference's state, must give the same lanes (the
   discrete fields exactly) and tallies within 1e-5 of their largest row.
   A complete run is not compared as one tally: XLA contracts ``x + ux * s``
   into one fused multiply-add where PyTorch rounds twice, and over a few
   dozen scattering events the trajectories amplify that last-bit
   difference until one lane takes another branch (measured: first at step
   56 of the slant radiance case).
"""

import dataclasses
import functools
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from er3t_tpu.pre.abs import abs_synthetic
from er3t_tpu.pre.aer import Aerosol1D, Aerosol3D
from er3t_tpu.pre.atm import atm_atmmod
from er3t_tpu.pre.cld import cld_gen_hom
from er3t_tpu.pre.pha import pha_mie_wc
from er3t_tpu.pre.sfc import sfc_2d_gen, sfc_ocean
from er3t_tpu.rtm import mc as jmc
from er3t_tpu.rtm.scene import build_scene
from er3t_tpu_torch.rtm import mc as tmc
from er3t_tpu_torch.rtm.scene import scene_from_numpy

torch.set_num_threads(2)
B = 512
N_PHOTON = 1500
WHOLE_RUN_STEPS = (1, 12, 40)    # the deck is reached from step ~18 on


@functools.lru_cache(maxsize=None)
def _scene(kind):
    """Small scenes of the reference's tests: an 8x8 half-cloudy Mie deck
    (20-deg truncation, so never-scattered lanes read the TMS rows) over
    contiguous 0.5 km layers, with the variations of each case."""
    atm = atm_atmmod(np.concatenate([np.arange(0, 5.0, 0.5),
                                     np.arange(5.0, 20.1, 1.0)]))
    ab = abs_synthetic(650.0, atm, ng=4)
    cld = cld_gen_hom(nx=8, ny=8, nz=4, dx=0.5, dy=0.5, cot0=8.0, cer0=10.0,
                      cloud_base=1.0, cloud_top=3.0)
    cld.extinction[4:] = 0.0
    cld.cer[4:] = 0.0
    kw = dict(cld=cld, pha=pha_mie_wc(650.0), surface=0.15,
              solar_zenith_angle=30.0, solar_azimuth_angle=45.0,
              forward_trunc_deg=20.0)
    if kind == 'aer2':
        kw['aer_1ds'] = [
            Aerosol1D(aod=0.5, ssa=0.6, asy=0.5, z_bottom=0.0, z_top=2.0),
            Aerosol1D(aod=0.3, ssa=0.95, asy=0.8, z_bottom=1.0, z_top=6.0)]
    elif kind == 'slots2':
        kw['aer_3ds'] = [Aerosol3D(extinction=np.asarray(cld.extinction) * 0.7
                                   + 2e-4, ssa=0.9, asy=0.0)]
    elif kind == 'lsrt':
        kw['surface'] = sfc_2d_gen(np.broadcast_to([0.2, 0.05, 0.1],
                                                   (2, 3, 3)).copy())
    elif kind == 'coxmunk':
        kw['surface'] = sfc_ocean(650.0, u10=5.0, nx=2, ny=2)
    scn, st = build_scene(atm, ab, **kw)
    if kind == 'ipa':
        st = dataclasses.replace(st, ipa=True)
    return scn, st


CASES = {
    'radiance_nadir': ('base', dict(target='radiance')),
    'radiance_slant': ('base', dict(target='radiance', sensor_zenith=35.0,
                                    sensor_azimuth=60.0)),
    'flux_per_column': ('base', dict(target='flux', flux_per_column=True)),
    'flux_domain': ('base', dict(target='flux')),
    'ipa_flux': ('ipa', dict(target='flux', flux_per_column=True)),
    'ipa_radiance': ('ipa', dict(target='radiance')),
    'aer2_radiance': ('aer2', dict(target='radiance')),
    'aer2_flux': ('aer2', dict(target='flux')),
    'slots2_radiance': ('slots2', dict(target='radiance')),
    'lambertian_flux': ('base', dict(target='flux', rr_wmin=0.3)),
    'lsrt_radiance': ('lsrt', dict(target='radiance')),
    'coxmunk_radiance': ('coxmunk', dict(target='radiance',
                                         sensor_zenith=20.0)),
    'coxmunk_flux': ('coxmunk', dict(target='flux', flux_per_column=True)),
}


def jax_deviates(key):
    """The reference's per-step draws (mc.py:464-466), as the port's
    (9, B) rows."""
    def draw(step):
        u = jax.random.uniform(jax.random.fold_in(key, step), (B, 9),
                               dtype=jnp.float32, minval=1e-7,
                               maxval=1.0 - 1e-7)
        return torch.from_numpy(np.ascontiguousarray(np.asarray(u).T))
    return draw


def run_both(scn, st, kw, k, seed=0):
    """The reference's transport capped at ``k`` steps (0: its default
    cap) and the port's under the same deviates."""
    cfg = dict(batch=B, n_scat_max=200, max_events=k, **kw)
    key = jax.random.key(seed)
    ref = jax.jit(jmc.transport, static_argnums=(1, 2, 3))(
        scn, st, jmc.SolverConfig(**cfg), N_PHOTON, key)
    got = tmc.transport(*scene_from_numpy(scn, st, 'cpu'),
                        tmc.SolverConfig(**cfg), N_PHOTON, seed, 'cpu',
                        deviates=jax_deviates(key))
    return ref, got


def assert_tallies_agree(ref, got, what):
    assert int(got.n_launched) == int(ref.n_launched), what
    assert int(got.n_steps) == int(ref.n_steps), what
    for f in ('rad', 'flux'):
        a = getattr(got, f).double().numpy()
        b = np.asarray(getattr(ref, f), np.float64)
        assert a.shape == b.shape, (what, f, a.shape, b.shape)
        atol = 1e-5 * max(np.abs(b).max(), 1e-30)
        np.testing.assert_allclose(a, b, rtol=0, atol=atol,
                                   err_msg=f'{what} {f}')


@pytest.mark.parametrize('case', list(CASES))
def test_march_whole_run_parity_with_injected_deviates(case):
    kind, kw = CASES[case]
    scn, st = _scene(kind)
    for k in WHOLE_RUN_STEPS:
        ref, got = run_both(scn, st, kw, k)
        assert_tallies_agree(ref, got, f'{case} k={k}')
    assert float(got.lane_iters) == int(got.n_steps) * B


def jax_states(scn, st, cfg, key):
    """Every loop state of the reference's run: its transport un-jitted,
    with ``jax.lax.while_loop`` replaced by a Python loop of the jitted
    body."""
    states = []

    def loop(cond, body, s):
        body = jax.jit(body)
        states.append(s)
        while bool(cond(s)):
            s = body(s)
            states.append(s)
        return s
    with mock.patch.object(jax.lax, 'while_loop', loop):
        jmc.transport(scn, st, cfg, N_PHOTON, key)
    return states


def to_port(s, kern):
    """A reference state as the port's carry: the packed flux rows
    unpacked, and the tally a target does not use at the port's size."""
    ng = kern.st.ng
    lanes = {f: torch.from_numpy(np.array(getattr(s, f)))
             for f in ('x', 'y', 'z', 'l', 'ux', 'uy', 'uz', 'wsc', 'S',
                       'tau', 'nscat', 'direct', 'alive', 'ix0', 'iy0')}
    n_rows = kern.nxf * kern.nyf * kern.nlev * 3
    if kern.radiance:
        rad = torch.from_numpy(np.array(s.rad))
        flux = torch.zeros((1, ng))
    else:
        rad = torch.zeros((1, ng))
        flux = torch.from_numpy(np.ascontiguousarray(
            np.array(s.flux).reshape(-1, ng)[:n_rows]))
    return tmc.MarchingCarry(**lanes, launched=torch.tensor(int(s.launched)),
                             step=int(s.step), rad=rad, flux=flux)


@pytest.mark.parametrize('case', list(CASES))
def test_march_complete_run_step_parity(case):
    kind, kw = CASES[case]
    scn, st = _scene(kind)
    cfg = dict(batch=B, n_scat_max=200, **kw)
    key = jax.random.key(1)
    states = jax_states(scn, st, jmc.SolverConfig(**cfg), key)
    kern = tmc.MarchingKernel(*scene_from_numpy(scn, st, 'cpu'),
                              tmc.SolverConfig(**cfg), N_PHOTON)
    draw = jax_deviates(key)
    scale = {'x': st.nx * st.dx, 'y': st.ny * st.dy}
    for k in range(len(states) - 1):
        got = kern.step(to_port(states[k], kern), draw(k))
        ref = to_port(states[k + 1], kern)
        what = f'{case} step {k}'
        for f in ('l', 'nscat', 'direct', 'alive', 'ix0', 'iy0'):
            assert torch.equal(getattr(got, f), getattr(ref, f)), (what, f)
        assert int(got.launched) == int(ref.launched), what
        for f in ('x', 'y'):
            d = (getattr(got, f) - getattr(ref, f)).abs()
            d = torch.minimum(d, scale[f] - d)             # periodic
            assert float(d.max()) <= 1e-5 * scale[f], (what, f)
        for f in ('z', 'ux', 'uy', 'uz', 'wsc', 'tau', 'S'):
            np.testing.assert_allclose(getattr(got, f).numpy(),
                                       getattr(ref, f).numpy(), rtol=1e-4,
                                       atol=1e-5, err_msg=f'{what} {f}')
        for f in ('rad', 'flux'):
            a, b = getattr(got, f).double(), getattr(ref, f).double()
            assert float((a - b).abs().max()) <= 1e-5 * max(
                float(b.abs().max()), 1e-30), (what, f)
    # the run was complete: the budget launched, every lane dead
    last = states[-1]
    assert int(last.launched) == N_PHOTON and not np.asarray(last.alive).any()
    assert len(states) - 1 > 100


def test_march_kernel_tables_equal_reference():
    """The packed tables of MarchingKernel hold the reference's values."""
    scn, st = _scene('slots2')
    kern = tmc.MarchingKernel(*scene_from_numpy(scn, st, 'cpu'),
                              tmc.SolverConfig(target='flux'), 100)
    ns3 = st.ns3
    vox3 = np.concatenate(
        [np.asarray(scn.ext3d).reshape(-1, 1),
         np.stack([np.asarray(scn.cf3d).reshape(-1, ns3),
                   np.asarray(scn.ssa3d).reshape(-1, ns3),
                   np.asarray(scn.apf3d).reshape(-1, ns3).astype(np.float32)],
                  axis=2).reshape(-1, 3 * ns3)], axis=1)
    np.testing.assert_array_equal(kern.vox3.numpy(), vox3)
    z = np.asarray(scn.z_lev)
    lay = np.concatenate([np.stack([z[:-1], z[1:], np.asarray(scn.sig_maj),
                                    np.asarray(scn.sig_ray)], axis=1),
                          np.asarray(scn.sig_aer)], axis=1)
    np.testing.assert_array_equal(kern.lay_tab.numpy(), lay)
    np.testing.assert_array_equal(kern.kabs_min.numpy(),
                                  np.asarray(scn.kabs).min(axis=1))
    dz = z[1:] - z[:-1]
    sig_1d = np.asarray(scn.sig_ray) + np.asarray(scn.sig_aer).sum(axis=1)
    cum = np.concatenate([np.cumsum((sig_1d * dz)[::-1])[::-1], [0.0]])
    np.testing.assert_allclose(kern.cum_sig.numpy(), cum, rtol=1e-6)


def test_march_default_cap_and_explicit_cap():
    """The default cap is the reference's ceil(n/B + 1) * 4 * (nz + 40),
    not the flight engine's; an explicit max_events replaces it, and a run
    cut there leaves photons unlaunched exactly as the reference's."""
    scn, st = _scene('base')
    ref, got = run_both(scn, st, dict(target='flux'), 7)
    assert_tallies_agree(ref, got, 'cap 7')
    assert int(got.n_steps) == 7 and int(got.n_launched) < N_PHOTON
    stats = {}
    tmc.transport(*scene_from_numpy(scn, st, 'cpu'),
                  tmc.SolverConfig(target='flux', batch=B, max_events=3),
                  N_PHOTON, 0, 'cpu', stats=stats)
    assert stats['max_steps'] == 3
    kern = tmc.MarchingKernel(*scene_from_numpy(scn, st, 'cpu'),
                              tmc.SolverConfig(batch=B), N_PHOTON)
    assert kern.max_steps() == int(np.ceil(N_PHOTON / B + 1) * 4
                                   * (st.nz + 40))


def test_march_run_transport_seeded_and_on_the_scene_device():
    """run_transport: the reference's signature plus device; one seed, one
    result; a scene on another device than asked raises."""
    scn, st = _scene('base')
    s_t, st_t = scene_from_numpy(scn, st, 'cpu')
    cfg = tmc.SolverConfig(target='flux', batch=256)
    a = tmc.run_transport(s_t, st_t, cfg, 500, seed=4, device='cpu')
    b = tmc.run_transport(s_t, st_t, cfg, 500, seed=4, device='cpu')
    assert torch.equal(a.flux, b.flux) and int(a.n_launched) == 500
    assert a.absorbed.shape == (1, 1) and float(a.absorbed.sum()) == 0.0
    with pytest.raises(ValueError, match='not meta'):
        tmc.run_transport(s_t, st_t, cfg, 500, seed=4, device='meta')

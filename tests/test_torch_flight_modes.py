"""The flight engine's solvers and variance knobs against er3t_tpu.

One step at a time with injected deviates, as tests/test_torch_flight.py
does for the satellite radiance path: from the same carry and the same
deviates (JAX's own draws: ``fold_in(key, step)`` for the (14, B) block,
``fold_in(key, step + 2**30)`` for splitting, ``fold_in(key, step +
2**29)`` for the camera-importance launch) both packages must give the
same next carry up to f32 rounding.  :func:`step_parity` is the harness;
tests/test_torch_camera.py and tests/test_torch_flux_modes.py use it too.
Here: IPA, partial 3D, pathlength, collision forcing, splitting, the
sensor-importance roulette, the coherent launch, and the lane sort.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from er3t_tpu.pre.atm import atm_atmmod
from er3t_tpu.pre.abs import abs_synthetic
from er3t_tpu.pre.cld import cld_gen_hem
from er3t_tpu.pre.pha import pha_mie_wc
from er3t_tpu.rtm import mc_flight as jmf
from er3t_tpu.rtm.mc import SolverConfig as JConfig
from er3t_tpu.rtm.out import spectral_factors
from er3t_tpu.rtm.scene import build_scene
from er3t_tpu_torch.rtm import mc_flight as tmf
from er3t_tpu_torch.rtm.mc import SolverConfig as TConfig
from er3t_tpu_torch.rtm.scene import scene_from_numpy

torch.set_num_threads(2)
B = 4096
KW = dict(target='radiance', batch=B, n_scat_max=300, tile_size=16,
          qmc_launch=True)


@functools.lru_cache(maxsize=None)
def broken():
    """The 32x32 broken-cloud Mie scene of tests/test_torch_flight.py (4
    g-points, 20-deg truncation, tiles, stratified launch), its radiance
    factors and its (Nz+1, Ng) flux factors."""
    levels = np.concatenate([np.arange(0, 3.0, 0.5), np.arange(3.0, 20.1, 1.0)])
    atm = atm_atmmod(levels)
    ab = abs_synthetic(650.0, atm, ng=4)
    cld = cld_gen_hem(nx=32, ny=32, nz=4, dx=0.2, dy=0.2, dz=0.5,
                      cloud_frac_tgt=0.3, radii=(0.4,), cot_scale=12.0,
                      cloud_base=0.5, seed=3)
    scn, st = build_scene(atm, ab, cld=cld, pha=pha_mie_wc(650.0),
                          surface=0.05, solar_zenith_angle=30.0,
                          solar_azimuth_angle=45.0, forward_trunc_deg=20.0)
    rad_w = spectral_factors(ab, nz_out=1)[0][0]
    flux_w = spectral_factors(ab, nz_out=st.nz + 1)[0]
    return ab, scn, st, rad_w, flux_w


def to_port(c, kern):
    """The reference's carry in the port's layout: its packed flux rows
    unpacked to (rows, Ng), or the flat scalar tally as it is."""
    lanes = {f: torch.from_numpy(np.array(getattr(c, f)))
             for f in tmf._LANE_FIELDS}
    ng = kern.st.ng
    if kern.radiance:
        flux = np.zeros((1, ng), np.float32)
    else:
        flux = np.array(c.flux)
        if flux.ndim == 2:
            flux = flux.reshape(-1, ng)[:kern.nxf * kern.nyf * kern.nlev * 3]
    return tmf.FlightCarry(
        **lanes, launched=torch.tensor(int(c.launched)), step=int(c.step),
        rad=torch.from_numpy(np.array(c.rad)),
        rad_pl=torch.from_numpy(np.array(c.rad_pl)),
        flux=torch.from_numpy(np.ascontiguousarray(flux)),
        absorbed=torch.from_numpy(np.array(c.absorbed)))


def close(got, ref, what, atol):
    """A tally: total to rel 1e-4 and each element to ``atol`` of the
    largest."""
    got = got.double().numpy()
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    assert got.sum() == pytest.approx(ref.sum(), rel=1e-4), what
    np.testing.assert_allclose(got, ref, rtol=0, atol=atol * np.abs(ref).max(),
                               err_msg=what)


def step_parity(scn, st, kw, steps=6, rad_w=None, flux_w=None,
                n_photon=60000, flight_rtol=2e-6, slab=None, x_off=0.0,
                spawn_reserve=0):
    """Step both packages ``steps`` times from the reference's carries with
    the reference's deviates; continuous fields to rtol 1e-4 / atol 1e-5,
    coordinates to the larger of 1e-5 of the domain and ``flight_rtol`` of
    the step's flight (see below), discrete fields on >= 99.9 % of
    lanes, the launch count exactly, the image and pathlength tallies in
    total to rel 1e-4, flux and absorbed tallies elementwise (3e-5 of the
    largest row for domain-average rows, else 1e-5).  With ``slab``
    ((nx_global, nx_local)) ``scn``/``st`` are a slab's shard, at
    ``x_off`` [m], stepped by both packages' x-slab branch with
    ``spawn_reserve``.  Returns the port's last carry and the kernel."""
    key = jax.random.key(0)
    slab_kw = {}
    if slab is not None:
        slab_kw = dict(slab=jmf.SlabSpec(*slab), x_off=jnp.float32(x_off),
                       spawn_reserve=spawn_reserve)
    body, _, c = jmf.make_flight_kernel(
        scn, st, JConfig(**kw), jnp.int32(n_photon), key,
        rad_w=None if rad_w is None else jnp.asarray(rad_w, jnp.float32),
        flux_w=None if flux_w is None else jnp.asarray(flux_w, jnp.float32),
        **slab_kw)
    body = jax.jit(body)
    q_off = int(jax.random.randint(jax.random.fold_in(key, 0x3FFFFFFF), (),
                                   0, st.nx * st.ny, dtype=jnp.int32))
    if slab is not None:
        slab_kw = dict(slab=tmf.SlabSpec(*slab), x_off=x_off,
                       spawn_reserve=spawn_reserve)
    kern = tmf.FlightKernel(*scene_from_numpy(scn, st, 'cpu'), TConfig(**kw),
                            n_photon, rad_w=rad_w, flux_w=flux_w, **slab_kw)
    scale = {'x': kern.nx_glob * st.dx, 'y': st.ny * st.dy,
             'z': float(scn.z_lev[-1])}

    def draw(offset, shape):
        return torch.from_numpy(np.array(jax.random.uniform(
            jax.random.fold_in(key, c.step + offset), shape,
            minval=1e-7, maxval=1 - 1e-7)))

    for k in range(steps):
        extra = {}
        if kw.get('split_wmax', 0) > 0:
            extra['u_split'] = draw(1 << 30, (B,))
        if kern.cam_importance:
            extra['u_imp'] = draw(1 << 29, (3, B))
        u = draw(0, (14, B))
        ref = body(c)
        got = kern.step(to_port(c, kern), u, q_off, **extra)
        # a coordinate is its start plus the flight, so it carries the
        # flight's f32 rounding, 16 ulp (2e-6) of a flight that may run
        # several domain widths
        flight = np.abs(np.asarray(ref.plen) - np.asarray(c.plen))
        for f in ('x', 'y', 'z'):
            a, b = np.asarray(getattr(ref, f)), getattr(got, f).numpy()
            d = np.abs(a - b)
            if f != 'z':
                d = np.minimum(d, scale[f] - d)           # periodic
            excess = d - np.maximum(1e-5 * scale[f], flight_rtol * flight)
            assert excess.max() <= 0, (k, f, d[excess.argmax()])
        for f in ('ux', 'uy', 'uz', 'wsc', 'labs', 'tau', 'plen'):
            np.testing.assert_allclose(getattr(got, f).numpy(),
                                       np.asarray(getattr(ref, f)),
                                       rtol=1e-4, atol=1e-5, err_msg=f'{k} {f}')
        # lanes within rounding of a threshold may flip a decision
        for f in ('alive', 'nscat', 'direct', 'ix0', 'iy0'):
            same = np.mean(getattr(got, f).numpy() == np.asarray(getattr(ref, f)))
            assert same >= 0.999, (k, f, same)
        assert int(got.launched) == int(ref.launched)
        assert got.step == int(ref.step)
        for f in ('rad', 'rad_pl'):
            r_ref = float(np.asarray(getattr(ref, f), np.float64).sum())
            assert float(getattr(got, f).double().sum()) == pytest.approx(
                r_ref, rel=1e-4), (k, f)
        if not kern.radiance:
            ref_port = to_port(ref, kern)
            atol = 3e-5 if kern.tally_absorbed else 1e-5
            close(got.flux, ref_port.flux, f'{k} flux', atol)
            close(got.absorbed, ref_port.absorbed, f'{k} absorbed', atol)
        c = ref
    return got, kern


# A forced flight ends where its optical depth reaches tau_f: an ulp of
# tau_f ~ 1.3 (its last layer's share is tau_f - cum_before) over a
# clear-sky majorant of 3e-6 /m is ~0.04 m of flight.  One forced flight of 7239.614 m (f64) ends 0.073 m further in the
# reference and 0.089 m shorter in the port, 2.2e-5 of the flight apart;
# so forced runs hold coordinates to 4e-5 of the flight.
FORCED_RTOL = 4e-5


@pytest.mark.parametrize('mode', [
    'ipa', 'p3d', 'pathlength', 'cf_dtau', 'split_wmax', 'rr_value',
    'launch_coherent'])
def test_mode_step_parity_with_injected_deviates(mode):
    ab, scn, st, rad_w, _ = broken()
    kw = dict(KW)
    if mode == 'ipa':
        st = dataclasses.replace(st, ipa=True)
    elif mode == 'p3d':
        kw['p3d_order'] = 1
    elif mode == 'pathlength':
        kw['pathlength'] = True
        rad_w = None                     # the ratio needs the per-g image
    elif mode == 'cf_dtau':
        kw['cf_dtau'] = 2.0
    elif mode == 'split_wmax':
        kw['split_wmax'] = 0.5
    elif mode == 'rr_value':
        kw['rr_value'] = 0.1
    else:
        kw.update(qmc_launch=False, launch_coherent=True)
    got, kern = step_parity(scn, st, kw, steps=8, rad_w=rad_w,
                            flight_rtol=FORCED_RTOL if mode == 'cf_dtau'
                            else 2e-6)
    assert float(got.rad.sum()) > 0
    if mode == 'ipa':
        # every lane sits in its birth column
        ix = torch.clamp(torch.floor(got.x / st.dx).int(), 0, st.nx - 1)
        assert torch.equal(ix[got.alive], got.ix0[got.alive])
    if mode == 'pathlength':
        assert tuple(got.rad_pl.shape) == (st.nx * st.ny, st.ng)
        assert float(got.rad_pl.sum()) > 1e4 * float(got.rad.sum())


def test_sort_lanes_gives_the_reference_permutation():
    """tmf._sort_lanes permutes every lane exactly as the reference's
    _sort_lanes (stable by column, dead lanes last)."""
    _, scn, st, rad_w, _ = broken()
    kw = dict(KW, sort_every=4)
    key = jax.random.key(1)
    body, _, c = jmf.make_flight_kernel(scn, st, JConfig(**kw),
                                        jnp.int32(6000), key,
                                        rad_w=jnp.asarray(rad_w, jnp.float32))
    body = jax.jit(body)
    kern = tmf.FlightKernel(*scene_from_numpy(scn, st, 'cpu'), TConfig(**kw),
                            6000, rad_w=rad_w)
    for _ in range(5):
        c = body(c)
    assert 0 < int(np.sum(np.asarray(c.alive))) < B
    ref = jmf._sort_lanes(c, st)
    got = tmf._sort_lanes(to_port(c, kern), st)
    for f in tmf._LANE_FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)

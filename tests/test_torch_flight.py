"""The port's flight kernel against er3t_tpu.rtm.mc_flight.

1. One step at a time with injected deviates: from the same carry and the
   same (14, B) uniforms (JAX's own threefry draws) both packages must give
   the same next carry up to f32 rounding.
2. Whole runs agree statistically (different RNG streams).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from er3t_tpu.pre.atm import atm_atmmod
from er3t_tpu.pre.abs import abs_synthetic
from er3t_tpu.pre.aer import Aerosol1D, Aerosol3D
from er3t_tpu.pre.cld import cld_gen_hem, cld_gen_hom
from er3t_tpu.pre.pha import pha_mie_wc
from er3t_tpu.pre.sfc import sfc_2d_gen, sfc_ocean
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
def _broken(ocean=False):
    """32x32 broken-cloud Mie scene, 4 g-points, 20-deg truncation; the
    production knobs (tiles, stratified launch, in-step contraction);
    ``ocean``: a Cox-Munk ocean (u10 = 5 m/s) in place of the Lambertian
    surface."""
    levels = np.concatenate([np.arange(0, 3.0, 0.5), np.arange(3.0, 20.1, 1.0)])
    atm = atm_atmmod(levels)
    ab = abs_synthetic(650.0, atm, ng=4)
    cld = cld_gen_hem(nx=32, ny=32, nz=4, dx=0.2, dy=0.2, dz=0.5,
                      cloud_frac_tgt=0.3, radii=(0.4,), cot_scale=12.0,
                      cloud_base=0.5, seed=3)
    surface = sfc_ocean(650.0, u10=5.0, nx=32, ny=32) if ocean else 0.05
    scn, st = build_scene(atm, ab, cld=cld, pha=pha_mie_wc(650.0),
                          surface=surface, solar_zenith_angle=30.0,
                          solar_azimuth_angle=45.0, forward_trunc_deg=20.0)
    rad_w = spectral_factors(ab, nz_out=1)[0][0]
    return scn, st, rad_w, KW


@functools.lru_cache(maxsize=None)
def _mixed():
    """Two 1D aerosols, a 3D aerosol beside the cloud (two 3D slots), a
    per-pixel LSRT surface, a slant sensor, no tiles, per-g image."""
    atm = atm_atmmod(np.linspace(0, 20, 21))
    ab = abs_synthetic(650.0, atm, ng=4)
    cld = cld_gen_hom(nx=8, ny=8, nz=2, dx=1.0, dy=1.0, cot0=6.0, cer0=10.0,
                      cloud_base=1.0, cloud_top=3.0)
    cld.extinction[4:] = 0.0
    cld.cer[4:] = 0.0
    a1 = Aerosol1D(aod=0.3, ssa=0.9, asy=0.7, z_bottom=0.0, z_top=2.0)
    a2 = Aerosol1D(aod=0.2, ssa=1.0, asy=0.8, z_bottom=3.0, z_top=6.0)
    a3 = Aerosol3D(extinction=np.asarray(cld.extinction) * 0.2 + 2e-5,
                   ssa=0.85, asy=0.6)
    rng = np.random.default_rng(7)
    lsrt = np.stack([rng.uniform(0.05, 0.3, (8, 8)), rng.uniform(0, 0.05, (8, 8)),
                     rng.uniform(0, 0.2, (8, 8))], axis=-1)
    scn, st = build_scene(atm, ab, cld=cld, aer_1ds=[a1, a2], aer_3ds=[a3],
                          surface=sfc_2d_gen(lsrt), solar_zenith_angle=40.0,
                          solar_azimuth_angle=120.0)
    kw = dict(target='radiance', batch=B, n_scat_max=300,
              sensor_zenith=30.0, sensor_azimuth=60.0)
    return scn, st, None, kw


def _to_port(c):
    lanes = {f: torch.from_numpy(np.array(getattr(c, f)))
             for f in tmf._LANE_FIELDS}
    ng = c.labs.shape[0] - 1
    return tmf.FlightCarry(**lanes, launched=torch.tensor(int(c.launched)),
                           step=int(c.step),
                           rad=torch.from_numpy(np.array(c.rad)),
                           rad_pl=torch.from_numpy(np.array(c.rad_pl)),
                           flux=torch.zeros(1, ng), absorbed=torch.zeros(1, 1))


# ocean: the broken scene seen by a slant sensor near the sun's glint
@pytest.mark.parametrize('make, sensor', [
    (_broken, {}), (_mixed, {}),
    (functools.partial(_broken, ocean=True),
     dict(sensor_zenith=30.0, sensor_azimuth=225.0))],
    ids=['broken', 'mixed', 'ocean'])
def test_step_parity_with_injected_deviates(make, sensor):
    scn, st, rad_w, kw = make()
    kw = dict(kw, **sensor)
    n_photon = 60000
    key = jax.random.key(0)
    body, _, c = jmf.make_flight_kernel(
        scn, st, JConfig(**kw), jnp.int32(n_photon), key,
        rad_w=None if rad_w is None else jnp.asarray(rad_w, jnp.float32))
    body = jax.jit(body)
    # the launch offset and the deviates exactly as mc_flight.py:333, 380
    q_off = int(jax.random.randint(jax.random.fold_in(key, 0x3FFFFFFF), (),
                                   0, st.nx * st.ny, dtype=jnp.int32))
    kern = tmf.FlightKernel(*scene_from_numpy(scn, st, 'cpu'),
                                  TConfig(**kw), n_photon, rad_w=rad_w)
    # coordinates are stored to an ulp of the domain, not of themselves
    # (periodic wrap, tile faces): compare them on the domain's scale
    scale = {'x': st.nx * st.dx, 'y': st.ny * st.dy,
             'z': float(scn.z_lev[-1])}
    for k in range(8):
        u = jax.random.uniform(jax.random.fold_in(key, c.step), (14, B),
                               minval=1e-7, maxval=1 - 1e-7)
        ref = body(c)
        got = kern.step(_to_port(c), torch.from_numpy(np.array(u)), q_off)
        for f in ('x', 'y', 'z'):
            a, b = np.asarray(getattr(ref, f)), getattr(got, f).numpy()
            d = np.abs(a - b)
            if f != 'z':
                d = np.minimum(d, scale[f] - d)           # periodic
            assert d.max() <= 1e-5 * scale[f], (k, f, d.max())
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
        r_ref = float(np.asarray(ref.rad, np.float64).sum())
        assert float(got.rad.double().sum()) == pytest.approx(r_ref, rel=1e-4)
        c = ref


def test_whole_run_matches_reference():
    """Domain-mean radiance within 2% at 60k photons (the statistical rule
    of tests/test_pallas_phase.py:91), exact launch count."""
    scn, st, rad_w, _ = _broken()
    a = jmf.run_transport_flight(scn, st, JConfig(**KW), 60000, seed=2,
                                 rad_w=rad_w)
    tscn, tst = scene_from_numpy(scn, st, 'cpu')
    b = tmf.run_transport_flight(tscn, tst, TConfig(**KW), 60000, 2, 'cpu',
                                 rad_w=rad_w)
    assert int(b.n_launched) == int(a.n_launched) == 60000
    assert tuple(b.rad.shape) == tuple(a.rad.shape) == (32, 32, 1)
    ia = float(np.asarray(a.rad).sum()) / int(a.n_launched)
    ib = float(b.rad.sum()) / int(b.n_launched)
    assert ib == pytest.approx(ia, rel=0.02)

"""Tests of the port that need an NVIDIA GPU (marker ``cuda``).

They skip where ``torch.cuda.is_available()`` is False.  This file imports
no JAX, so it also runs on a machine without it; tests/conftest.py does
import JAX, hence on such a machine:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
from er3t_tpu_torch._build import CudaError, launch
from er3t_tpu_torch.pre.abs import abs_synthetic
from er3t_tpu_torch.pre.atm import atm_atmmod
from er3t_tpu_torch.pre.cld import cld_gen_hem
from er3t_tpu_torch.pre.pha import pha_mie_wc
from er3t_tpu_torch.probes import gather
from er3t_tpu_torch.probes.gather_probe import device_ms
from er3t_tpu_torch.rtm import mc, mc_flight
from er3t_tpu_torch.rtm.mc import SolverConfig
from er3t_tpu_torch.rtm.out import spectral_factors
from er3t_tpu_torch.rtm.phase_pair import phase_pair, phase_pair_ref
from er3t_tpu_torch.rtm.quasi import quasi_radiance
from er3t_tpu_torch.rtm.scene import build_scene

torch.set_num_threads(2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU: the CUDA kernels have no CPU mode')
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda', 0)


def _lanes(rng, b, npf, n_m, n_u):
    pt_p = (rng.normal(size=(2 * npf, n_m)) * 10).astype(np.float32)
    pt_mu = rng.uniform(-1, 1, size=(npf, n_u)).astype(np.float32)
    apf = rng.integers(0, npf, b).astype(np.int32)
    row_e = (apf + np.where(rng.integers(0, 2, b) > 0, npf, 0)).astype(np.int32)
    mu = rng.uniform(-1, 1, b).astype(np.float32)
    u = rng.uniform(1e-7, 1 - 1e-7, b).astype(np.float32)
    return apf, row_e, mu, u, pt_p, pt_mu


@pytest.mark.cuda
@pytest.mark.parametrize('shape', [(1 << 17, 20, 2048, 2048),
                                   (4097, 3, 300, 500)],
                         ids=['B131072_20rows', 'B4097_ragged'])
def test_phase_pair_kernel_equals_plain(cuda, shape):
    rng = np.random.default_rng(0)
    args = [torch.from_numpy(a).to(cuda) for a in _lanes(rng, *shape)]
    before = phase_pair.launches
    pe, mn = phase_pair(*args)
    ref_pe, ref_mn = phase_pair_ref(*args)
    torch.cuda.synchronize()
    assert phase_pair.launches == before + 1
    assert torch.equal(pe, ref_pe) and torch.equal(mn, ref_mn)


def _broken_inputs():
    """The 32x32 broken-cloud scene of tests/test_torch_flight.py: the
    atmosphere, 4 g-points and the build_scene keywords."""
    levels = np.concatenate([np.arange(0, 3.0, 0.5), np.arange(3.0, 20.1, 1.0)])
    atm = atm_atmmod(levels)
    ab = abs_synthetic(650.0, atm, ng=4)
    cld = cld_gen_hem(nx=32, ny=32, nz=4, dx=0.2, dy=0.2, dz=0.5,
                      cloud_frac_tgt=0.3, radii=(0.4,), cot_scale=12.0,
                      cloud_base=0.5, seed=3)
    kw = dict(cld=cld, surface=0.05, solar_zenith_angle=30.0,
              solar_azimuth_angle=45.0, forward_trunc_deg=20.0)
    return atm, ab, kw


@pytest.mark.cuda
def test_flight_step_on_card_matches_cpu(cuda):
    """Four steps of the same carry and deviates on the card and on the
    CPU: continuous state to rtol 1e-4 / atol 1e-5 (coordinates on the
    domain's scale), discrete state on >= 99.9 % of lanes."""
    atm, ab, kw = _broken_inputs()
    rad_w = spectral_factors(ab, nz_out=1)[0][0]
    cfg = SolverConfig(target='radiance', batch=4096, n_scat_max=300,
                       tile_size=16, qmc_launch=True)
    kerns = {d: mc_flight.FlightKernel(
        *build_scene(atm, ab, **kw, device=d), cfg, 60000, rad_w=rad_w)
        for d in ('cpu', cuda)}
    rng = np.random.default_rng(1)
    c = kerns['cpu'].carry0(4096)
    scale = {'x': 6400.0, 'y': 6400.0, 'z': 20000.0}
    for k in range(4):
        u = torch.from_numpy(rng.uniform(1e-7, 1 - 1e-7, (14, 4096))
                             .astype(np.float32))
        ref = kerns['cpu'].step(c._replace(rad=c.rad.clone()), u, 7)
        on = mc_flight.FlightCarry(*[
            v.to(cuda) if isinstance(v, torch.Tensor) else v for v in c])
        got = kerns[cuda].step(on, u.to(cuda), 7)
        for f in ('x', 'y', 'z'):
            d = (getattr(got, f).cpu() - getattr(ref, f)).abs()
            if f != 'z':
                d = torch.minimum(d, scale[f] - d)
            assert float(d.max()) <= 1e-5 * scale[f], (k, f)
        for f in ('ux', 'uy', 'uz', 'wsc', 'labs', 'tau', 'plen'):
            np.testing.assert_allclose(getattr(got, f).cpu().numpy(),
                                       getattr(ref, f).numpy(),
                                       rtol=1e-4, atol=1e-5)
        for f in ('alive', 'nscat', 'direct', 'ix0', 'iy0'):
            same = (getattr(got, f).cpu() == getattr(ref, f)).float().mean()
            assert float(same) >= 0.999, (k, f)
        assert int(got.launched) == int(ref.launched)
        # the deposit is index_add_: atomics in a varying order on the card
        assert float(got.rad.sum()) == pytest.approx(float(ref.rad.sum()),
                                                     rel=1e-4)
        c = ref


@pytest.mark.cuda
@pytest.mark.parametrize('per_col', [True, False],
                         ids=['kx4_flux_w', 'domain_absorbed'])
def test_flux_step_on_card_matches_cpu(cuda, per_col):
    """The flux branch: four steps of one carry and deviates on the card
    and on the CPU; lane state as above, tallies (index_add_ and sums,
    in another order on the card) to 1e-4 of their totals, and one phase
    pair launch per step."""
    atm, ab, kw = _broken_inputs()
    cfg = SolverConfig(target='flux', batch=4096, n_scat_max=300,
                       tile_size=16, qmc_launch=True, flux_per_column=per_col)
    flux_w = spectral_factors(ab, nz_out=len(atm.lev.altitude))[0]
    kerns = {d: mc_flight.FlightKernel(
        *build_scene(atm, ab, **kw, device=d), cfg, 60000, flux_w=flux_w)
        for d in ('cpu', cuda)}
    rng = np.random.default_rng(2)
    c = kerns['cpu'].carry0(4096)
    for k in range(4):
        u = torch.from_numpy(rng.uniform(1e-7, 1 - 1e-7, (14, 4096))
                             .astype(np.float32))
        on = mc_flight.FlightCarry(*[
            v.to(cuda) if isinstance(v, torch.Tensor) else v for v in c])
        before = phase_pair.launches
        got = kerns[cuda].step(on, u.to(cuda), 7)
        assert phase_pair.launches == before + 1
        ref = kerns['cpu'].step(c, u, 7)        # tallies grow in place
        for f in ('ux', 'uy', 'uz', 'wsc', 'labs', 'tau', 'plen'):
            np.testing.assert_allclose(getattr(got, f).cpu().numpy(),
                                       getattr(ref, f).numpy(),
                                       rtol=1e-4, atol=1e-5)
        for f in ('alive', 'nscat', 'direct'):
            same = (getattr(got, f).cpu() == getattr(ref, f)).float().mean()
            assert float(same) >= 0.999, (k, f)
        for f in ('flux', 'absorbed'):
            assert float(getattr(got, f).double().sum()) == pytest.approx(
                float(getattr(ref, f).double().sum()), rel=1e-4), (k, f)
        c = ref
    assert float(c.flux.sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize('kw', [dict(target='radiance'),
                                dict(target='radiance', sensor_zenith=30.0),
                                dict(target='flux', flux_per_column=True)],
                         ids=['radiance', 'radiance_slant', 'flux_column'])
def test_march_step_on_card_matches_cpu(cuda, kw):
    """The marching engine: six steps of one carry and deviates on the card
    and on the CPU; lane state as in the flight tests, tallies to 1e-4 of
    their totals, and one phase pair launch per step."""
    atm, ab, scene_kw = _broken_inputs()
    cfg = SolverConfig(batch=4096, n_scat_max=300, **kw)
    kerns = {d: mc.MarchingKernel(*build_scene(atm, ab, **scene_kw, device=d),
                                  cfg, 60000) for d in ('cpu', cuda)}
    rng = np.random.default_rng(3)
    c = kerns['cpu'].carry0(4096)
    for k in range(6):
        u = torch.from_numpy(rng.uniform(1e-7, 1 - 1e-7, (9, 4096))
                             .astype(np.float32))
        on = mc.MarchingCarry(*[
            v.to(cuda) if isinstance(v, torch.Tensor) else v for v in c])
        before = phase_pair.launches
        got = kerns[cuda].step(on, u.to(cuda))
        assert phase_pair.launches == before + 1
        ref = kerns['cpu'].step(c, u)           # tallies grow in place
        for f in ('z', 'ux', 'uy', 'uz', 'wsc', 'tau', 'S'):
            np.testing.assert_allclose(getattr(got, f).cpu().numpy(),
                                       getattr(ref, f).numpy(),
                                       rtol=1e-4, atol=1e-5)
        for f in ('alive', 'nscat', 'direct', 'l'):
            same = (getattr(got, f).cpu() == getattr(ref, f)).float().mean()
            assert float(same) >= 0.999, (k, f)
        for f in ('rad', 'flux'):
            assert float(getattr(got, f).double().sum()) == pytest.approx(
                float(getattr(ref, f).double().sum()), rel=1e-4), (k, f)
        c = ref
    tally = c.rad if kw['target'] == 'radiance' else c.flux
    assert float(tally.sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize('cam', [dict(cam_zloc=0.0, cam_qmax=80.0),
                                 dict(cam_zloc=8000.0, cam_the=180.0,
                                      cam_qmax=60.0)],
                         ids=['ground', 'airborne'])
def test_quasi_on_card_matches_cpu(cuda, cam):
    """The quasi-radiance image on the card and on the CPU: the same NaN
    mask, and every finite pixel within 1e-4 relative."""
    atm, ab, scene_kw = _broken_inputs()
    cfg = SolverConfig(sensor_type='camera', cam_npix=32, **cam)
    img = {d: quasi_radiance(*build_scene(atm, ab, **scene_kw, device=d), cfg,
                             n_steps=128, device=d).cpu().numpy()
           for d in ('cpu', cuda)}
    np.testing.assert_array_equal(np.isnan(img[cuda]), np.isnan(img['cpu']))
    fin = np.isfinite(img['cpu'])
    assert fin.sum() > 400
    np.testing.assert_allclose(img[cuda][fin], img['cpu'][fin], rtol=1e-4)


CARD_MODES = {
    'ipa': dict(target='radiance'),
    'p3d': dict(target='radiance', p3d_order=1),
    'camera_air_pathlength': dict(
        target='radiance', sensor_type='camera', cam_zloc=8000.0,
        cam_the=180.0, cam_qmax=60.0, cam_npix=16, cam_apsize=50.0,
        pathlength=True),
    'camera_importance': dict(target='radiance', sensor_type='camera',
                              cam_npix=16, cam_importance_sigma=500.0),
    'split_rr_value': dict(target='radiance', split_wmax=0.5, rr_value=0.1),
    'cf_dtau_kx0': dict(target='flux', flux_per_column=True, flux_kcross=0,
                        cf_dtau=2.0),
}


@pytest.mark.cuda
@pytest.mark.parametrize('mode', list(CARD_MODES))
def test_mode_step_on_card_matches_cpu(cuda, mode):
    """The solvers, sensors and knobs of the flight step: four steps of one
    carry and deviates (the splitting and importance substreams included)
    on the card and on the CPU; lane state as above (coordinates also to
    4e-5 of a forced flight), tallies to 1e-4 of their totals, and one
    phase pair launch per step."""
    atm, ab, kw = _broken_inputs()
    cfg = SolverConfig(batch=4096, n_scat_max=300, tile_size=16,
                       qmc_launch=True, **CARD_MODES[mode])
    kerns = {}
    for d in ('cpu', cuda):
        scene, st = build_scene(atm, ab, **kw, device=d)
        if mode == 'ipa':
            st = dataclasses.replace(st, ipa=True)
        kerns[d] = mc_flight.FlightKernel(scene, st, cfg, 60000)
    rng = np.random.default_rng(3)
    c = kerns['cpu'].carry0(4096)
    scale = {'x': 6400.0, 'y': 6400.0, 'z': 20000.0}
    for k in range(4):
        u = torch.from_numpy(rng.uniform(1e-7, 1 - 1e-7, (18, 4096))
                             .astype(np.float32))
        extra = dict(u_split=u[14].contiguous(), u_imp=u[15:].contiguous())
        on = mc_flight.FlightCarry(*[
            v.to(cuda) if isinstance(v, torch.Tensor) else v for v in c])
        before = phase_pair.launches
        got = kerns[cuda].step(on, u[:14].to(cuda), 7,
                               **{n: t.to(cuda) for n, t in extra.items()})
        assert phase_pair.launches == before + 1
        ref = kerns['cpu'].step(c, u[:14], 7, **extra)   # tallies grow in place
        flight = (ref.plen - c.plen).abs()
        for f in ('x', 'y', 'z'):
            d = (getattr(got, f).cpu() - getattr(ref, f)).abs()
            if f != 'z':
                d = torch.minimum(d, scale[f] - d)
            assert bool((d <= torch.clamp(4e-5 * flight,
                                          min=1e-5 * scale[f])).all()), (k, f)
        for f in ('ux', 'uy', 'uz', 'wsc', 'labs', 'tau', 'plen'):
            np.testing.assert_allclose(getattr(got, f).cpu().numpy(),
                                       getattr(ref, f).numpy(),
                                       rtol=1e-4, atol=1e-5)
        for f in ('alive', 'nscat', 'direct', 'ix0', 'iy0'):
            same = (getattr(got, f).cpu() == getattr(ref, f)).float().mean()
            assert float(same) >= 0.999, (k, f)
        assert int(got.launched) == int(ref.launched)
        for f in ('rad', 'rad_pl', 'flux', 'absorbed'):
            assert float(getattr(got, f).double().sum()) == pytest.approx(
                float(getattr(ref, f).double().sum()), rel=1e-4), (k, f)
        c = ref
    assert float(c.rad.sum() + c.flux.sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize('wvl', [650.0, 1600.0])
def test_phase_pair_at_the_lut_tables(cuda, wvl):
    """K1 on the phase tables of the bispectral LUT's IPA scene
    (apps.lut at its default grids: the Mie rows of its 11 CER nodes, at
    650 and at 1600 nm), bitwise against its plain version on 2^17 lanes
    spread over every row and bin."""
    from er3t_tpu_torch.apps.lut import _grid_cloud
    atm = atm_atmmod(np.linspace(0, 20, 21))
    cld = _grid_cloud(np.concatenate([[0.0], np.logspace(-1, 2, 24)]),
                      np.arange(4.0, 25.1, 2.0))
    scene, _ = build_scene(atm, abs_synthetic(wvl, atm), cld=cld,
                           pha=pha_mie_wc(wvl), surface=0.03,
                           solar_zenith_angle=30.0, ipa=True, device=cuda)
    npf = scene.pt_mu.shape[0]
    assert scene.pt_p.shape[0] == 2 * npf and npf >= 12
    rng = np.random.default_rng(int(wvl))
    b = 1 << 17
    apf = rng.integers(0, npf, b).astype(np.int32)
    row_e = (apf + np.where(rng.integers(0, 2, b) > 0, npf, 0)).astype(
        np.int32)
    lanes = [torch.from_numpy(x).to(cuda) for x in (
        apf, row_e, rng.uniform(-1, 1, b).astype(np.float32),
        rng.uniform(1e-7, 1 - 1e-7, b).astype(np.float32))]
    before = phase_pair.launches
    pe, mn = phase_pair(*lanes, scene.pt_p, scene.pt_mu)
    ref_pe, ref_mn = phase_pair_ref(*lanes, scene.pt_p, scene.pt_mu)
    torch.cuda.synchronize()
    assert phase_pair.launches == before + 1
    assert torch.equal(pe, ref_pe) and torch.equal(mn, ref_mn)


@pytest.mark.cuda
def test_phase_pair_at_the_ahi_tables(cuda, tmp_path):
    """K1 on the phase tables of phase 11's scene (projects/03 on the AHI
    granule of chip_smoke_files: the 532-nm Mie rows of its cloud),
    bitwise against its plain version on 2^17 lanes spread over every row
    and bin."""
    import chip_smoke_files
    fname = chip_smoke_files.write_ahi_clp(str(tmp_path / 'ahi_clp.nc'),
                                           seed=0)
    atm, ab, cld, pha, _ = chip_smoke.sat_scene(fname, chip_smoke.SAT_NX)
    scene, _ = build_scene(atm, ab, cld=cld, pha=pha, surface=0.06,
                           solar_zenith_angle=chip_smoke.SAT_SZA,
                           solar_azimuth_angle=chip_smoke.SAT_SAA,
                           device=cuda)
    npf = scene.pt_mu.shape[0]
    assert scene.pt_p.shape[0] == 2 * npf and npf >= 2
    rng = np.random.default_rng(532)
    b = 1 << 17
    apf = rng.integers(0, npf, b).astype(np.int32)
    row_e = (apf + np.where(rng.integers(0, 2, b) > 0, npf, 0)).astype(
        np.int32)
    lanes = [torch.from_numpy(x).to(cuda) for x in (
        apf, row_e, rng.uniform(-1, 1, b).astype(np.float32),
        rng.uniform(1e-7, 1 - 1e-7, b).astype(np.float32))]
    before = phase_pair.launches
    pe, mn = phase_pair(*lanes, scene.pt_p, scene.pt_mu)
    ref_pe, ref_mn = phase_pair_ref(*lanes, scene.pt_p, scene.pt_mu)
    torch.cuda.synchronize()
    assert phase_pair.launches == before + 1
    assert torch.equal(pe, ref_pe) and torch.equal(mn, ref_mn)


@pytest.mark.cuda
@pytest.mark.parametrize('b', [1 << 17, 100_003], ids=['B131072', 'B100003'])
def test_phase_pair_bf16_kernel_equals_plain(cuda, b):
    """The bf16 instance (K7/K8 make_pair) at the probe scripts' tables:
    bitwise equal to pt.to(bfloat16)[row, bin].float()."""
    rng = np.random.default_rng(4)
    a = [torch.from_numpy(x).to(cuda)
         for x in _lanes(rng, b, 20, 4096, 8192)]
    a[4], a[5] = a[4].to(torch.bfloat16), a[5].to(torch.bfloat16)
    before = (phase_pair.launches, phase_pair.launches_bf16)
    pe, mn = phase_pair(*a)
    torch.cuda.synchronize()
    assert (phase_pair.launches, phase_pair.launches_bf16) == \
        (before[0], before[1] + 1)
    ib = ((((a[2] + 1.0) * 0.5) * 4095 + 0.5).to(torch.int32)).clamp(0, 4095)
    iu = ((a[3] * 8191 + 0.5).to(torch.int32)).clamp(0, 8191)
    assert torch.equal(pe, a[4][a[1].long(), ib.long()].float())
    assert torch.equal(mn, a[5][a[0].long(), iu.long()].float())


def _probe_case(case, b, rng):
    """(wrapper, plain version, numpy arguments) of a probe kernel case at
    the TPU probe scripts' shapes, b lanes."""
    def idx(hi, *shape):
        return rng.integers(0, hi, shape or (b,)).astype(np.int32)

    def tab(*shape):
        return rng.normal(size=shape).astype(np.float32)

    g = gather
    return {
        'take_reps_61440x1_r4': (g.take_reps, g.take_reps_ref,
                                 (idx(61440), tab(61440, 1), 4)),
        'take_reps_1Mx1_r1': (g.take_reps, g.take_reps_ref,
                              (idx(1 << 20), tab(1 << 20, 1), 1)),
        'row_sum_921600x2': (g.gather_row_sum, g.gather_row_sum_ref,
                             (idx(921600), tab(921600, 2))),
        'row_sum_512x128': (g.gather_row_sum, g.gather_row_sum_ref,
                            (idx(512), tab(512, 128))),
        'take2d_rows_4096x128': (g.take2d, g.take2d_ref,
                                 (idx(4096), tab(4096, 128), 'rows')),
        'take2d_axis0_4096x8': (g.take2d, g.take2d_ref,
                                (idx(4096, b, 8), tab(4096, 8), 'axis0')),
        'take2d_axis1_1024': (g.take2d, g.take2d_ref,
                              (idx(1024, b // 64, 128), tab(b // 64, 1024),
                               'axis1')),
    }[case]


@pytest.mark.cuda
@pytest.mark.parametrize('b', [1 << 17, 100_003], ids=['B131072', 'B100003'])
@pytest.mark.parametrize('case', [
    'take_reps_61440x1_r4', 'take_reps_1Mx1_r1', 'row_sum_921600x2',
    'row_sum_512x128', 'take2d_rows_4096x128', 'take2d_axis0_4096x8',
    'take2d_axis1_1024'])
def test_probe_kernel_equals_plain(cuda, case, b):
    fn, ref, args = _probe_case(case, b, np.random.default_rng(5))
    args = [torch.from_numpy(a).to(cuda) if isinstance(a, np.ndarray) else a
            for a in args]
    before = fn.launches
    out = fn(*args)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert torch.equal(out, ref(*args))


def _take2d_case(k):
    """Case k of chip_smoke's take2d cases, on the card (RAGGED = 100003):
    its mode and its table and index views."""
    _, mode, tab, idx, (lo, hi), t_off, i_off = chip_smoke.take2d_cases()[k]
    rng = np.random.default_rng(11 + k)
    t = torch.from_numpy(rng.normal(size=int(np.prod(tab)) + t_off)
                         .astype(np.float32)).cuda()[t_off:].view(tab)
    i = torch.from_numpy(rng.integers(lo, hi, int(np.prod(idx)) + i_off)
                         .astype(np.int32)).cuda()[i_off:].view(idx)
    return mode, t, i


TAKE2D_IDS = ['{1}_tab{2[0]}x{2[1]}_idx{3}_range{4[0]},{4[1]}_off{5}{6}'
              .format(*c).replace(' ', '') for c in chip_smoke.take2d_cases()]


@pytest.mark.cuda
@pytest.mark.parametrize('k', range(len(TAKE2D_IDS)), ids=TAKE2D_IDS)
def test_take2d_equals_plain_on_every_path(cuda, k):
    """Every path of gather.take2d_vec (rows and axis1 with one or four
    outputs a chunk, axis0 with one), ragged row counts and widths, rows
    wider than a block, views off 16-byte alignment, indices out of range
    at both ends: bitwise equal to the plain version."""
    mode, t, i = _take2d_case(k)
    before = gather.take2d.launches
    out = gather.take2d(i, t, mode)
    torch.cuda.synchronize()
    assert gather.take2d.launches == before + 1
    assert torch.equal(out, gather.take2d_ref(i, t, mode))


@pytest.mark.cuda
@pytest.mark.parametrize('vec', [1, 4])
@pytest.mark.parametrize('mode', ['rows', 'axis1'])
def test_take2d_vector_widths_equal_plain_at_k6(cuda, mode, vec):
    """One and four outputs a chunk, forced past the wrapper's rule, at
    K6's shapes (rows: its table's rows, all 1024 columns)."""
    rng = np.random.default_rng(12)
    t = torch.from_numpy(rng.normal(size=(2048, 1024)).astype(np.float32))
    shape = (2048, 128) if mode == 'axis1' else (2048,)
    hi = 1024 if mode == 'axis1' else 2048
    i = torch.from_numpy(rng.integers(-3, hi + 3, shape).astype(np.int32))
    t, i = t.to(cuda), i.to(cuda)
    out = gather.take2d(i, t, mode, _vec=vec)
    torch.cuda.synchronize()
    assert torch.equal(out, gather.take2d_ref(i, t, mode))


@pytest.mark.cuda
@pytest.mark.parametrize('mode,vec,tab_off,idx_off', [
    ('rows', 4, 1, 0), ('axis1', 4, 0, 1), ('axis0', 4, 0, 0),
    ('axis1', 2, 0, 0)],
    ids=['rows_vec4_misaligned_tab', 'axis1_vec4_misaligned_idx',
         'axis0_vec4', 'vec2'])
def test_take2d_entry_refuses_a_plan_that_does_not_hold(
        cuda, mode, vec, tab_off, idx_off):
    """The C entry returns an error, and launches nothing, for a vector
    width that the mode or the alignment does not allow."""
    t = torch.zeros(1024 * 128 + tab_off, device=cuda)[tab_off:].view(1024,
                                                                      128)
    i = torch.zeros(1024 * 128 + idx_off, dtype=torch.int32,
                    device=cuda)[idx_off:].view(1024, 128)
    out = torch.empty(1024, 128, device=cuda)
    with pytest.raises(CudaError):
        launch('take2d', cuda, i.data_ptr(), t.data_ptr(), out.data_ptr(),
               gather.TAKE2D_MODES.index(mode), 1024, 128, 1024, 128, vec)


ROW_WIDTHS = [1, 2, 3, 5, 31, 32, 33, 64, 100, 128, 200, 1024]


def _row_sum_launch_equals_plain(idx, tab, lanes=None):
    before = gather.gather_row_sum.launches
    out = gather.gather_row_sum(idx, tab, lanes)
    torch.cuda.synchronize()
    assert gather.gather_row_sum.launches == before + 1
    assert torch.equal(out, gather.gather_row_sum_ref(idx, tab, lanes)), lanes


@pytest.mark.cuda
@pytest.mark.parametrize('b', [1 << 17, 100_003], ids=['B131072', 'B100003'])
@pytest.mark.parametrize('width', ROW_WIDTHS)
def test_gather_row_sum_equals_plain_at_every_width(cuda, width, b):
    """The lanes the wrapper picks for the width (one thread a row up to
    width 4, a group of up to 8 above), indices a few rows out of range at
    both ends."""
    rng = np.random.default_rng(7)
    rows = max(64, (1 << 22) // width)
    tab = torch.from_numpy(rng.normal(size=(rows, width)).astype(np.float32))
    idx = rng.integers(-3, rows + 3, b).astype(np.int32)
    _row_sum_launch_equals_plain(torch.from_numpy(idx).to(cuda), tab.to(cuda))


@pytest.mark.cuda
@pytest.mark.parametrize('width,offset', [(3, 3), (5, 5), (33, 33), (2, 1),
                                          (4, 1), (100, 2), (128, 1),
                                          (128, 2)])
def test_gather_row_sum_on_a_misaligned_table(cuda, width, offset):
    """A table view ``offset`` floats into its allocation (one row in at
    odd widths), so its row starts leave 16-byte alignment: scalar or
    float2 loads in every lane group, the same sums as the plain
    version."""
    rng = np.random.default_rng(8)
    rows = 4096
    flat = torch.from_numpy(rng.normal(size=rows * width + offset)
                            .astype(np.float32)).to(cuda)
    tab = flat[offset:].view(rows, width)
    assert tab.data_ptr() % 16
    idx = torch.from_numpy(rng.integers(0, rows, 100_003).astype(np.int32))
    for lanes in gather.ROW_SUM_LANES:
        _row_sum_launch_equals_plain(idx.to(cuda), tab, lanes)


@pytest.mark.cuda
@pytest.mark.parametrize('width', [5, 128, 130])
def test_gather_row_sum_equals_plain_at_every_lane_count(cuda, width):
    rng = np.random.default_rng(9)
    tab = torch.from_numpy(rng.normal(size=(921, width)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, 921, 1 << 17).astype(np.int32))
    for lanes in gather.ROW_SUM_LANES:
        _row_sum_launch_equals_plain(idx.to(cuda), tab.to(cuda), lanes)


@pytest.mark.cuda
def test_gather_row_sum_entry_refuses_a_bad_lane_count(cuda):
    """The C entry returns an error for a group size it has no kernel for
    (not a power of two, or above 8), and the launch raises it."""
    idx = torch.zeros(64, dtype=torch.int32, device=cuda)
    tab = torch.zeros(4, 128, device=cuda)
    out = torch.empty(64, device=cuda)
    for lanes in (3, 16, 32):
        with pytest.raises(CudaError):
            launch('gather_row_sum', cuda, idx.data_ptr(), tab.data_ptr(),
                   out.data_ptr(), 64, 4, 128, lanes)


@pytest.mark.cuda
@pytest.mark.parametrize('width', [1, 3])
@pytest.mark.parametrize('reps', range(1, 9))
def test_take_reps_windows_equal_plain(cuda, reps, width):
    """Every base residue mod 4, negative indices and indices past the
    table (floor modulo), windows that wrap past the last row, a ragged
    lane count; then the same on an index view and a table view one
    element off 16-byte alignment."""
    rng = np.random.default_rng(10)
    rows, b = 6147, 100_003
    idx = rng.integers(-2 * rows, 2 * rows, b + 1)
    idx[:4096] = rows - 1 - np.arange(4096) % 12
    assert set(np.mod(idx, 4)) == {0, 1, 2, 3}
    idx = torch.from_numpy(idx.astype(np.int32)).to(cuda)
    flat = torch.from_numpy(rng.normal(size=rows * width + 1)
                            .astype(np.float32)).to(cuda)
    for i, t in ((idx[:b], flat[:-1].view(rows, width)),
                 (idx[1:], flat[:-1].view(rows, width)),
                 (idx[:b], flat[1:].view(rows, width))):
        before = gather.take_reps.launches
        out = gather.take_reps(i, t, reps)
        torch.cuda.synchronize()
        assert gather.take_reps.launches == before + 1
        assert torch.equal(out, gather.take_reps_ref(i, t, reps))


@pytest.mark.cuda
def test_smem_stage_holds_the_optin_limit_and_is_refused_above(cuda):
    limit = torch.cuda.get_device_properties(
        cuda).shared_memory_per_block_optin
    tab = torch.randn(limit // 4, device=cuda)
    assert torch.equal(gather.smem_stage(tab), gather.smem_stage_ref(tab))
    before = gather.smem_stage.launches
    with pytest.raises(CudaError) as err:
        gather.smem_stage(torch.randn(limit // 4 + 1, device=cuda))
    assert err.value.code != 0 and gather.smem_stage.launches == before
    # the refusal is cleared: later launches of the process still work
    assert float(torch.ones(3, device=cuda).sum()) == 3.0
    assert torch.equal(gather.smem_stage(tab[:12345]),
                       gather.smem_stage_ref(tab[:12345]))


@pytest.mark.cuda
def test_smem_stage_refuses_a_misaligned_table(cuda):
    """The bulk copy needs a 16-byte aligned table: a view one float in
    raises before any launch, and never takes another path."""
    tab = torch.randn(4096, device=cuda)
    before = gather.smem_stage.launches
    with pytest.raises(ValueError, match='16-byte'):
        gather.smem_stage(tab[1:])
    assert gather.smem_stage.launches == before
    assert torch.equal(gather.smem_stage(tab[4:]),
                       gather.smem_stage_ref(tab[4:]))


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
@pytest.mark.parametrize('b,offset', [(1 << 17, 0), (100_003, 0),
                                      (1 << 17, 1), (100_003, 3)],
                         ids=['B131072', 'B100003', 'B131072_misaligned',
                              'B100003_misaligned'])
def test_phase_pair_instances_equal_plain(cuda, dtype, b, offset):
    """Both instances at B = 2^17, with a ragged last block, and on lane
    arrays off 16-byte alignment: bitwise equal to the plain version."""
    rng = np.random.default_rng(6)
    a = [torch.from_numpy(x).to(cuda)
         for x in _lanes(rng, b + offset, 20, 2048, 2048)]
    a = [t[offset:] for t in a[:4]] + [a[4].to(dtype), a[5].to(dtype)]
    assert offset == 0 or a[0].data_ptr() % 16
    pe, mn = phase_pair(*a)
    ref_pe, ref_mn = phase_pair_ref(*a)
    torch.cuda.synchronize()
    assert torch.equal(pe, ref_pe) and torch.equal(mn, ref_mn)


@pytest.mark.cuda
def test_device_ms_of_the_launch_floor_is_finite_and_positive(cuda):
    for per_launch in (False, True):
        ms = device_ms(lambda: gather.noop(cuda), per_launch=per_launch)
        assert np.isfinite(ms) and 0 < ms < 1.0


def _ring_carry(rng, b, dev, ng=4, dead=0.3):
    """Random lanes on a ring of 4 slabs of width 1 (x in [0, 4)), a third
    above the deck top z = 2, each with a distinct wsc."""
    def f(*shape):
        return torch.from_numpy(rng.uniform(-1, 1, shape)
                                .astype(np.float32)).to(dev)
    return mc_flight.FlightCarry(
        x=torch.from_numpy(rng.uniform(0, 4, b).astype(np.float32)).to(dev),
        y=f(b), z=torch.from_numpy(rng.uniform(0, 3, b)
                                   .astype(np.float32)).to(dev),
        ux=f(b), uy=f(b), uz=f(b),
        wsc=torch.from_numpy(rng.permutation(b).astype(np.float32)).to(dev),
        labs=f(ng + 1, b), tau=f(b),
        nscat=torch.from_numpy(rng.integers(0, 2 ** 30, b, dtype=np.int32)
                               ).to(dev),
        alive=torch.from_numpy(rng.uniform(size=b) >= dead).to(dev),
        ix0=torch.from_numpy(rng.integers(2 ** 24, 2 ** 30, b,
                                          dtype=np.int32)).to(dev),
        iy0=torch.from_numpy(rng.integers(0, 2 ** 30, b, dtype=np.int32)
                             ).to(dev),
        plen=f(b), direct=torch.from_numpy(rng.uniform(size=b) < 0.5).to(dev),
        launched=torch.tensor(0, device=dev), step=0,
        rad=torch.zeros(1, device=dev), rad_pl=torch.zeros(1, device=dev),
        flux=torch.zeros(1, device=dev), absorbed=torch.zeros(1, device=dev))


def _alive_rows(c):
    m, _ = mc_flight.lane_matrix(c)
    return sorted(bytes(r) for r in m[c.alive].cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize('dead', [0.3, 0.97], ids=['busy', 'drain'])
def test_migration_conserves_photons_on_the_card(cuda, dead):
    """Two swaps (right, then left) on a ring of 4 ranks on cuda:0, B =
    2^17, window B / 4: the alive lanes over all ranks are the same
    multiset of packed rows (on the card the winner of duplicate scatter
    indices is undefined: no clone, no loss), lanes shipped."""
    from er3t_tpu_torch.dist.decomp import migrate_dir
    from er3t_tpu_torch.dist.mesh import make_mesh
    rng = np.random.default_rng(4)
    b = 1 << 17
    mesh = make_mesh(4, device=[cuda] * 4)
    cs = [_ring_carry(rng, b, cuda, dead=dead) for _ in range(4)]
    before = sorted(sum((_alive_rows(c) for c in cs), []))
    counts = [[0, 0] for _ in cs]
    for right in (True, False):
        cs = migrate_dir(mesh, cs, b // 4, 1.0, 2.0, True, right, counts)
    assert sorted(sum((_alive_rows(c) for c in cs), [])) == before
    assert sum(int(n) for n, _ in counts) > 0


@pytest.mark.cuda
def test_slab_steps_and_decomposed_run_on_the_card(cuda):
    """Each slab of a ring of 4 over the 32x32 broken-cloud scene: four
    steps of one carry and deviates on the card and on the CPU (lane state
    as test_mode_step_on_card_matches_cpu holds it: coordinates to 4e-5
    of the step's flight, since the card's cumsum and matmul orders move
    where a clear-sky flight reaches its optical depth by a few ulps over
    a majorant of ~3e-6 /m; K1 once a step); then a decomposed run of the
    4 ranks on cuda:0 launches its budget exactly, below its round cap,
    with a finite image >= 0."""
    from er3t_tpu_torch.dist.decomp import shard_scene, transport_decomp
    from er3t_tpu_torch.dist.mesh import make_mesh
    atm, ab, kw = _broken_inputs()
    rad_w = spectral_factors(ab, nz_out=1)[0][0]
    cfg = SolverConfig(target='radiance', batch=4096, n_scat_max=300,
                       tile_size=3, qmc_launch=True)
    scenes = {d: build_scene(atm, ab, **kw, device=d) for d in ('cpu', cuda)}
    rng = np.random.default_rng(5)
    scale = {'x': 6400.0, 'y': 6400.0, 'z': 20000.0}
    for i in range(4):
        kerns = {}
        for d, (scene, st) in scenes.items():
            part, st_loc = shard_scene(scene, st, 4, i)
            kerns[d] = mc_flight.FlightKernel(
                part, st_loc, cfg, 60000, rad_w=rad_w,
                slab=mc_flight.SlabSpec(32, 8), x_off=i * 1600.0,
                spawn_reserve=512)
        c = kerns['cpu'].carry0(4096)
        for k in range(4):
            u = torch.from_numpy(rng.uniform(1e-7, 1 - 1e-7, (14, 4096))
                                 .astype(np.float32))
            on = mc_flight.FlightCarry(*[
                v.to(cuda) if isinstance(v, torch.Tensor) else v for v in c])
            before = phase_pair.launches
            got = kerns[cuda].step(on, u.to(cuda), 7)
            assert phase_pair.launches == before + 1
            ref = kerns['cpu'].step(c._replace(rad=c.rad.clone()), u, 7)
            flight = (ref.plen - c.plen).abs()
            for f in ('x', 'y', 'z'):
                d = (getattr(got, f).cpu() - getattr(ref, f)).abs()
                if f != 'z':
                    d = torch.minimum(d, scale[f] - d)
                assert bool((d <= torch.clamp(4e-5 * flight,
                                              min=1e-5 * scale[f])).all()), \
                    (i, k, f, float(d.max()))
            for f in ('ux', 'uy', 'uz', 'wsc', 'labs', 'tau', 'plen'):
                np.testing.assert_allclose(getattr(got, f).cpu().numpy(),
                                           getattr(ref, f).numpy(),
                                           rtol=1e-4, atol=1e-5)
            for f in ('alive', 'nscat', 'direct', 'ix0', 'iy0'):
                same = (getattr(got, f).cpu() == getattr(ref, f)).float()
                assert float(same.mean()) >= 0.999, (i, k, f)
            assert int(got.launched) == int(ref.launched)
            assert float(got.rad.sum()) == pytest.approx(
                float(ref.rad.sum()), rel=1e-4)
            c = ref
    scene, st = scenes[cuda]
    stats = {}
    tal = transport_decomp(scene, st, cfg, 40000,
                           make_mesh(4, device=[cuda] * 4), seed=3,
                           rad_w=rad_w, stats=stats)
    img = tal.rad.cpu().numpy()
    assert int(tal.n_launched) == 40000
    assert stats['rounds'] < stats['max_rounds'] and stats['shipped'] > 0
    assert img.shape == (32, 32, 1) and np.isfinite(img).all() \
        and (img >= 0).all() and img.sum() > 0


@pytest.mark.cuda
def test_nccl_world_of_one_sums_the_tallies(cuda):
    """init_distributed with explicit arguments (NCCL, world 1, a free
    localhost port): a photon-parallel run through the process group's
    all_reduce gives the tallies of the same rank run in this process."""
    import socket
    import torch.distributed as dist
    from er3t_tpu_torch.dist.mesh import init_distributed, make_mesh
    from er3t_tpu_torch.dist.photon import transport_photon_parallel
    atm, ab, kw = _broken_inputs()
    rad_w = spectral_factors(ab, nz_out=1)[0][0]
    scene, st = build_scene(atm, ab, **kw, device=cuda)
    cfg = SolverConfig(target='radiance', batch=4096, n_scat_max=300,
                       tile_size=16, qmc_launch=True)
    local = transport_photon_parallel(scene, st, cfg, 20000,
                                      make_mesh(1, device=[cuda]), seed=9,
                                      rad_w=rad_w)
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        port = s.getsockname()[1]
    init_distributed(f'tcp://127.0.0.1:{port}', world_size=1, rank=0,
                     device=cuda, timeout_s=60)
    try:
        assert dist.get_backend() == 'nccl'
        mesh = make_mesh(device=cuda)
        assert mesh.size == 1 and type(mesh.comm).__name__ == 'ProcessComm'
        tal = transport_photon_parallel(scene, st, cfg, 20000, mesh, seed=9,
                                        rad_w=rad_w)
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    assert int(tal.n_launched) == int(local.n_launched) == 20000
    assert int(tal.n_steps) == int(local.n_steps)
    assert float(tal.rad.sum()) == pytest.approx(float(local.rad.sum()),
                                                 rel=1e-5)

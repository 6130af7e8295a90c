"""Tests of the port that need an NVIDIA GPU (marker ``cuda``).

They skip where ``torch.cuda.is_available()`` is False.  This file imports
no JAX, so it also runs on a machine without it; tests/conftest.py does
import JAX, hence on such a machine:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from er3t_tpu_torch._build import CudaError, launch
from er3t_tpu_torch.pre.abs import abs_synthetic
from er3t_tpu_torch.pre.atm import atm_atmmod
from er3t_tpu_torch.pre.cld import cld_gen_hem
from er3t_tpu_torch.probes import gather
from er3t_tpu_torch.probes.gather_probe import device_ms
from er3t_tpu_torch.rtm import mc_flight
from er3t_tpu_torch.rtm.mc import SolverConfig
from er3t_tpu_torch.rtm.out import spectral_factors
from er3t_tpu_torch.rtm.phase_pair import phase_pair, phase_pair_ref
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

"""The post half of the flight step as one kernel (``csrc/flight_post.cu``),
on the CPU.

* The kernel's per-lane body (``csrc/flight_post.cuh``), built for the host
  with the host C++ compiler (``csrc/host_twin.cpp``), against the
  plain version ``FlightKernel._step_post``: four steps of the step-halves
  cases that the fused path covers (radiance with Mie and TMS rows and
  ``rad_w``, per-column flux with ``flux_w``, the heating rate's absorbed
  tally), and of two surface cases (Lambertian, Cox-Munk with whitecaps and
  LSRT columns mixed, by voxel column and on a coarser surface grid; the
  first seen from 30 degrees off nadir, with the sensor-importance
  roulette).  From one ``_Mid`` and K1 pair a step:
  the passed-through lanes bit for bit, the turned lanes to f32 tolerance,
  every discrete decision and counter equal, the tallies within rounding
  of their sums; the new lanes written over the inputs equal those written
  elsewhere.  A flight with the post half fused that way replays through
  the step-halves tests' stand-in capture bit for bit as it steps eagerly.
* The selection ``FlightKernel.fused_post``: never on the CPU; from the
  configuration alone (``flight_post.applies``, no device) for the five
  benchmark cells' kernels and refused for the modes that deposit
  elsewhere.
"""

import copy
import ctypes
import dataclasses
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from er3t_tpu_torch.pre.abs import abs_synthetic
from er3t_tpu_torch.pre.atm import atm_atmmod
from er3t_tpu_torch.pre.cld import cld_gen_hem
from er3t_tpu_torch.pre.sfc import Surface
from er3t_tpu_torch.rtm import domain_tally as dt_mod
from er3t_tpu_torch.rtm import flight_post, mc_flight
from er3t_tpu_torch.rtm.mc import SolverConfig
from er3t_tpu_torch.rtm.out import spectral_factors
from er3t_tpu_torch.rtm.phase_pair import phase_pair
from er3t_tpu_torch.rtm.scene import build_scene
from er3t_tpu_torch.util import trace

import test_torch_step_halves as halves

torch.set_num_threads(2)


CSRC = Path(flight_post.__file__).resolve().parents[1] / 'csrc'


@pytest.fixture(scope='module')
def host_twin(tmp_path_factory):
    """``csrc/host_twin.cpp`` (the kernels' per-lane bodies, lanes in
    order) built with the host C++ compiler: {'post': entry, 'tally':
    entry}, each an ``entry`` for ``flight_post.fused_post`` /
    ``domain_tally.domain_tally``; a skip where no compiler is found."""
    cxx = shutil.which('g++') or shutil.which('c++')
    if cxx is None:
        pytest.skip('the host build of csrc/*.cuh needs g++ or c++')
    lib = tmp_path_factory.mktemp('host_twin') / 'libhost_twin.so'
    subprocess.run([cxx, '-std=c++17', '-O2', '-ffp-contract=off', '-shared',
                    '-fPIC', '-o', str(lib), str(CSRC / 'host_twin.cpp')],
                   check=True, capture_output=True, text=True)
    so = ctypes.CDLL(str(lib))
    out = {}
    for key, name, args in (('post', 'flight_post', flight_post.PostArgs),
                            ('tally', 'domain_tally', dt_mod.TallyArgs)):
        fn = getattr(so, f'er3t_{name}')
        size = getattr(so, f'er3t_{name}_args_size')
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        size.argtypes = [ctypes.c_void_p]
        fn.restype = size.restype = ctypes.c_int
        assert size(None) == ctypes.sizeof(args), name

        def entry(a, fn=fn):
            assert fn(ctypes.addressof(a), None) == 0
        out[key] = entry
    out['lib'] = so
    return out


@pytest.fixture(scope='module')
def host_post(host_twin):
    return host_twin['post']


_SFC = {}


def surface_scene(grid):
    """A 12 x 12 broken-cloud scene (HG phase function, two g-points) over
    a bright mixed surface: Lambertian, Cox-Munk with a 30 % whitecap
    fraction and LSRT, per voxel column (``grid`` 12) or on a 4 x 6 grid
    of its own."""
    if grid not in _SFC:
        atm = atm_atmmod(np.array([0.0, 0.5, 1.0, 1.5, 3.0, 6.0, 10.0,
                                   20.0]))
        ab = abs_synthetic(650.0, atm, ng=2)
        cld = cld_gen_hem(nx=12, ny=12, nz=2, dx=0.2, dy=0.2, dz=0.5,
                          cloud_frac_tgt=0.2, radii=(0.3,), cot_scale=6.0,
                          cloud_base=0.5, seed=3)
        nx, ny = (12, 12) if grid == 12 else (4, 6)
        kind = np.arange(nx * ny).reshape(nx, ny) % 3
        jsfc = np.choose(kind, [1, 2, 4]).astype(np.int32)
        psfc = np.zeros((nx, ny, 5))
        psfc[kind == 0, 0] = 0.4
        psfc[kind == 1] = [0.3, 0.3, 1.34, 0.0, 0.03]
        psfc[kind == 2, :3] = [0.3, 0.05, 0.1]
        sc, st = build_scene(atm, ab, cld=cld, surface=Surface(jsfc, psfc),
                             solar_zenith_angle=40.0,
                             solar_azimuth_angle=30.0, device='cpu')
        _SFC[grid] = (sc, st, spectral_factors(ab, nz_out=1)[0][0])
    return _SFC[grid]


CASES = ('radiance_mie_rad_w', 'flux_kx4_flux_w', 'heating_rate',
         'surface_by_column_rr_value', 'surface_grid')


def kernels(case):
    """Two kernels of ``case`` (each with its own counters): the plain
    side's and the fused side's."""
    if case in halves.CASES:
        return halves.kernel(case), halves.kernel(case)
    sc, st, rad_w = surface_scene(12 if case.startswith('surface_by') else 4)
    # a slant sensor (30 degrees off nadir) for the sensor-importance case
    rr = case.endswith('rr_value')
    cfg = SolverConfig(**halves.BASE, target='radiance',
                       rr_value=3.0 if rr else 0.0,
                       sensor_zenith=30.0 if rr else 0.0,
                       sensor_azimuth=60.0)
    out = []
    for _ in range(2):
        k = mc_flight.FlightKernel(sc, st, cfg, 1500, rad_w=rad_w)
        k.outcome = torch.zeros(len(mc_flight.OUTCOMES), dtype=torch.int64)
        k.sfc_branch = torch.zeros(len(mc_flight.SFC_BRANCHES),
                                   dtype=torch.int64)
        k.tile_stops = torch.zeros(2, dtype=torch.int64)
        out.append(k)
    return out


def _assert_same_post(got, ref, k, case):
    for f in ('x', 'y', 'z', 'labs', 'plen', 'ix0', 'iy0', 'launched'):
        assert torch.equal(getattr(got, f), getattr(ref, f)), (case, k, f)
    # decisions: the twin and the plain version take the same branch on
    # every lane (deviates in [1e-7, 1 - 1e-7] lie far from the thresholds
    # at these lane counts)
    for f in ('alive', 'nscat', 'direct'):
        assert torch.equal(getattr(got, f), getattr(ref, f)), (case, k, f)
    # f32: libm's transcendentals against PyTorch's differ by an ulp or
    # two; rotate's normalisation and the roulette's division carry them
    for f in ('ux', 'uy', 'uz', 'wsc', 'tau'):
        torch.testing.assert_close(getattr(got, f), getattr(ref, f),
                                   rtol=1e-5, atol=1e-6, msg=f'{case} {k} {f}')


@pytest.mark.parametrize('case', CASES)
def test_host_build_of_the_kernel_equals_the_plain_post_half(case,
                                                             host_post):
    kp, kf = kernels(case)
    assert flight_post.applies(kp) and not kp.fused_post
    c = kp.carry0(halves.B)
    rad_f, ab_f = c.rad.clone(), c.absorbed.clone()
    hits = 0
    for k, u in enumerate(halves.deviates(
            case if case in halves.CASES else 'radiance_mie_rad_w')):
        k1, mid = kp._step_pre(c, u, 7)
        pair = phase_pair(*k1)
        # the fused side starts from the plain side's tallies before the
        # post half (the first half deposits the flux and gas absorption)
        rad_f.copy_(c.rad)
        ab_f.copy_(c.absorbed)
        mid_f = mid._replace(c=mid.c._replace(rad=rad_f, absorbed=ab_f))
        if k % 2:
            # the new lanes written over the inputs, as the replay may
            lanes = {f: getattr(mid_f, f).clone()
                     for f in flight_post._OUT}
            mid_f = mid_f._replace(**lanes)
            got = flight_post.fused_post(kf, mid_f, *pair, out=lanes,
                                         entry=host_post)
            assert all(getattr(got, f) is lanes[f] for f in lanes)
        else:
            got = flight_post.fused_post(kf, mid_f, *pair, entry=host_post)
        ref = kp._step_post(mid, *pair)
        assert got.step == ref.step == k + 1
        _assert_same_post(got, ref, k, case)
        for f in ('outcome', 'sfc_branch', 'tile_stops'):
            if getattr(kp, f) is not None:
                assert torch.equal(getattr(kf, f), getattr(kp, f)), (k, f)
        # tallies: each lane's deposit to f32 rounding, summed in another
        # order (the plain image is a matmul over g, then index_add_)
        for t_f, t_p in ((rad_f, ref.rad), (ab_f, ref.absorbed)):
            torch.testing.assert_close(
                t_f, t_p, rtol=1e-5, atol=1e-6 * float(t_p.abs().max()),
                msg=f'{case} {k}')
        hits += int(mid.hit_sfc.sum())
        c = ref
    assert int(kp.outcome.sum()) > 0 and hits > 0
    if kp.radiance:
        assert float(c.rad.sum()) > 0
    if kp.tally_absorbed:
        assert float(c.absorbed.sum()) > 0
    if kp.sfc_branch is not None:
        assert int(kp.sfc_branch[0]) > 0 and int(kp.sfc_branch[1]) > 0


def _fuse_on_cpu(kern):
    """What FlightKernel.__init__ decides on the card."""
    kern.fused_post = flight_post.applies(kern)
    kern.fused_tally = (kern.fused_post and kern.tally_absorbed
                        and kern.cfg.cf_dtau <= 0)


@pytest.fixture
def fused_on_cpu(monkeypatch, host_twin):
    """Every flight kernel runs its post half, and its domain-average
    tallies, through the host build of the kernels where the card would
    run the kernels."""
    init = mc_flight.FlightKernel.__init__

    def init_fused(kern, *a, **kw):
        init(kern, *a, **kw)
        _fuse_on_cpu(kern)
    monkeypatch.setattr(mc_flight.FlightKernel, '__init__', init_fused)
    monkeypatch.setattr(flight_post, '_card_entry',
                        lambda dev: host_twin['post'])
    monkeypatch.setattr(dt_mod, '_card_entry',
                        lambda dev: host_twin['tally'])


@pytest.mark.parametrize('case', ['radiance_mie_rad_w', 'heating_rate',
                                  'split_rr_value'])
def test_replayed_fused_flight_equals_the_eager_fused_flight(
        case, fused_on_cpu, monkeypatch):
    """transport_flight with the post half (and the heating rate's
    domain-average tallies) fused, stepped eagerly and replayed through the
    step-halves tests' stand-in capture (graph ``post`` is the one launch,
    writing the static lanes itself): the same flight bit for bit, every
    step counted as fused, and the kernels' launches, counted with the
    replays (chip_smoke.FusedLaunches), once a step (the tally kernel's
    in the heating rate alone)."""
    eager_stats, stats = {}, {}
    trace.reset()
    trace.enable()
    try:
        with chip_smoke.FusedLaunches() as eager_n:
            eager = halves.flight(case, eager_stats)
        eager_ctr = trace.report()['counters']
        trace.reset()
        step = mc_flight.FlightKernel.step

        def replayed_step(kern, c, *a, **kw):
            if kern.graphs is None:
                kern.graphs = {}
            return step(kern, c, *a, **kw)
        monkeypatch.setattr(mc_flight.FlightKernel, 'step', replayed_step)
        monkeypatch.setattr(mc_flight._StepGraphs, '_capture',
                            halves.rerun_capture)
        with chip_smoke.FusedLaunches() as n:
            got = halves.flight(case, stats)
        ctr = trace.report()['counters']
    finally:
        trace.enable(False)
        trace.reset()
    steps = sum(eager_stats['stage_steps'])
    launches = {'flight_post': steps,
                'domain_tally': steps if case == 'heating_rate' else 0}
    assert eager_n.launches == n.launches == launches
    assert eager_stats['fused_post_steps'] == steps == \
        eager_ctr['flight.post.fused_steps']
    assert eager_stats['graph_steps'] == 0
    halves.same_flight(got, eager)
    assert stats['stage_steps'] == eager_stats['stage_steps']
    assert stats['iter_outcome'] == eager_stats['iter_outcome']
    assert stats['fused_post_steps'] == steps == \
        ctr['flight.post.fused_steps']
    assert stats['graph_steps'] == steps - len(stats['stage_steps'])


@pytest.mark.parametrize('case', ['heating_rate', 'heating_rate_ocean'])
def test_host_build_of_the_tally_kernel_equals_the_dense_tally(
        case, host_twin, monkeypatch):
    """The domain-average tallies of the first half: the kernel's per-lane
    body built for the host against the dense (B, Nz+1, Ng) branch, from
    one carry and deviates a step for four steps (the heating-rate case of
    the step-halves tests, and the same over the mixed surface of
    :func:`surface_scene`, whose reflected flights cross level 0 going
    up): every lane and local of the first half bit for bit, the flux and
    absorbed tallies to f32 rounding of their sums."""
    monkeypatch.setattr(dt_mod, '_card_entry', lambda dev: host_twin['tally'])
    if case == 'heating_rate':
        kp, kf = halves.kernel(case), halves.kernel(case)
    else:
        sc, st, _ = surface_scene(12)
        cfg = SolverConfig(**halves.BASE, target='flux',
                           flux_per_column=False)
        kp, kf = (mc_flight.FlightKernel(sc, st, cfg, 1500) for _ in '12')
    assert kp.tally_absorbed and not kp.fused_tally
    kf.fused_tally = True
    c = kp.carry0(halves.B)
    for k, u in enumerate(halves.deviates('heating_rate')):
        cf = c._replace(flux=c.flux.clone(), absorbed=c.absorbed.clone())
        k1, mid = kp._step_pre(c, u, 7)
        _, mid_f = kf._step_pre(cf, u, 7)
        for f in mid._fields:
            if f != 'c' and isinstance(getattr(mid, f), torch.Tensor):
                assert torch.equal(getattr(mid_f, f), getattr(mid, f)), f
        for f in ('flux', 'absorbed'):
            t_f, t_p = getattr(cf, f), getattr(c, f)
            torch.testing.assert_close(
                t_f, t_p, rtol=1e-5, atol=1e-6 * float(t_p.abs().max()),
                msg=f'{case} {k} {f}')
        c = kp._step_post(mid, *phase_pair(*k1))
    assert float(c.flux.sum()) > 0 and float(c.absorbed.sum()) > 0


# ---------------------------------------------------------------------------
# the selection


def test_cpu_kernels_never_fuse():
    for case in ('radiance_mie_rad_w', 'flux_kx4_flux_w', 'heating_rate'):
        k = halves.kernel(case)
        assert flight_post.applies(k) and k.fused_post is False
        assert k.fused_tally is False
        stats = {}
        halves.flight(case, stats, photons=1500)
        assert stats['fused_post_steps'] == 0


REFUSED = {
    'camera': dict(target='radiance', sensor_type='camera', cam_npix=8),
    'pathlength': dict(target='radiance', pathlength=True),
    'per_g_image': dict(target='radiance'),
    'p3d': dict(target='radiance', p3d_order=2),
    'firstdep': dict(target='radiance', ablate='firstdep'),
    'deposit': dict(target='radiance', ablate='deposit'),
    'phase': dict(target='flux', ablate='phase'),
}


@pytest.mark.parametrize('mode', list(REFUSED) + ['ipa', 'slab',
                                                 'one_pixel'])
def test_modes_that_deposit_elsewhere_keep_the_plain_post_half(mode):
    s = halves.scene()
    sc, st = s['scene'], s['st']
    kw, extra = REFUSED.get(mode, dict(target='radiance')), {}
    if mode in ('ipa', 'slab', 'one_pixel', 'p3d') or \
            mode in ('firstdep', 'deposit'):
        extra['rad_w'] = s['rad_w']
    if mode == 'ipa':
        st = dataclasses.replace(st, ipa=True)
    if mode == 'slab':
        extra.update(slab=mc_flight.SlabSpec(st.nx * 2, st.nx), x_off=0.0)
    if mode == 'one_pixel':
        atm = atm_atmmod(np.array([0.0, 1.0, 5.0, 20.0]))
        sc, st = build_scene(atm, abs_synthetic(650.0, atm, ng=2),
                             surface=0.1, device='cpu')
        extra['rad_w'] = np.ones(2, np.float32)
    k = mc_flight.FlightKernel(sc, st, SolverConfig(**halves.BASE, **kw),
                               1000, **extra)
    assert not flight_post.applies(k) and not k.fused_post


def test_the_five_cells_kernels_fuse_on_the_card():
    """Each cell of BENCHMARK.json through its own solve arguments (its
    configuration at 24 x 24 columns, HG, on the CPU): the flight kernel
    that solve builds would run the fused post half on the card."""
    from benchmark.lib import harness, manifest
    root = Path(__file__).resolve().parents[1]

    class Built(Exception):
        pass

    seen = {}
    init = mc_flight.FlightKernel.__init__

    def spy(kern, *a, **kw):
        init(kern, *a, **kw)
        seen[name] = (flight_post.applies(kern), kern.fused_post,
                      kern.radiance, kern.scalar_rad, kern.st.ng,
                      kern.tally_absorbed and kern.cfg.cf_dtau <= 0,
                      kern.fused_tally)
        raise Built

    cells = ('rad_les.run1e6', 'flux_les.run1e6', 'flux_les.hr1e6',
             'oco2_o2a.rad1e6', 'rad_les.per_g')
    mp = pytest.MonkeyPatch()
    mp.setattr(mc_flight.FlightKernel, '__init__', spy)
    try:
        for name in cells:
            cell = copy.deepcopy(manifest.load_cell(root, name))
            cell.config['cloud'].update(nx=24, ny=24)
            if 'map' in cell.config['cloud']:
                cell.config['cloud']['map'].update(disks=5)
            cell.config['mie'] = None
            prep = harness.prepare(cell, 'cpu')
            with pytest.raises(Built):
                prep.solver.solve(**prep.kw, seed=1)
    finally:
        mp.undo()
    assert set(seen) == set(cells)
    for name, (ok, fused, radiance, scalar, ng, tally, fused_tally) \
            in seen.items():
        assert ok and not fused and not fused_tally, name
        assert not radiance or scalar, name
        # the domain-average tally kernel: the heating-rate cell alone
        assert tally == (name == 'flux_les.hr1e6'), name
    assert seen['rad_les.per_g'][4] == 1

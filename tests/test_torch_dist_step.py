"""The pieces of the port's multi-device transport, one at a time.

1. The x-slab branch of the flight step against the reference's
   (``make_flight_kernel(..., slab=SlabSpec(16, 4), x_off, spawn_reserve)``)
   with JAX's deviates injected, on a shard of a 16x16 broken-cloud scene
   (tiles of 3 columns, so each 4-column slab ends in a partial tile), for
   an edge slab and a middle one (``step_parity`` of
   tests/test_torch_flight_modes.py).
2. The lane pack and unpack, bit for bit.
3. One migration swap on a hand-built ring of 3 ranks: photons are
   conserved, shipped lanes arrive bit-identical, no active in-slab lane
   leaves, shipments stay within window and capacity.
4. The per-rank random streams.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from er3t_tpu.pre.atm import atm_atmmod
from er3t_tpu.pre.abs import abs_synthetic
from er3t_tpu.pre.cld import cld_gen_hem
from er3t_tpu.pre.pha import pha_mie_wc
from er3t_tpu.rtm.out import spectral_factors
from er3t_tpu.rtm.scene import build_scene
from er3t_tpu_torch.dist.decomp import migrate_dir, shard_scene
from er3t_tpu_torch.dist.mesh import make_mesh, rank_seed
from er3t_tpu_torch.rtm import mc_flight as tmf
from test_torch_flight_modes import step_parity

torch.set_num_threads(2)
B = 4096                       # step_parity's lanes
N_SLAB, NX_SLAB = 4, 4         # SlabSpec(16, 4)
RESERVE = 512                  # transport_decomp's default at B = 4096


@functools.lru_cache(maxsize=None)
def scene16():
    """A 16x16 broken-cloud Mie scene (4 g-points, 20-deg truncation),
    its radiance factors and its (Nz+1, Ng) flux factors."""
    levels = np.concatenate([np.arange(0, 3.0, 0.5), np.arange(3.0, 20.1, 1.0)])
    atm = atm_atmmod(levels)
    ab = abs_synthetic(650.0, atm, ng=4)
    cld = cld_gen_hem(nx=16, ny=16, nz=4, dx=0.2, dy=0.2, dz=0.5,
                      cloud_frac_tgt=0.4, radii=(0.4,), cot_scale=12.0,
                      cloud_base=0.5, seed=3)
    scn, st = build_scene(atm, ab, cld=cld, pha=pha_mie_wc(650.0),
                          surface=0.05, solar_zenith_angle=30.0,
                          solar_azimuth_angle=45.0, forward_trunc_deg=20.0)
    rad_w = spectral_factors(ab, nz_out=1)[0][0]
    flux_w = spectral_factors(ab, nz_out=st.nz + 1)[0]
    return scn, st, rad_w, flux_w


MODES = {
    'nadir': dict(target='radiance'),
    'slant': dict(target='radiance', sensor_zenith=30.0,
                  sensor_azimuth=60.0),
    'ipa': dict(target='radiance'),
    'flux_column': dict(target='flux', flux_per_column=True, flux_kcross=4),
    'flux_domain': dict(target='flux', flux_per_column=False),
    'camera': dict(target='radiance', sensor_type='camera', cam_npix=16,
                   cam_zloc=0.0, cam_qmax=85.0),
}


@pytest.mark.parametrize('i', [0, 2], ids=['edge_slab', 'middle_slab'])
@pytest.mark.parametrize('mode', list(MODES))
def test_slab_step_parity_with_injected_deviates(mode, i):
    """Eight steps of slab ``i`` in both packages from the reference's
    carries, under step_parity's tolerances; the lanes that left the slab
    are frozen in place (roaming above the deck top where allowed)."""
    scn, st, rad_w, flux_w = scene16()
    if mode == 'ipa':
        st = dataclasses.replace(st, ipa=True)
    parts, st_loc = shard_scene(scn, st, N_SLAB, i)
    shard = type(scn)(**parts._asdict())
    kw = dict(batch=B, n_scat_max=300, tile_size=3, qmc_launch=True,
              **MODES[mode])
    flux = kw['target'] == 'flux'
    x_off = float(np.float32(i * NX_SLAB) * np.float32(st.dx))
    got, kern = step_parity(
        shard, st_loc, kw, steps=8, slab=(st.nx, NX_SLAB), x_off=x_off,
        spawn_reserve=RESERVE,
        rad_w=None if flux or mode == 'camera' else rad_w,
        flux_w=flux_w if mode == 'flux_column' else None)
    assert kern.roam == (mode != 'flux_column')
    out = got.alive & ~kern._in_slab(got.x)
    if mode == 'ipa':
        assert not out.any()          # IPA lanes never move
    else:
        assert int(out.sum()) > 0
    if flux:
        assert float(got.flux.abs().sum()) > 0
    else:
        assert float(got.rad.abs().sum()) > 0
        assert got.rad.shape[0] == kern.nxr * kern.nyr


def _carry(rng, b, ng=3, lx=3.0, zd=2.0, dead=0.3):
    """A carry of ``b`` random lanes on a ring of 3 slabs of width 1:
    positions anywhere, a third of them above ``zd``, a share ``dead``
    dead; every lane has a distinct ``wsc`` so it can be followed."""
    def f(*shape):
        return torch.from_numpy(rng.uniform(-1, 1, shape).astype(np.float32))
    return tmf.FlightCarry(
        x=torch.from_numpy(rng.uniform(0, lx, b).astype(np.float32)),
        y=f(b), z=torch.from_numpy(rng.uniform(0, 1.5 * zd, b)
                                   .astype(np.float32)),
        ux=f(b), uy=f(b), uz=f(b),
        wsc=torch.from_numpy(rng.permutation(b).astype(np.float32) + 0.5),
        labs=f(ng + 1, b), tau=f(b),
        nscat=torch.from_numpy(rng.integers(0, 2 ** 31 - 1, b,
                                            dtype=np.int32)),
        alive=torch.from_numpy(rng.uniform(size=b) >= dead),
        ix0=torch.from_numpy(rng.integers(2 ** 24, 2 ** 30, b,
                                          dtype=np.int32)),
        iy0=torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31 - 1, b,
                                          dtype=np.int32)),
        plen=f(b), direct=torch.from_numpy(rng.uniform(size=b) < 0.5),
        launched=torch.tensor(7), step=3, rad=torch.zeros(1),
        rad_pl=torch.zeros(1), flux=torch.zeros(1), absorbed=torch.zeros(1))


def test_lane_matrix_round_trip_is_bit_for_bit():
    """Floats by their bits (NaN payloads, -0, denormals, infinities), int
    lanes at and above 2^24, bools: unpacked exactly as packed, and a row
    permutation of the matrix is _take_lanes's."""
    rng = np.random.default_rng(0)
    c = _carry(rng, 1000)
    odd = torch.from_numpy(np.array(
        [0x7FC00123, 0x80000000, 0x00000001, 0x7F800000, 0xFF800000,
         2 ** 24 + 1], np.uint32).view(np.float32))
    c = c._replace(tau=torch.cat([odd, c.tau[6:]]),
                   nscat=torch.cat([torch.tensor([2 ** 24, 2 ** 24 + 1,
                                                  2 ** 31 - 1],
                                                 dtype=torch.int32),
                                    c.nscat[3:]]))
    m, spec = tmf.lane_matrix(c)
    assert m.dtype == torch.int32 and m.shape == (1000, 14 + 4)   # labs: 4
    back = tmf.lanes_from_matrix(m, c, spec)
    for f in tmf._LANE_FIELDS:
        a, b = getattr(c, f), getattr(back, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), f
    perm = torch.from_numpy(rng.permutation(1000))
    moved = tmf.lanes_from_matrix(m[perm], c, spec)
    want = tmf._take_lanes(c, perm)
    for f in tmf._LANE_FIELDS:
        a, b = getattr(moved, f), getattr(want, f)
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), f


def _rows(c, keep):
    """The packed rows of the lanes ``keep`` as a multiset of bytes."""
    m, _ = tmf.lane_matrix(c)
    return sorted(bytes(r.numpy().tobytes()) for r in m[keep])


@pytest.mark.parametrize('roam', [True, False], ids=['roam', 'no_roam'])
@pytest.mark.parametrize('right', [True, False], ids=['right', 'left'])
@pytest.mark.parametrize('case', ['busy', 'drain', 'drain_all_emigrants'])
def test_migrate_dir_on_a_ring_of_three(case, right, roam):
    """One swap: the alive lanes over all ranks are the same multiset of
    packed rows (nothing lost, nothing cloned, shipped rows bit-identical);
    every lane that stays active in its slab stays on its rank; no rank
    ships more than min(window, the receiver's dead lanes + its own
    shipment).  The drain cases have n_dead + j >= B for most window
    slots, where the reference once cloned photons; in the last every
    alive lane sits below the deck in the next slab along the swap, so
    the last lane of the sort ships and the clamped slots name it too."""
    rng = np.random.default_rng(['busy', 'drain', 'drain_all_emigrants']
                                .index(case) * 4 + 2 * right + roam)
    b, window, zd = 256, 48, 2.0
    mesh = make_mesh(3, device=['cpu'] * 3)
    cs = [_carry(rng, b, dead=0.3 if case == 'busy' else 0.97)
          for _ in range(3)]
    if case == 'drain_all_emigrants':
        shift = 1 if right else -1
        cs = [c._replace(x=(c.x % 1.0) + (r + shift) % 3, z=c.z % zd)
              for r, c in enumerate(cs)]
    before = sum((_rows(c, c.alive) for c in cs), [])
    counts = [[0, 0] for _ in cs]
    new = migrate_dir(mesh, cs, window, 1.0, zd, roam, right, counts)
    after = sum((_rows(c, c.alive) for c in new), [])
    assert sorted(before) == sorted(after)
    shipped = [int(n) for n, _ in counts]
    assert sum(shipped) > 0
    for r, (c, n) in enumerate(zip(cs, new)):
        slab = torch.floor(c.x).long() % 3
        stays = c.alive & (slab == r)
        if roam:
            stays = stays | (c.alive & (c.z > zd))
        assert set(_rows(c, stays)) <= set(_rows(n, n.alive))
        dst = (r + (1 if right else -1)) % 3
        cap = int((~cs[dst].alive).sum()) + shipped[dst]
        assert shipped[r] <= min(window, cap)
        if case == 'drain_all_emigrants':
            assert shipped[r] == int(c.alive.sum()) > 0
        assert int(n.alive.sum()) == int(c.alive.sum()) - shipped[r] \
            + shipped[(r - (1 if right else -1)) % 3]


def test_rank_streams_are_distinct_and_apart_from_the_solver_seeds():
    """rank_seed differs for every (seed, rank) pair tried, none equals a
    seed the solver derives (chunks seed + 7919 i, runs seed + 1000 r and
    seed + 1000003 r, g-points seed + g), and the ranks' first draws
    differ."""
    seeds = {rank_seed(s, r) for s in range(64) for r in range(16)}
    assert len(seeds) == 64 * 16
    solver = {s + k * step for s in range(64) for k in range(64)
              for step in (1, 1000, 7919, 1000003)}
    assert not seeds & solver
    assert all(0 <= v < 2 ** 64 for v in seeds)
    draws = set()
    for r in range(8):
        g = torch.Generator()
        g.manual_seed(rank_seed(5, r))
        draws.add(float(torch.rand((), generator=g)))
    assert len(draws) == 8

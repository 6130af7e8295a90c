"""Domain-decomposed transport: the scene split into x-slabs over the mesh
axis 'x', photons migrating between slabs (counterpart of
``er3t_tpu/dist/decomp.py``; see its module notes for the design).

Each rank transports only the photons inside its slab.  A flight clamps at
a slab face (the x-slab branch of :class:`~..rtm.mc_flight.FlightKernel`),
the lane freezes, and :func:`migrate_dir` ships it to the neighbour on the
shorter way round the ring: a capacity-backpressured prefix swap, so that
no photon is lost or cloned and no active in-slab lane ever leaves.  A
superstep is ``k_super`` flight steps on every rank, then a swap to the
right and one to the left.  Radiance images are global on every rank and
summed; per-column flux tallies are the slabs', concatenated along x; the
domain-average flux and ``absorbed`` are summed.

Ranks held in one process issue their steps one after the other from one
host thread.  The per-superstep host read is the loop condition; the
migration counts stay on the device.
"""

from __future__ import annotations

import dataclasses
import math
import time

import torch

from ..rtm.mc import SolverConfig, Tallies, draw_deviates, resolve_device
from ..rtm.mc_flight import (FlightKernel, SlabSpec, lane_matrix,
                             lanes_from_matrix, _f32)
from ..rtm.scene import SceneArrays, SceneStatic
from .mesh import Mesh, rank_seed
from .photon import scene_on

__all__ = ['transport_decomp', 'shard_scene', 'migrate_dir']

_F = torch.float32
_SHARDED = ('ext3d', 'ssa3d', 'apf3d', 'cf3d')


def shard_scene(scene: SceneArrays, st: SceneStatic, n_dev: int, i: int):
    """Slab ``i`` of ``n_dev`` of a scene (reference :105-111): the 3D
    fields cut along x, the surface maps too where they follow the
    atmosphere's grid (``nxs == nx``), the rest shared.  Returns the
    slab's (SceneArrays, SceneStatic)."""
    if st.nx % n_dev:
        raise ValueError('nx must divide the decomposition axis')
    nx = st.nx // n_dev
    sfc = st.nxs == st.nx
    cut = slice(i * nx, (i + 1) * nx)
    parts = {f: (getattr(scene, f)[cut] if f in _SHARDED
                 or (sfc and f in ('jsfc', 'psfc')) else getattr(scene, f))
             for f in scene._fields}
    return SceneArrays(**parts), dataclasses.replace(
        st, nx=nx, nxs=st.nxs // n_dev if sfc else st.nxs)


def migrate_dir(mesh: Mesh, cs, window: int, lx_loc: float, zd_top: float,
                roam: bool, go_right: bool, counts: list | None = None):
    """One migration swap (reference :141-205) over the local ranks'
    carries ``cs``; returns their carries after it.  ``counts``: optional
    list of one [shipped, held back] pair per local rank, to which this
    swap's counts are added on the device.

    A lane frozen out of its slab (not a roamer above ``zd_top``) is an
    emigrant toward the direction that reaches its slab in fewer hops
    (halfway targets both ways).  Each rank stably sorts its lanes dead
    first, emigrants next, the rest last, so an active in-slab lane is
    never exported; two rounds of capacity exchange bound the shipment to
    ``min(emigrants, window, receiver's dead lanes + its own shipment)``;
    the shipped rows go in one (window + 1, F) int32 buffer whose last row
    holds the count, the rest zeroed.  The sender vacates the shipped
    rows, the receiver hosts the incoming ones in its dead and vacated
    rows.  Every slot of the window that carries nothing is written to a
    dump row past the lanes, so no index is written twice with different
    values (on the card the winner of duplicate indices is undefined)."""
    n_dev = mesh.shape['x']
    shift = 1 if go_right else -1
    parts = []
    for r, c in zip(mesh.local_ranks, cs):
        me = mesh.coords(r)[0]
        b = c.x.shape[0]
        t_slab = torch.remainder(torch.floor(c.x / lx_loc).long(), n_dev)
        d_r = torch.remainder(t_slab - me, n_dev)     # hops to the right
        frozen = c.alive & (d_r != 0)
        if roam:
            frozen = frozen & (c.z <= zd_top)
        emig = frozen & ((d_r <= n_dev // 2) if go_right
                         else (d_r >= (n_dev + 1) // 2))
        dead = ~c.alive
        key = torch.where(dead, 0, torch.where(emig, 1, 2))
        perm = torch.argsort(key, stable=True)
        parts.append((b, perm, torch.sum(dead), torch.sum(emig)))
    # capacity fixed point: a receiver holds its dead lanes plus the rows
    # it vacates by shipping in this same swap
    cap = [n_dead for _, _, n_dead, _ in parts]
    ship = [torch.clamp(n_emig, max=window) for _, _, _, n_emig in parts]
    for _ in range(2):
        cap_nb = mesh.shift_x(cap, -shift)
        ship = [torch.minimum(torch.clamp(n_emig, max=window), cn)
                for (_, _, _, n_emig), cn in zip(parts, cap_nb)]
        cap = [n_dead + s for (_, _, n_dead, _), s in zip(parts, ship)]
    mats, bufs = [], []
    for (b, perm, n_dead, _), c, s in zip(parts, cs, ship):
        m, spec = lane_matrix(c)
        j = torch.arange(window, device=m.device)
        src = perm[torch.clamp(n_dead + j, 0, b - 1)]
        out = torch.where((j < s)[:, None], m[src], 0)
        count = torch.zeros((1, m.shape[1]), dtype=m.dtype, device=m.device)
        count[0, 0] = s
        mats.append((m, spec, j, src))
        bufs.append(torch.cat([out, count]))
    got = mesh.shift_x(bufs, shift)
    new = []
    for k, ((b, perm, n_dead, n_emig), c, s, (m, spec, j, src), buf) in \
            enumerate(zip(parts, cs, ship, mats, got)):
        in_win, n_in = buf[:window], buf[window, 0]
        m2 = torch.cat([m, torch.zeros_like(m[:1])])
        # vacate the shipped rows, then host the arrivals in the dead and
        # vacated rows perm[:n_dead + ship]; idle slots go to the dump row b
        m2[torch.where(j < s, src, b), spec['alive'][0]] = 0
        dst = torch.where(j < n_in, perm[torch.clamp(j, 0, b - 1)], b)
        m2[dst] = torch.where((j < n_in)[:, None], in_win, 0)
        new.append(lanes_from_matrix(m2[:b], c, spec))
        if counts is not None:
            counts[k][0] = counts[k][0] + s
            counts[k][1] = counts[k][1] + (n_emig - s)
    return new


def _sync(mesh):
    for r in mesh.local_ranks:
        if mesh.device(r).type == 'cuda':
            torch.cuda.synchronize(mesh.device(r))


def transport_decomp(scene, st, cfg: SolverConfig, n_photon: int,
                     mesh: Mesh, seed: int = 0, k_super: int = 16,
                     window: int | None = None, max_rounds: int | None = None,
                     flux_w=None, rad_w=None, spawn_reserve: int | None = None,
                     stats: dict | None = None) -> Tallies:
    """Run transport with the scene x-decomposed over the mesh axis 'x'
    and independent photon streams over 'b' (reference :59-282).

    ``scene``/``st`` describe the global scene.  Each rank runs
    ``n_photon // n_x // n_b`` photons, so the remainder is dropped, as
    in the reference (``solve`` normalises by the photons launched); rank
    ``r`` draws from a generator seeded ``rank_seed(seed, r)``.  The
    migration window holds ``window`` lanes (default B // 4);
    ``spawn_reserve`` defaults to min(window // 2, B // 8) on a ring of
    more than one slab; ``max_rounds`` caps the supersteps, and a run that
    reaches it leaves photons in flight.  Supports what the flight kernel
    supports under a slab: radiance toward a satellite (any direction,
    IPA) or a camera (without importance launch), pathlength, flux and
    heating rate.  Returns global tallies; ``stats`` (optional dict)
    receives ``rounds``, ``max_rounds``, ``rank_steps``, ``in_flight``
    (lanes alive at the end: 0 unless the cap was reached), ``shipped``
    and ``held`` (lanes shipped, and emigrants held back by the window or
    the receiver, over all swaps), and ``flight_s`` / ``migrate_s``, the
    walls of the flight steps and of the swaps (timing them waits for the
    device between the two)."""
    n_dev, n_b = mesh.shape['x'], mesh.shape['b']
    if st.nx % n_dev:
        raise ValueError('nx must divide the decomposition axis')
    radiance = cfg.target == 'radiance'
    nx_loc = st.nx // n_dev
    slab = SlabSpec(nx_global=st.nx, nx_local=nx_loc)
    B = cfg.batch
    M = window or max(B // 4, 1)
    if spawn_reserve is None:
        spawn_reserve = min(M // 2, B // 8) if n_dev > 1 else 0
    n_per = int(n_photon) // n_dev
    if max_rounds is None:
        max_rounds = int(math.ceil(n_per / B + 1)
                         * max(1600 // k_super, 8)) + 32
    n_per //= n_b

    ranks = []
    for r in mesh.local_ranks:
        i = mesh.coords(r)[0]
        dev = mesh.device(r)
        scn, st_loc = shard_scene(scene, st, n_dev, i)
        scn = scene_on(scn, dev)
        resolve_device(scn, dev)
        kern = FlightKernel(scn, st_loc, cfg, n_per, rad_w=rad_w,
                            flux_w=flux_w, slab=slab,
                            x_off=_f32(float(i * nx_loc) * _f32(st.dx)),
                            spawn_reserve=spawn_reserve)
        gen = torch.Generator(device=dev)
        gen.manual_seed(rank_seed(seed, r))
        q_off = (torch.randint(0, kern.n_cell, (), generator=gen, device=dev)
                 if kern.strat else 0)
        ranks.append((kern, gen, q_off, dev))
    cs = [kern.carry0(B) for kern, *_ in ranks]
    k0 = ranks[0][0]
    # above the deck top lanes roam and are not shipped; under per-column
    # flux every lane out of its slab ships
    roam, lx_loc, zd_top = k0.roam, k0.lx_loc, k0.zd_hi

    def step(c, kern, gen, q_off, dev):
        kw = {}
        u = draw_deviates(gen, B, dev)
        if cfg.split_wmax > 0:
            kw['u_split'] = draw_deviates(gen, B, dev, rows=1)[0]
        return kern.step(c, u, q_off, **kw)

    counts = [[0, 0] for _ in cs]
    flight_s = migrate_s = 0.0
    rounds = 0
    while rounds < max_rounds and mesh.any(
            [c.alive.any() | (c.launched < n_per) for c in cs]):
        t0 = time.perf_counter()
        for k, rk in enumerate(ranks):
            for _ in range(k_super):
                cs[k] = step(cs[k], *rk)
        if stats is not None:
            _sync(mesh)
        t1 = time.perf_counter()
        if n_dev > 1:        # a ring of one slab would only reshuffle
            for right in (True, False):
                cs = migrate_dir(mesh, cs, M, lx_loc, zd_top, roam, right,
                                 counts)
            if stats is not None:
                _sync(mesh)
        flight_s += t1 - t0
        migrate_s += time.perf_counter() - t1
        rounds += 1

    launched = mesh.psum([c.launched for c in cs])
    steps = mesh.psum([torch.tensor(c.step, dtype=torch.int64) for c in cs])
    dev0 = launched.device
    nlev = st.nz + 1
    ng_r = 1 if k0.scalar_rad else st.ng
    if radiance:
        rad = mesh.psum([c.rad for c in cs]).reshape(k0.nxr, k0.nyr, ng_r)
        flux = torch.zeros((1, 1, nlev, 3, st.ng), dtype=_F, device=dev0)
    else:
        rad = torch.zeros((st.nx, st.ny, st.ng), dtype=_F, device=dev0)
    if not radiance and k0.nxf * k0.nyf > 1:
        # the slabs' per-column tallies, each with its deterministic TOA
        # down-direct entry, placed at their x offsets and summed
        parts = []
        for (kern, *_), c, r in zip(ranks, cs, mesh.local_ranks):
            i = mesh.coords(r)[0]
            f = c.flux.reshape(nx_loc, st.ny, nlev, 3, -1)
            toa1 = torch.sum(kern.flux_w[st.nz]) if kern.scalar_flux else 1.0
            f[:, :, st.nz, 0, :] += (c.launched.to(_F) * toa1
                                     / (nx_loc * st.ny))
            g = torch.zeros((st.nx,) + f.shape[1:], dtype=_F, device=f.device)
            g[i * nx_loc:(i + 1) * nx_loc] = f
            parts.append(g)
        flux = mesh.psum(parts)
    elif not radiance:
        flux = mesh.psum([c.flux for c in cs]).reshape(1, 1, nlev, 3, st.ng)
        flux[:, :, st.nz, 0, :] += launched.to(dev0, _F)
    if radiance and cfg.pathlength:
        rad_plen = mesh.psum([c.rad_pl for c in cs]).reshape(
            k0.nxr, k0.nyr, st.ng)
    else:
        rad_plen = torch.zeros((), dtype=_F, device=dev0)
    absorbed = mesh.psum([c.absorbed for c in cs])
    if stats is not None:
        stats.update(rounds=rounds, max_rounds=max_rounds,
                     rank_steps=[c.step for c in cs],
                     in_flight=sum(int(c.alive.sum()) for c in cs),
                     shipped=sum(int(n) for n, _ in counts),
                     held=sum(int(n) for _, n in counts),
                     flight_s=flight_s, migrate_s=migrate_s)
    return Tallies(rad=rad, flux=flux, n_launched=launched,
                   n_steps=steps.cpu(), rad_plen=rad_plen,
                   lane_iters=steps.cpu().double() * B, absorbed=absorbed)

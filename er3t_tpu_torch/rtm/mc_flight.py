"""Flight-based transport (port of ``er3t_tpu/rtm/mc_flight.py``).

A batch of B photon lanes advances in lock-step; every step each live lane
flies analytically through the layered (per-tile) majorant to its next
tentative collision, deposits a local estimate toward the sensor
(radiance) or tallies every level it crosses (flux), and scatters or
reflects; dead lanes respawn from the remaining budget.  The physics and
the operation order are the reference's (see the design notes there); what
differs is the execution shape:

* :meth:`FlightKernel.step` is one loop body as a plain function of
  ``(carry, u, q_off)`` and, where an option needs them, the deviates of
  the reference's two extra substreams (``u_split``, ``u_imp``): it draws
  nothing itself.  :func:`flight_step` draws a step's deviates from an
  explicit ``torch.Generator`` and steps; every loop steps through it (the
  flight, the decomposed ranks).  The tests inject JAX's own deviates
  into :meth:`FlightKernel.step` and step both packages from one carry.
* the loop runs in Python; its condition reads two numbers back from the
  device once per step, or once per block of ``sort_every`` steps (the
  cost is recorded in PERF.md).  On the card the step's kernels are not
  issued one by one: :meth:`FlightKernel.step` is cut at the phase-pair
  kernel into :meth:`~FlightKernel._step_pre` and
  :meth:`~FlightKernel._step_post`, captured once per batch width as two
  CUDA graphs (:class:`_StepGraphs`) and replayed, with the kernel
  launched between them.  Where :func:`.flight_post.applies`, the card
  runs :meth:`~FlightKernel._step_post` as one hand-written kernel
  (``FlightKernel.fused_post``).
* drain compaction and lane sorting permute each lane field with one
  ``argsort``; the port carries int lanes as int tensors, so no f32
  lane-matrix packing (and no 2^24 guard) is needed.
* the phase-table pair lookup goes through :func:`~.phase_pair.phase_pair`
  (a hand-written CUDA kernel on the card), whatever ``cfg.use_pallas`` and
  whatever the target or sensor: the flux branch needs its sampled cosine
  too, and the camera evaluates the cosine toward the camera.
* flux tallies are unpacked rows, ``(Nxf*Nyf*(Nz+1)*3, Ng)`` or, with
  ``flux_w``, flat scalars; the reference's 8-fold row packing is a TPU
  layout device.
* the x-slab branch of domain-decomposed runs (``slab=``, reference
  :107-110) is the reference's, site for site; :func:`lane_matrix` packs
  the lanes bit for bit into one int32 matrix for the migration exchange
  of :mod:`er3t_tpu_torch.dist.decomp`, so no 2^24 guard is needed.

Supported: ``target`` radiance or flux (per-column with ``flux_kcross``
> 0 or = 0, with or without ``flux_w``; domain average with the direct
absorbed-energy tally), the satellite sensor in any direction and the
fisheye camera (``cam_*``: Euler pointing, aperture, importance-sampled
launch), pathlength tallies, 3D, IPA and partial-3D (``p3d_order``)
transport, ``tile_size``, ``qmc_launch`` and ``launch_coherent``,
``rad_w``, collision forcing (``cf_dtau``), splitting (``split_wmax``),
Russian roulette (``rr_wmin``, ``rr_value``), ``sort_every``, ``n_scat_max``,
``max_events`` and ``drain_compact``, the x-slab branch (``slab``,
``x_off``, ``spawn_reserve``), and the profiling stand-ins of
``cfg.ablate`` at the reference's sites (under ``'phase'`` the phase-pair
kernel is not launched).  ``cfg.flux_engine`` is ignored here,
as in the reference's ``run_transport_flight``: the solver sends
``flux_engine='marching'`` flux runs to :func:`~.mc.run_transport`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from ..util import trace
from .mc import (SolverConfig, Tallies, _sensor_dir, draw_deviates,
                 read_counts, resolve_device, rotate)
from .phase_pair import phase_pair
from .flight_post import applies as post_applies, fused_post
from .domain_tally import domain_tally
from .brdf import brdf_eval, brdf_sample_dir_weight
from .scene import SceneArrays, SceneStatic, camera_rotation

__all__ = ['FlightCarry', 'FlightKernel', 'SlabSpec', 'transport_flight',
           'run_transport_flight', 'flight_step', 'column_flux',
           'draw_deviates', 'lane_matrix', 'lanes_from_matrix', 'OUTCOMES',
           'SFC_BRANCHES']

# the classes of an active lane iteration (transport_flight's counters)
OUTCOMES = ('real', 'null', 'surface', 'toa', 'stopped')
# the Cox-Munk branch of a surface hit: an upward facet reflection, a
# whitecap bounce, a facet reflection that points down (weight 0)
SFC_BRANCHES = ('specular', 'whitecap', 'lost')

_F = torch.float32
_I = torch.int32


def _coprime_stride(n: int) -> int:
    """Largest stride <= min(0.618 n, (2^32-1)//n) coprime to ``n``: the
    bijective multiplicative shuffle ``cell = (i % n) * stride % n``."""
    s = max(1, min(int(0.618 * n), (2 ** 32 - 1) // max(n, 1)))
    while s > 1 and math.gcd(s, n) != 1:
        s -= 1
    return s


def _f32(v) -> float:
    """``v`` rounded to f32, as a Python float (the value a JAX f32 scalar
    holds)."""
    return float(np.float32(v))


@dataclasses.dataclass(frozen=True)
class SlabSpec:
    """An x-slab of a domain-decomposed run (reference :71-75)."""
    nx_global: int          # columns across all slabs
    nx_local: int           # columns of this slab (the shard's st.nx)


class FlightCarry(NamedTuple):
    """Loop state in the reference's layout: per-lane fields are (B,),
    ``labs`` is (Ng+1, B)."""
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    ux: torch.Tensor
    uy: torch.Tensor
    uz: torch.Tensor
    wsc: torch.Tensor
    labs: torch.Tensor       # (Ng+1, B) per-g log-transmission + best case
    tau: torch.Tensor
    nscat: torch.Tensor      # int32
    alive: torch.Tensor      # bool
    ix0: torch.Tensor        # int32 pinned column: the birth column (IPA),
    iy0: torch.Tensor        # the last low-order scatter's (partial 3D)
    plen: torch.Tensor       # geometric pathlength [m]
    direct: torch.Tensor     # bool: never scattered or reflected
    launched: torch.Tensor   # () int64, on the device
    step: int                # loop steps taken
    rad: torch.Tensor        # (Nxr*Nyr,) with rad_w, else (Nxr*Nyr, Ng);
    #                          the image is (Nx, Ny), or (npix, npix) for
    #                          the camera
    rad_pl: torch.Tensor     # (Nxr*Nyr, Ng) pathlength-weighted deposits
    #                          with cfg.pathlength, else (1, Ng) zeros
    flux: torch.Tensor       # (Nxf*Nyf*(Nz+1)*3,) with flux_w, else
    #                          (Nxf*Nyf*(Nz+1)*3, Ng); (1, Ng) for radiance
    absorbed: torch.Tensor   # (Nz, Ng) direct absorbed-energy tally of
    #                          domain-average flux runs, else (1, 1)


_LANE_FIELDS = ('x', 'y', 'z', 'ux', 'uy', 'uz', 'wsc', 'labs', 'tau',
                'nscat', 'alive', 'ix0', 'iy0', 'plen', 'direct')


class _Mid(NamedTuple):
    """The locals of a step that :meth:`FlightKernel._step_post` reads,
    as :meth:`FlightKernel._step_pre` leaves them (the lanes after the
    flight, the collision's outcome and channel, the sensor's
    attenuation terms)."""
    c: FlightCarry           # the step's input carry (tallies, step count)
    u: torch.Tensor
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    ux: torch.Tensor
    uy: torch.Tensor
    uz: torch.Tensor
    wsc: torch.Tensor
    labs: torch.Tensor
    tau: torch.Tensor
    nscat: torch.Tensor
    alive: torch.Tensor
    ix0: torch.Tensor
    iy0: torch.Tensor
    plen: torch.Tensor
    direct: torch.Tensor
    launched: torch.Tensor
    active: torch.Tensor
    accept: torch.Tensor
    collided: torch.Tensor
    hit_sfc: torch.Tensor
    exit_toa: torch.Tensor
    tclamp: torch.Tensor
    zclamp: torch.Tensor
    clamped: torch.Tensor | None
    ix: torch.Tensor
    l_col: torch.Tensor
    vt: torch.Tensor
    z_hi_col: torch.Tensor
    tau3_above: torch.Tensor
    tau_sens_abs: torch.Tensor
    tau_sens_sig: torch.Tensor
    ssa_ev: torch.Tensor
    apf: torch.Tensor
    mu_sc: torch.Tensor
    cam: tuple | None        # the camera's (r_cam, wsx_c, wsy_c, wsz_c)


def _copied(dst, src):
    """The tensors of ``src`` copied into those of ``dst``, in order;
    returns ``dst``."""
    for t, v in zip(dst, src):
        t.copy_(v)
    return dst


def _take_lanes(c: FlightCarry, idx: torch.Tensor) -> FlightCarry:
    """The lanes ``idx`` of every per-lane field (``labs`` along dim 1)."""
    return c._replace(**{f: (getattr(c, f)[:, idx] if f == 'labs'
                             else getattr(c, f)[idx]) for f in _LANE_FIELDS})


def _sort_lanes(c: FlightCarry, st: SceneStatic) -> FlightCarry:
    """Lanes stably sorted by their voxel column, dead lanes last
    (reference :1362-1380, ``SolverConfig.sort_every``)."""
    col = torch.clamp(torch.floor(c.x / st.dx).to(_I), 0, st.nx - 1) \
        * st.ny + torch.remainder(torch.floor(c.y / st.dy).to(_I), st.ny)
    key = torch.where(c.alive, col, st.nx * st.ny)
    return _take_lanes(c, torch.argsort(key, stable=True))


def lane_matrix(c: FlightCarry):
    """Every per-lane field as one (B, F) int32 matrix and its column spec
    (the reference's ``lane_matrix``, :1316-1343), so that a migration
    window is one buffer.  f32 fields are reinterpreted bit for bit
    (``view``), int32 fields copied, bool fields stored as 0 / 1: the
    round trip is exact for any value (the reference packs f32 values,
    exact below 2^24)."""
    cols, spec, off = [], {}, 0
    for f in _LANE_FIELDS:
        v = getattr(c, f)
        blk = v.T if f == 'labs' else v[:, None]
        if blk.dtype == torch.bool:
            blk = blk.to(_I)
        elif blk.dtype == _F:
            blk = blk.view(_I)
        elif blk.dtype != _I:
            raise TypeError(f'FlightCarry.{f} is {blk.dtype}; lane_matrix '
                            'packs float32, int32 and bool lanes')
        spec[f] = (off, blk.shape[1], v.dtype)
        cols.append(blk)
        off += blk.shape[1]
    return torch.cat(cols, dim=1), spec


def lanes_from_matrix(m: torch.Tensor, c: FlightCarry, spec) -> FlightCarry:
    """Inverse of :func:`lane_matrix`: the lanes of ``m`` in ``c``'s
    layout (tallies and counters are ``c``'s)."""
    upd = {}
    for f, (off, k, dt) in spec.items():
        blk = m[:, off:off + k]
        if dt == torch.bool:
            blk = blk != 0
        elif dt == _F:
            blk = blk.view(_F)
        upd[f] = (blk.T if f == 'labs' else blk[:, 0]).contiguous()
    return c._replace(**upd)


class FlightKernel:
    """Scene-derived tables and the step function of the flight loop
    (the reference's ``make_flight_kernel`` closure, :107-1304).

    The step works for any batch width, so one kernel serves every drain
    stage.  All tables live on the scene's device; scalar constants are
    Python floats holding the exact f32 values the reference uses.

    Flux targets (reference :151-165): per-column tallies when
    ``cfg.flux_per_column`` and the scene has more than one column, with
    the crossing-count clamp when ``cfg.flux_kcross`` > 0 and then, given
    ``flux_w`` ((Nz+1, Ng) spectral factors), one factor-contracted scalar
    per crossing; otherwise domain-average tallies and the direct
    absorbed-energy tally.  ``flux_w`` and ``rad_w`` are ignored where
    the reference ignores them; ``rad_w`` with ``cfg.pathlength`` raises
    ``ValueError`` (the pathlength ratio needs the per-g image).

    With ``slab`` (reference :113-116) ``scene`` and ``st`` are this slab's
    x-shard (:func:`er3t_tpu_torch.dist.decomp.shard_scene`) and ``x_off``
    its global x-origin [m]: photons spawn in the slab, coordinates stay
    global, a lane out of its slab freezes (above the deck top it roams,
    except under per-column flux), and flights clamp at the slab faces.
    Radiance images are global.  ``spawn_reserve`` withholds that many
    dead lanes from respawn each step, so migration always finds landing
    room.

    ``outcome``: ``None``, or a (5,) int64 tensor on the device to which
    each step adds its counts of active lanes that made a real collision,
    a tentative one (real or null), a surface hit, a TOA escape, and a
    flight stopped short at a crossing-count, tile or slab clamp (the
    caller sets it; it draws no deviate and changes no tally).

    ``sfc_branch``: ``None``, or a (3,) int64 tensor on the device to
    which each step adds its surface hits by Cox-Munk branch
    (:data:`SFC_BRANCHES`); ``tile_stops``: ``None``, or a (2,) int64
    tensor to which each step adds its active lanes and those whose flight
    ended on a tile face (the caller sets them, as ``outcome``).

    ``graphs``: ``None`` (every step runs eagerly), or a dict, from batch
    width to :class:`_StepGraphs`, through which :meth:`step` replays
    captured CUDA graphs (the caller sets it; :func:`transport_flight`
    does on the card).  ``graph_stats`` counts the graphs captured, the
    steps replayed and the steps run eagerly while replaying.

    ``fused_post``: on the card, where :func:`.flight_post.applies` (a
    satellite image contracted over g in the step, or flux; no camera,
    pathlength, pinned column, slab or deposit ablation), every step runs
    its post half as the kernel of ``csrc/flight_post.cu``
    (:func:`.flight_post.fused_post`), eagerly and in the replayed graphs
    alike (:meth:`_post_half`).  Elsewhere the post half is
    :meth:`_step_post`, the kernel's plain version.  ``fused_tally``: where
    ``fused_post`` holds, a domain-average flux run without collision
    forcing (the heating rate) also adds its level-crossing and absorbed
    tallies by one kernel (:func:`.domain_tally.domain_tally`) in place of
    the dense (B, Nz+1, Ng) branch of :meth:`_step_pre`.
    """

    outcome = sfc_branch = tile_stops = None
    graphs = None

    def __init__(self, scene: SceneArrays, st: SceneStatic,
                 cfg: SolverConfig, n_photon: int, rad_w=None, flux_w=None,
                 slab: SlabSpec | None = None, x_off=0.0,
                 spawn_reserve: int = 0):
        self.scene, self.st, self.cfg = scene, st, cfg
        self.n_photon = int(n_photon)
        self.graph_stats = {'captures': 0, 'replays': 0, 'eager_steps': 0}
        # profiling stand-ins (reference :310): see SolverConfig.ablate
        self.ablate = set(cfg.ablate.split(',')) if cfg.ablate else set()
        dev = self.device = scene.z_lev.device
        nz, ng = st.nz, st.ng
        # under a slab st.nx is the slab's width; coordinates wrap on the
        # global domain (reference :170-177)
        self.slab = slab
        self.nx_glob = st.nx if slab is None else slab.nx_global
        self.x_off = _f32(x_off)
        self.spawn_reserve = int(spawn_reserve)
        self.lx_loc = st.nx * st.dx
        self.lx = self.nx_glob * st.dx
        self.ly = st.ny * st.dy
        # the slab's upper face, f32(x_off + lx_loc) as the reference sums it
        self.x_hi = float(np.float32(self.x_off) + np.float32(self.lx_loc))
        self.radiance = cfg.target == 'radiance'
        self.camera = cfg.sensor_type == 'camera'
        # a decomposed radiance run deposits into the GLOBAL image (slant
        # sensors and IPA project deposits across slab faces)
        self.nxr, self.nyr = ((cfg.cam_npix, cfg.cam_npix) if self.camera
                              else (self.nx_glob, st.ny) if self.radiance
                              else (st.nx, st.ny))
        self.scalar_rad = self.radiance and rad_w is not None
        if self.scalar_rad and cfg.pathlength:
            raise ValueError('rad_w is incompatible with pathlength: the '
                             'pathlength ratio needs the per-g image')
        self.rad_w = (torch.as_tensor(rad_w, dtype=_F, device=dev)
                      .reshape(ng) if self.scalar_rad else None)
        self.nlev = nz + 1
        self.nxf, self.nyf = ((st.nx, st.ny) if not self.radiance
                              and cfg.flux_per_column else (1, 1))
        per_col = self.nxf * self.nyf > 1
        self.tally_absorbed = not self.radiance and not per_col
        self.kx = int(cfg.flux_kcross) if per_col else 0
        self.scalar_flux = self.kx > 0 and flux_w is not None
        self.flux_w = (torch.as_tensor(flux_w, dtype=_F, device=dev)
                       .reshape(self.nlev, ng) if self.scalar_flux else None)
        # IPA pins every lane to its birth column; partial 3D pins a lane
        # to its last low-order scatter's column from order p3d on
        self.p3d = int(cfg.p3d_order)
        self.pinned = st.ipa or self.p3d > 0
        # decomposed runs (reference :181-186): only the deck z-range is
        # sharded; above its top the replicated 1D medium lets lanes roam
        # across slabs, except under per-column flux, whose crossings are
        # tallied in the local columns
        self.roam = slab is not None and not per_col
        # IPA deposits go to the birth column's global pixel (:1184-1188)
        self.ix_shift = int(np.round(np.float32(self.x_off)
                                     / np.float32(st.dx)))

        z_lev = scene.z_lev
        self.dz_lay = z_lev[1:] - z_lev[:-1]
        zl = z_lev.tolist()
        self.z_top = zl[-1]
        self.zd_lo, self.zd_hi = zl[st.iz3l], zl[st.iz3l + st.nz3]
        self.n_aer = scene.sig_aer.shape[1]
        self.sig_aer_t = scene.sig_aer.T.contiguous()            # (Na, Nz)
        sig_1d = scene.sig_ray + torch.sum(scene.sig_aer, dim=1)
        kabs_min = torch.amin(scene.kabs, dim=1)

        # per-tile majorant columns (reference :193-217); stored (Nz, tiles)
        # so one index_select yields the (Nz, B) frame of the flight core;
        # IPA lanes read their birth column's tile and never clamp
        tile = self.tile = cfg.tile_size
        self.use_tiles = tile > 0 and st.has_3d
        self.tile_clamp = self.use_tiles and not st.ipa
        if self.use_tiles:
            ntx, nty = -(-st.nx // tile), -(-st.ny // tile)
            ext_p = torch.nn.functional.pad(
                scene.ext3d, (0, 0, 0, nty * tile - st.ny,
                              0, ntx * tile - st.nx))
            ext_t = ext_p.reshape(ntx, tile, nty, tile, st.nz3).amax(dim=(1, 3))
            lo, hi = st.iz3l, st.iz3l + st.nz3
            maj_tile = torch.cat([
                sig_1d[:lo].expand(ntx, nty, lo),
                sig_1d[lo:hi][None, None, :] + ext_t,
                sig_1d[hi:].expand(ntx, nty, nz - hi)], dim=-1)
            self.maj_tab_t = torch.clamp(maj_tile, min=1e-12) \
                .reshape(ntx * nty, nz).T.contiguous()
            self.nty = nty

        self.sx, self.sy, self.mu_s = _sensor_dir(cfg)

        # packed voxel table (reference :221-240): [ext_tot,
        # cum_ext_above_voxel_top, col_tot, then per 3D slot (cf, ssa, apf)]
        ns3 = st.ns3
        dz3 = self.dz_lay[st.iz3l:st.iz3l + st.nz3]
        self.dz3_0 = float(dz3[0])
        ext3d = scene.ext3d
        rev = torch.flip(torch.cumsum(torch.flip(ext3d * dz3, [-1]), -1), [-1])
        cum3d_top = torch.cat([rev[..., 1:],
                               torch.zeros((st.nx, st.ny, 1), dtype=_F,
                                           device=dev)], dim=-1)
        col_tot3d = cum3d_top[..., 0] + ext3d[..., 0] * dz3[0]
        slots = []
        for s in range(ns3):
            slots += [scene.cf3d[..., s], scene.ssa3d[..., s],
                      scene.apf3d[..., s].to(_F)]
        self.vox = torch.stack([ext3d, cum3d_top,
                                col_tot3d[..., None].expand_as(ext3d)] + slots,
                               dim=-1).reshape(-1, 3 + 3 * ns3).contiguous()

        # absorption + sensor-attenuation operator (reference :243-247),
        # kept transposed: (2Ng+2, 2Nz)
        kext = torch.cat([scene.kabs, kabs_min[:, None]], dim=1)
        sens_cols = torch.cat([scene.kabs, sig_1d[:, None]], dim=1)
        zero = torch.zeros_like(kext)
        self.kop_t = torch.cat([torch.cat([kext, zero], dim=1),
                                torch.cat([zero, sens_cols], dim=1)],
                               dim=0).T.contiguous()

        self.n_pf = scene.pt_mu.shape[0]
        self.pt_p = scene.pt_p.contiguous()
        self.pt_mu = scene.pt_mu.contiguous()

        # solar launch direction, computed on the device in f32 as the
        # reference does, then held as exact Python floats
        sin0 = torch.sqrt(torch.clamp(1.0 - scene.mu0 ** 2, min=0.0))
        u0x = sin0 * torch.cos(scene.phi0)
        self.u0x = float(u0x)
        self.u0y = float(sin0 * torch.sin(scene.phi0))
        self.u0z = float(-scene.mu0)
        # decomposed launch precompensation (reference :267-280): the solar
        # descent from TOA to the deck top drifts (z_top - zd_top) tan(sza)
        # across several slabs, so each slab's launch window is shifted
        # upwind by it and first deck entries stay local; the shifted
        # windows still tile the domain, so launches stay uniform
        self.x_drift0 = 0.0
        if self.roam and not st.ipa:
            self.x_drift0 = float(u0x * (z_lev[-1] - z_lev[st.iz3l + st.nz3])
                                  / torch.clamp(scene.mu0, min=1e-6))

        if self.camera:
            # fisheye camera (reference :282-287, 1029-1047, 1093-1145):
            # position, altitude and the world -> camera rotation, f32
            rot = camera_rotation(cfg.cam_phi, cfg.cam_the, cfg.cam_psi).T
            self.cam_rot = [[float(v) for v in row] for row in rot]
            self.cam_z = _f32(cfg.cam_zloc)
            self.cam_x = cfg.cam_xpos * self.lx
            self.cam_y = cfg.cam_ypos * self.ly
            # a camera above the deck top sees the deck part above the event
            self.cam_above = self.cam_z >= zl[st.iz3l + st.nz3]
            # jnp.deg2rad of the half-angle: f32(qmax) * f32(pi / 180)
            self.cam_qmax = float(np.float32(cfg.cam_qmax)
                                  * np.float32(np.pi / 180))
        self.cam_importance = (self.camera and cfg.cam_importance_sigma > 0
                               and self.radiance and slab is None)

        self.uniform_sfc = st.nxs == 1 and st.nys == 1
        # packed surface table: [jsfc, p0..p4] (reference :289-293)
        self.sfc_tab = torch.cat([scene.jsfc.reshape(-1, 1).to(_F),
                                  scene.psfc.reshape(-1, 5)], dim=1)

        # stratified launch; the coherent launch maps launch index to cell
        # linearly (stride 1); the camera-importance launch replaces it
        self.strat = ((cfg.qmc_launch or cfg.launch_coherent)
                      and not self.cam_importance)
        self.n_cell = st.nx * st.ny
        self.q_stride = (1 if cfg.launch_coherent
                         else _coprime_stride(self.n_cell))

        # the post half as one kernel on the card, and with it the
        # domain-average tallies of unforced flights; their libraries and
        # K1's are built together (one nvcc each, in parallel)
        self.fused_post = dev.type == 'cuda' and post_applies(self)
        self.fused_tally = (self.fused_post and self.tally_absorbed
                            and cfg.cf_dtau <= 0)
        if self.fused_post:
            from .._build import load_together
            load_together('phase_pair', 'flight_post', 'domain_tally')

    # ------------------------------------------------------------------
    def carry0(self, batch: int) -> FlightCarry:
        """All-dead initial state for ``batch`` lanes."""
        dev, ng = self.device, self.st.ng
        z = torch.zeros(batch, dtype=_F, device=dev)
        zi = torch.zeros(batch, dtype=_I, device=dev)
        zb = torch.zeros(batch, dtype=torch.bool, device=dev)
        npix = self.nxr * self.nyr
        rad = torch.zeros((npix,) if self.scalar_rad else (npix, ng),
                          dtype=_F, device=dev)
        rad_pl = torch.zeros((npix if self.cfg.pathlength else 1,
                              1 if self.scalar_rad else ng),
                             dtype=_F, device=dev)
        n_rows = self.nxf * self.nyf * self.nlev * 3
        flux = torch.zeros((1, ng) if self.radiance else (n_rows,)
                           if self.scalar_flux else (n_rows, ng),
                           dtype=_F, device=dev)
        absorbed = torch.zeros((self.st.nz, ng) if self.tally_absorbed
                               else (1, 1), dtype=_F, device=dev)
        return FlightCarry(
            x=z, y=z.clone(), z=z.clone(), ux=z.clone(), uy=z.clone(),
            uz=z.clone(), wsc=z.clone(),
            labs=torch.zeros((ng + 1, batch), dtype=_F, device=dev),
            tau=z.clone(), nscat=zi, alive=zb, ix0=zi.clone(),
            iy0=zi.clone(), plen=z.clone(), direct=zb.clone(),
            launched=torch.zeros((), dtype=torch.int64, device=dev), step=0,
            rad=rad, rad_pl=rad_pl, flux=flux, absorbed=absorbed)

    def _local_ix(self, x):
        if self.slab is not None:
            x = x - self.x_off
        return torch.clamp(torch.floor(x / self.st.dx).to(_I),
                           0, self.st.nx - 1)

    def _in_slab(self, x):
        return (x >= self.x_off) & (x < self.x_hi)

    def _slab_clamp(self, x, z, ux, uz, inv_uz):
        """Distance to a slab's clamp point (reference :590-622): its
        first face crossing; for a roaming flight that starts above the
        deck top, the deck entry when that lies in another slab, else the
        first face crossing after it (ascending roamers never clamp).
        Returns (clamp distance, starts above the deck top)."""
        def s_face(xq):
            # the first face crossing from a point in the slab
            return torch.where(ux > 1e-7, (self.x_hi - xq) / ux,
                               torch.where(ux < -1e-7, (self.x_off - xq) / ux,
                                           3e37))
        clamp_s = torch.clamp(s_face(x), min=0.0)
        if not self.roam:
            return clamp_s, None
        starts_above = z > self.zd_hi
        s_t = torch.clamp(torch.where(uz < 0, (self.zd_hi - z) * inv_uz, 3e37),
                          min=0.0)
        x_t = torch.remainder(x + ux * s_t, self.lx)
        entry = torch.where(self._in_slab(x_t),
                            s_t + torch.clamp(s_face(x_t), min=0.0), s_t)
        return torch.where(starts_above, torch.where(uz < 0, entry, 3e37),
                           clamp_s), starts_above

    def _local_iy(self, y):
        return torch.remainder(torch.floor(y / self.st.dy).to(_I), self.st.ny)

    def _col_index(self, x, y, ix0, iy0, nscat):
        """Voxel column of a gather (reference :299-308): the birth column
        under IPA, the pinned column of a partial-3D lane from order
        ``p3d_order`` on, else the column of (x, y)."""
        if self.st.ipa:
            return ix0, iy0
        ixl, iyl = self._local_ix(x), self._local_iy(y)
        if self.p3d:
            pin = nscat >= self.p3d
            return torch.where(pin, ix0, ixl), torch.where(pin, iy0, iyl)
        return ixl, iyl

    def _column_rows(self, x, y, ux, uy, ix0, iy0, s, lev, chi):
        """Flat per-column tally rows ``((ix*Ny + iy)*Nlev + lev)*3 + chi``
        of the crossings at distances ``s`` (B, K) along each flight; under
        IPA every crossing goes to the lane's birth column (reference
        :781-790, 885-895)."""
        if self.st.ipa:
            col = (ix0.long() * self.st.ny + iy0)[:, None]
        else:
            xc = torch.remainder(x[:, None] + ux[:, None] * s, self.lx)
            yc = torch.remainder(y[:, None] + uy[:, None] * s, self.ly)
            col = self._local_ix(xc).long() * self.st.ny + self._local_iy(yc)
        return ((col * self.nlev + lev) * 3 + chi[:, None]).reshape(-1)

    def _split(self, c: FlightCarry, u_sp) -> FlightCarry:
        """Weight-window splitting (reference :383-421, MCARaTS
        Pho_wmax/wfac): a live lane whose best-case weight exceeds
        ``split_wmax`` hands a copy of itself to a dead lane (the j-th
        splitter to the j-th dead lane), both at half weight; the copy
        draws a fresh optical depth from ``u_sp``."""
        b = c.x.shape[0]
        want = c.alive & (c.wsc * torch.exp(c.labs[self.st.ng])
                          > self.cfg.split_wmax)
        dead0 = ~c.alive
        order = torch.argsort((~want).to(_I), stable=True)
        n_cp = torch.minimum(torch.sum(want), torch.sum(dead0))
        drank = torch.cumsum(dead0, dim=0) - 1
        src = order[torch.clamp(drank, 0, b - 1)]
        do_cp = dead0 & (drank < n_cp)
        halve = want & (torch.cumsum(want, dim=0) - 1 < n_cp)
        wsc_h = torch.where(halve, c.wsc * 0.5, c.wsc)
        new = {f: torch.where(do_cp, getattr(c, f)[src], getattr(c, f))
               for f in ('x', 'y', 'z', 'ux', 'uy', 'uz', 'nscat', 'ix0',
                         'iy0', 'plen', 'direct')}
        return c._replace(
            **new, wsc=torch.where(do_cp, wsc_h[src], wsc_h),
            labs=torch.where(do_cp[None, :], c.labs[:, src], c.labs),
            tau=torch.where(do_cp, -torch.log(u_sp), c.tau),
            alive=c.alive | do_cp)

    def _importance_launch(self, x_sp, y_sp, u_imp):
        """Camera-importance launch (reference :450-482): a 50/50 mixture
        of the uniform launch and a wrapped isotropic Gaussian around the
        camera column, with the weight p_uniform / p_mixture."""
        sig = self.cfg.cam_importance_sigma
        lx, ly = self.lx, self.ly
        cam_x0, cam_y0 = self.cam_x, self.cam_y
        r_g = sig * torch.sqrt(-2.0 * torch.log(u_imp[0]))
        th_g = (2.0 * math.pi) * u_imp[1]
        pick_g = u_imp[2] < 0.5
        x_sp = torch.where(pick_g, torch.remainder(
            cam_x0 + r_g * torch.cos(th_g), lx), x_sp)
        y_sp = torch.where(pick_g, torch.remainder(
            cam_y0 + r_g * torch.sin(th_g), ly), y_sp)
        # wrapped-Gaussian pdf: the nearest three images per axis
        inv_s2 = 1.0 / (2.0 * sig * sig)
        nrm = _f32(1.0 / (np.sqrt(2.0 * np.pi) * sig))

        def pdf(d, period):
            d = torch.remainder(d + 0.5 * period, period) - 0.5 * period
            return sum(torch.exp(-(d + k * period) ** 2 * inv_s2)
                       for k in (-1.0, 0.0, 1.0)) * nrm
        p_g = pdf(x_sp - cam_x0, lx) * pdf(y_sp - cam_y0, ly)
        p_u = 1.0 / (lx * ly)
        return x_sp, y_sp, p_u / (0.5 * p_u + 0.5 * p_g)

    # ------------------------------------------------------------------
    def step(self, c: FlightCarry, u: torch.Tensor, q_off, u_split=None,
             u_imp=None) -> FlightCarry:
        """One loop body (reference :376-1278) for ``B = c.x.shape[0]``
        lanes: :meth:`_step_pre`, the phase-pair kernel (:meth:`_pair`),
        :meth:`_post_half`.

        ``u``: (14, B) f32 deviates in [1e-7, 1-1e-7]; ``q_off``: the
        stratified-launch cell offset (int or 0-d integer tensor);
        ``u_split``: (B,) deviates of the splitting substream (needed with
        ``split_wmax`` > 0); ``u_imp``: (3, B) deviates of the
        camera-importance substream (needed with ``cam_importance_sigma``
        > 0).  Lane fields are replaced by new tensors; the tallies
        ``c.rad``, ``c.rad_pl``, ``c.flux`` and ``c.absorbed`` are
        accumulated IN PLACE (``index_add_``), so the returned carry shares
        them with ``c``.  On the card those deposits run as atomics in a
        varying order, so tallies differ in the last bits from run to run.

        Where ``graphs`` is a dict (:func:`transport_flight` on the card),
        the first step at each batch width runs as above and every later
        one replays that width's captured halves (:class:`_StepGraphs`):
        the same kernels on the same deviates, issued as two CUDA graphs
        with K1 launched between them.  The returned carry's lane fields
        and ``launched`` are then the graphs' own buffers, which the next
        step at that width overwrites.
        """
        if self.graphs is not None:
            g = self.graphs.get(c.x.shape[0])
            if g is not None:
                return g.run(c, u, q_off, u_split, u_imp)
            self.graphs[c.x.shape[0]] = _StepGraphs(self, c, u, u_split, u_imp)
            self.graph_stats['eager_steps'] += 1
        k1, mid = self._step_pre(c, u, q_off, u_split, u_imp)
        return self._post_half(mid, *self._pair(k1))

    def _pair(self, k1, out=None):
        """K1's pair: ``phase_pair(*k1)`` (this module's, looked up at the
        call), copied into ``out`` where given; under the ``'phase'``
        ablation ``k1`` itself, the stand-in pair of :meth:`_step_pre`."""
        if 'phase' in self.ablate:
            return k1
        pair = phase_pair(*k1)
        return pair if out is None else _copied(out, pair)

    def _post_half(self, mid: _Mid, pe_pair, mu_new,
                   out: dict | None = None) -> FlightCarry:
        """The step from K1's pair on: the kernel of ``csrc/flight_post.cu``
        where ``fused_post`` holds, else :meth:`_step_post`; the new lanes
        written into ``out`` (a replayed step's static lanes) where given."""
        if self.fused_post:
            trace.phase('step.post')
            c = fused_post(self, mid, pe_pair, mu_new, out=out)
            trace.phase(None)
            return c
        c = self._step_post(mid, pe_pair, mu_new)
        if out is None:
            return c
        _copied(out.values(), [getattr(c, f) for f in out])
        return c._replace(**out)

    def _step_pre(self, c: FlightCarry, u: torch.Tensor, q_off, u_split=None,
                  u_imp=None):
        """The step up to K1 (split, respawn, the flight with its flux
        tallies, the collision's channel and the cosine toward the sensor).
        Returns ``(k1, mid)``: K1's six arguments (under the ``'phase'``
        ablation its stand-in results), and the locals that
        :meth:`_step_post` reads."""
        st, cfg = self.st, self.cfg
        nz, ng = st.nz, st.ng
        dx, dy, lx, ly = st.dx, st.dy, self.lx, self.ly
        sx, sy, mu_s = self.sx, self.sy, self.mu_s
        z_lev = self.scene.z_lev
        kx = self.kx
        forcing = cfg.cf_dtau > 0

        if cfg.split_wmax > 0:
            trace.phase('step.split')
            c = self._split(c, u_split)

        # ---------------- respawn ----------------
        trace.phase('step.respawn')
        dead = ~c.alive
        order = torch.cumsum(dead, dim=0)                      # int64
        quota = self.n_photon - c.launched
        sr = self.spawn_reserve
        if sr:
            # the first sr dead lanes stay dead: landing room for migration
            spawn = dead & (order > sr) & (order - sr <= quota)
        else:
            spawn = dead & (order <= quota)
        launched = c.launched + torch.sum(spawn)
        if self.strat:
            # rank among spawning lanes -> shuffled cell + in-cell jitter;
            # int64 holds the reference's uint32 values (stride*n < 2^32)
            idx = c.launched + order - (sr + 1)
            cell = torch.remainder(idx + q_off, self.n_cell) \
                * self.q_stride % self.n_cell
            x_sp = ((cell // st.ny).to(_F) + u[0]) * dx
            y_sp = ((cell % st.ny).to(_F) + u[1]) * dy
        else:
            x_sp = u[0] * self.lx_loc
            y_sp = u[1] * ly
        if self.slab is not None:
            # into this slab, shifted upwind by the launch drift
            x_sp = self.x_off + x_sp - self.x_drift0
        w_sp = 1.0
        if self.cam_importance:
            x_sp, y_sp, w_sp = self._importance_launch(x_sp, y_sp, u_imp)
        x = torch.where(spawn, torch.remainder(x_sp, lx), c.x)
        y = torch.where(spawn, y_sp, c.y)
        z = torch.where(spawn, self.z_top, c.z)
        ux = torch.where(spawn, self.u0x, c.ux)
        uy = torch.where(spawn, self.u0y, c.uy)
        uz = torch.where(spawn, self.u0z, c.uz)
        wsc = torch.where(spawn, w_sp, c.wsc)
        labs = torch.where(spawn[None, :], 0.0, c.labs)
        tau = torch.where(spawn, -torch.log(u[2]), c.tau)
        nscat = torch.where(spawn, 0, c.nscat)
        alive = c.alive | spawn
        ix0 = torch.where(spawn, self._local_ix(x), c.ix0)
        iy0 = torch.where(spawn, self._local_iy(y), c.iy0)
        plen = torch.where(spawn, 0.0, c.plen)
        direct = spawn | c.direct
        if self.slab is None:
            active = alive
        elif self.roam:
            # out of the slab a lane freezes until migrated, except above
            # the deck top (reference :499-517)
            active = alive & (self._in_slab(x) | (z > self.zd_hi))
        else:
            active = alive & self._in_slab(x)

        # ---------------- analytic flight through the majorant ----------------
        trace.phase('step.move')
        going_up = uz > 0.0
        uz_safe = torch.where(torch.abs(uz) < 1e-6,
                              torch.sign(uz + 1e-30) * 1e-6, uz)
        inv_uz = 1.0 / uz_safe
        if self.use_tiles:
            # majorant of the tile at the flight's deck entry point (of the
            # pinned column for IPA and pinned partial-3D lanes)
            if st.ipa:
                ixm, iym = ix0, iy0
            else:
                t1 = (self.zd_lo - z) * inv_uz
                t2 = (self.zd_hi - z) * inv_uz
                sd_in = torch.clamp(torch.minimum(t1, t2), min=0.0)
                sd_out = torch.clamp(torch.maximum(t1, t2), min=0.0)
                xe_u = x + ux * sd_in
                ye_u = y + uy * sd_in
                xe_w = torch.remainder(xe_u, lx)
                ye_w = torch.remainder(ye_u, ly)
                offx = xe_u - xe_w          # ray-frame unwrap offsets
                offy = ye_u - ye_w
                ixm, iym = self._col_index(xe_w, ye_w, ix0, iy0, nscat)
            txp = ixm // self.tile
            typ = iym // self.tile
            sig_col = torch.index_select(self.maj_tab_t, 1,
                                         (txp * self.nty + typ).long())
        else:
            sig_col = self.scene.sig_maj[:, None]
        s_lo = (z_lev[:-1, None] - z[None, :]) * inv_uz[None, :]
        s_hi = (z_lev[1:, None] - z[None, :]) * inv_uz[None, :]
        d_in = torch.clamp(torch.minimum(s_lo, s_hi), min=0.0)
        d_out = torch.clamp(torch.maximum(s_lo, s_hi), min=0.0)
        seg = torch.clamp(d_out - d_in, min=0.0)

        od = seg * sig_col
        cum_up = torch.cumsum(od, dim=0)
        cum_dn = torch.flip(torch.cumsum(torch.flip(od, [0]), dim=0), [0])
        cum = torch.where(going_up[None, :], cum_up, cum_dn)
        total_od = torch.where(going_up, cum_up[-1], cum_dn[0])
        s_exit = torch.sum(seg, dim=0)

        if self.tile_clamp:
            tx_lo = (txp * self.tile) * dx
            tx_hi = torch.clamp((txp + 1) * self.tile, max=st.nx) * dx
            if self.slab is not None:
                tx_lo = self.x_off + tx_lo
                tx_hi = self.x_off + tx_hi
            tx_lo = tx_lo + offx
            tx_hi = tx_hi + offx
            ty_lo = (typ * self.tile) * dy + offy
            ty_hi = torch.clamp((typ + 1) * self.tile, max=st.ny) * dy + offy
            sfx = torch.where(ux > 1e-7, (tx_hi - x) / ux,
                              torch.where(ux < -1e-7, (tx_lo - x) / ux, 3e38))
            sfy = torch.where(uy > 1e-7, (ty_hi - y) / uy,
                              torch.where(uy < -1e-7, (ty_lo - y) / uy, 3e38))
            s_tile = torch.clamp(torch.minimum(sfx, sfy), min=0.0)
            can_clamp = active & (s_tile < sd_out)
            if self.p3d:
                # pinned lanes see a medium that no longer varies with x, y
                can_clamp = can_clamp & (nscat < self.p3d)
            if self.slab is not None:
                # a roamer whose deck entry lies in another slab read a
                # clamped local tile: its faces are bogus, it takes the
                # slab clamp instead (reference :579-589)
                can_clamp = can_clamp & self._in_slab(xe_w)
        if self.slab is not None:
            clamp_s, starts_above = self._slab_clamp(x, z, ux, uz, inv_uz)

        if kx:
            # crossing-count prelude (reference :625-636): the k-th crossing
            # of a flight is level n_le + k going up, n_below-1-k going
            # down; the level-0 crossing of a surface-reflected flight (z
            # exactly 0, going up, s == 0) is admitted explicitly (up0k)
            n_below = torch.sum(z_lev[None, :] < z[:, None], dim=1)
            n_le = torch.sum(z_lev[None, :] <= z[:, None], dim=1)
            up0k = active & going_up & (z <= 0.0)
            n_le = torch.where(up0k, 0, n_le)

        tau_use = tau
        if forcing:
            # collision forcing (reference :557-654, MCARaTS Rad_cf_*,
            # Flx_cf_dtau): thin upward flights that cannot clamp collide
            # from a truncated exponential with weight 1 - exp(-OD); the
            # escape outcome is tallied deterministically for flux targets
            clampable = can_clamp if self.tile_clamp \
                else torch.zeros_like(active)
            if self.slab is not None:
                clampable = clampable | (clamp_s < s_exit)
            if kx:
                n_to_exit = torch.where(going_up, nz + 1 - n_le, n_below)
                clampable = clampable | (n_to_exit > kx)
            thin = active & going_up & (total_od < cfg.cf_dtau) & ~clampable
            surv = -torch.expm1(-total_od)
            tau_use = torch.where(thin, -torch.log1p(-u[11] * surv), tau)

        collided = active & (tau_use < total_od)
        full = cum < tau_use[None, :]
        n_full = torch.sum(full, dim=0)
        l_col = torch.clamp(torch.where(going_up, n_full, nz - 1 - n_full),
                            0, nz - 1)
        if self.use_tiles:
            sig_m = torch.gather(sig_col, 0, l_col[None, :])[0]
        else:
            sig_m = self.scene.sig_maj[l_col]
        cum_before = torch.sum(od * full, dim=0)
        d_before = torch.sum(seg * full, dim=0)
        s_col = d_before + (tau_use - cum_before) / sig_m
        s_star = torch.where(collided, s_col, s_exit)
        s_star = torch.where(active, s_star, 0.0)

        clamped = None
        if self.slab is not None:
            # clamp at the slab face or the remote deck entry: the voxels
            # beyond live in another slab, so the lane advances to the
            # clamp point, freezes and is migrated (reference :668-677)
            clamped = active & (clamp_s < s_star)
            s_star = torch.minimum(s_star, clamp_s)
            collided = collided & ~clamped
        if self.tile_clamp:
            # clamp at the faces of the deck-entry tile (exact by
            # memorylessness: tau is redrawn every step)
            tclamp = can_clamp & (s_tile < s_star)
            s_star = torch.where(tclamp, s_tile, s_star)
            collided = collided & ~tclamp
            if clamped is not None:
                clamped = clamped & ~tclamp
        else:
            tclamp = torch.zeros_like(active)

        zclamp = torch.zeros_like(active)
        if kx:
            # crossing-count clamp (reference :693-726): a flight stops at
            # its kx-th crossing when that lies strictly inside the flight
            # and the domain
            k_iota = torch.arange(kx, device=z.device)
            lev_k = torch.where(going_up[:, None], n_le[:, None] + k_iota,
                                n_below[:, None] - 1 - k_iota)   # (B, kx)
            lev_ok = (lev_k >= 0) & (lev_k <= nz)
            lev_c = torch.clamp(lev_k, 0, nz)
            z_k = z_lev[lev_c]
            s_k = (z_k - z[:, None]) * inv_uz[:, None]
            pos_ok = (s_k > 0.0) | (up0k[:, None] & (k_iota == 0))
            s_zc = s_k[:, -1]
            zclamp = active & lev_ok[:, -1] & (lev_k[:, -1] > 0) \
                & (lev_k[:, -1] < nz) & (s_zc > 0.0) & (s_zc < s_star)
            s_star = torch.where(zclamp, s_zc, s_star)
            collided = collided & ~zclamp
            tclamp = tclamp & ~zclamp
            if clamped is not None:
                clamped = clamped & ~zclamp

        if forcing:
            # the forcing weight, once the collision survived clamping;
            # wsc_pre weighs the deterministic escape branch
            wsc_pre = wsc
            wsc = torch.where(thin & collided, wsc * surv, wsc)
            w_esc = (wsc_pre * torch.exp(-total_od))[:, None, None]

        # traveled path per layer, valid for collided/exit/clamped alike
        trav = torch.minimum(torch.clamp(
            torch.minimum(d_out, s_star[None, :]) - d_in, min=0.0), seg)
        trav = torch.where(active[None, :], trav, 0.0)           # (Nz, B)
        term = active & ~collided & ~tclamp & ~zclamp
        if clamped is not None:
            term = term & ~clamped

        flux, absorbed = c.flux, c.absorbed
        if not self.radiance:
            # ---- level-crossing tallies (reference :739-899), from the
            # flight's start point, with the weights before this step's
            # absorption update ----
            kabs = self.scene.kabs
            trav_b = trav.T                                      # (B, Nz)
            labs_bg = labs[:ng].T                                # (B, Ng)
            chi = torch.where(going_up, 2, torch.where(direct, 0, 1))
            if forcing:
                seg_b = seg.T
            if kx:
                # compact tally: kx rows per lane (zclamp guarantees every
                # crossing of the flight fits); the terminal crossing is
                # admitted explicitly
                final_k = (zclamp[:, None] & (k_iota == kx - 1)) \
                    | ((term & ~going_up)[:, None] & (lev_k == 0)) \
                    | ((term & going_up)[:, None] & (lev_k == nz))
                tally_k = active[:, None] & lev_ok & pos_ok \
                    & ((s_k < s_star[:, None]) | final_k)
                # gas absorption to crossing k: the layers fully traversed
                # before it, below lev_k going up, above it going down
                l_iota = torch.arange(nz, device=z.device)
                mask_k = torch.where(going_up[:, None, None],
                                     l_iota < lev_c[:, :, None],
                                     l_iota >= lev_c[:, :, None])
                a_k = ((mask_k * trav_b[:, None, :]).reshape(-1, nz)
                       @ kabs).reshape(-1, kx, ng)
                w_k = (wsc[:, None, None]
                       * torch.exp(labs_bg[:, None, :] - a_k)
                       * tally_k[:, :, None])
                if forcing:
                    # escape branch of forced flights: every remaining
                    # crossing, absorption over the full flight path
                    a2_k = ((mask_k * seg_b[:, None, :]).reshape(-1, nz)
                            @ kabs).reshape(-1, kx, ng)
                    esc_k = thin[:, None] & lev_ok & pos_ok
                    w_k = w_k + (w_esc * torch.exp(labs_bg[:, None, :] - a2_k)
                                 * esc_k[:, :, None])
                pidx = self._column_rows(x, y, ux, uy, ix0, iy0, s_k, lev_c,
                                         chi)
                if self.scalar_flux:
                    # in-step spectral contraction: one scalar per crossing
                    flux.index_add_(0, pidx, torch.sum(
                        w_k * self.flux_w[lev_c], dim=2).reshape(-1))
                else:
                    flux.index_add_(0, pidx, w_k.reshape(-1, ng))
            elif self.fused_tally:
                # the domain-average tallies below, as one kernel
                domain_tally(self, z, uz, inv_uz, s_star, wsc, labs, trav,
                             active, term, direct, flux, absorbed)
            else:
                # every crossing of the flight; the terminal surface/TOA
                # crossing and the level-0 crossing of a surface-reflected
                # flight are added explicitly
                s_cross = (z_lev[None, :] - z[:, None]) * inv_uz[:, None]
                lev = torch.arange(nz + 1, device=z.device)
                up0 = active & going_up & (z <= 0.0)
                crossed = (active[:, None] & (s_cross > 0.0)
                           & (s_cross < s_star[:, None])) \
                    | ((term & ~going_up)[:, None] & (lev == 0)) \
                    | ((term & going_up)[:, None] & (lev == nz)) \
                    | (up0[:, None] & (lev == 0))
                ee = trav_b[:, :, None] * kabs                   # (B,Nz,Ng)
                pre = torch.cumsum(ee, dim=1)
                a_up = torch.cat([torch.zeros_like(pre[:, :1]), pre], dim=1)
                a_dn = pre[:, -1:, :] - a_up
                w_x = (wsc[:, None, None]
                       * torch.exp(labs_bg[:, None, :] - torch.where(
                           going_up[:, None, None], a_up, a_dn))
                       * crossed[:, :, None])                    # (B,Nlev,Ng)
                if forcing:
                    # escape branch of forced (upward) flights, absorption
                    # over the full path; a surface-reflected one admits
                    # its level-0 crossing
                    ee_f = seg_b[:, :, None] * kabs
                    a_up_f = torch.cat([torch.zeros_like(pre[:, :1]),
                                        torch.cumsum(ee_f, dim=1)], dim=1)
                    esc = thin[:, None] & (
                        (s_cross > 0.0)
                        | ((going_up & (z <= 0.0))[:, None] & (lev == 0)))
                    w_x = w_x + (w_esc * torch.exp(labs_bg[:, None, :] - a_up_f)
                                 * esc[:, :, None])
                if self.tally_absorbed:
                    # direct absorbed-energy tally (MCARaTS Flx_mhrt): per
                    # layer, the weight at path entry minus at path exit
                    hb = torch.where(going_up[:, None, None], a_up[:, :-1],
                                     a_dn[:, 1:])
                    ab_l = (wsc[:, None, None]
                            * torch.exp(labs_bg[:, None, :] - hb)
                            * -torch.expm1(-ee) * active[:, None, None])
                    if forcing:
                        hb_f = torch.where(going_up[:, None, None],
                                           a_up_f[:, :-1],
                                           (a_up_f[:, -1:] - a_up_f)[:, 1:])
                        ab_l = ab_l + (w_esc
                                       * torch.exp(labs_bg[:, None, :] - hb_f)
                                       * -torch.expm1(-ee_f)
                                       * thin[:, None, None])
                    absorbed += torch.sum(ab_l, dim=0)
                    chm = torch.stack([~going_up & direct,
                                       ~going_up & ~direct,
                                       going_up]).to(_F)         # (3, B)
                    flux += torch.einsum('cb,blg->lcg', chm, w_x) \
                        .reshape(-1, ng)
                else:
                    flux.index_add_(0, self._column_rows(
                        x, y, ux, uy, ix0, iy0, s_cross, lev, chi),
                        w_x.reshape(-1, ng))

        if not st.ipa:
            # under IPA x and y never move
            x = torch.where(active, torch.remainder(x + ux * s_star, lx), x)
            if clamped is not None:
                # nudge slab-clamped lanes past the face, so that slab
                # ownership is never ambiguous (reference :903-910)
                x = torch.where(clamped, torch.remainder(
                    x + torch.sign(ux) * (1e-3 * dx), lx), x)
            y = torch.where(active, torch.remainder(y + uy * s_star, ly), y)
            if self.tile_clamp:
                # place tile-clamped lanes robustly past the crossed face
                cxt = tclamp & (sfx <= sfy)
                cyt = tclamp & (sfy <= sfx)
                xf = torch.where(ux > 0, tx_hi, tx_lo)
                yf = torch.where(uy > 0, ty_hi, ty_lo)
                x = torch.where(cxt, torch.remainder(
                    xf + torch.sign(ux) * 1e-3 * dx, lx), x)
                y = torch.where(cyt, torch.remainder(
                    yf + torch.sign(uy) * 1e-3 * dy, ly), y)
        z = torch.where(active, torch.clamp(z + uz * s_star, 0.0, self.z_top),
                        z)
        if clamped is not None and self.roam:
            # a descending roamer clamped at deck entry lands AT the deck
            # top, not an ulp above it, where it would re-clamp with an
            # infinitesimal step forever (reference :922-929)
            z = torch.where(clamped & starts_above & (uz < 0.0),
                            torch.clamp(z, max=self.zd_hi), z)
        if kx:
            # crossing-count-clamped lanes stop EXACTLY on the level, so the
            # next flight's < / <= level counts neither drop nor repeat it
            z = torch.where(zclamp, z_k[:, -1], z)
        hit_sfc = term & ~going_up
        exit_toa = term & going_up
        z = torch.where(hit_sfc, 0.0, z)

        if self.camera:
            # vertical path per layer between the event and the camera
            # altitude (the slant factor is applied at the estimate)
            zc_lo = torch.clamp(z, max=self.cam_z)
            zc_hi = torch.clamp(z, min=self.cam_z)
            sens_path = torch.minimum(torch.clamp(
                torch.minimum(zc_hi[None, :], z_lev[1:, None])
                - torch.maximum(zc_lo[None, :], z_lev[:-1, None]), min=0.0),
                self.dz_lay[:, None])
        else:
            # vertical path per layer above the event, toward the satellite
            sens_path = torch.minimum(torch.clamp(
                z_lev[1:, None] - torch.maximum(z[None, :], z_lev[:-1, None]),
                min=0.0), self.dz_lay[:, None]) / mu_s
        # gas absorption + sensor attenuation in one f32 matmul; the caller
        # keeps TF32 off (run_transport_flight checks), since exp(labs)
        # would otherwise carry ~1e-3 relative error
        big = self.kop_t @ torch.cat([trav, sens_path], dim=0)  # (2Ng+2, B)
        labs = labs - big[:ng + 1]
        tau_sens_abs = big[ng + 1:2 * ng + 1]
        tau_sens_sig = big[2 * ng + 1]
        plen = plen + torch.where(active, s_star, 0.0)

        # ---------------- collision: accept / channel ----------------
        trace.phase('step.collide')
        ix, iy = self._col_index(x, y, ix0, iy0, nscat)
        k3 = torch.clamp(l_col - st.iz3l, 0, st.nz3 - 1)
        if st.has_3d:
            in3 = (l_col >= st.iz3l) & (l_col < st.iz3l + st.nz3)
        else:
            in3 = torch.zeros_like(active)
        if 'vox' in self.ablate:
            # profiling (reference :968-969): the first voxel row for all
            vt = self.vox[0][:, None].expand(-1, x.shape[0])
        else:
            vt = self.vox[(ix.long() * st.ny + iy) * st.nz3 + k3].T
        # vt: (3+3Ns3, B)
        ext_c = torch.where(in3, vt[0], 0.0)

        z_hi_col = z_lev[1:][l_col]
        if st.has_3d:
            below3 = l_col < st.iz3l
            above3 = l_col >= st.iz3l + st.nz3
            tau3_above = torch.where(
                above3, 0.0,
                torch.where(below3, vt[1] + vt[0] * self.dz3_0,
                            vt[1] + vt[0] * (z_hi_col - z))) / mu_s
        else:
            tau3_above = torch.zeros_like(z)

        sig_r = self.scene.sig_ray[l_col]
        # per-constituent 1D aerosol extinction at the collision layer, in
        # the reference's (Na, B) frame (a scan over a size-Na innermost
        # dim of (B, Na) measured 0.75 ms/step on the H100)
        sig_ac = torch.index_select(self.sig_aer_t, 1, l_col)   # (Na, B)
        sig_a = torch.sum(sig_ac, dim=0)
        sig_real = sig_r + sig_a + ext_c
        accept = collided & (u[3] * sig_m < sig_real)

        pick = u[4] * sig_real
        ch_ray = accept & (pick < sig_r)
        ch_aer = accept & ~ch_ray & (pick < sig_r + sig_a)
        ch_cld = accept & ~ch_ray & ~ch_aer
        # 3D constituent by extinction share
        u_c = torch.clamp((pick - sig_r - sig_a)
                          / torch.clamp(ext_c, min=1e-30), 0.0, 1.0 - 1e-7)
        slot = torch.zeros_like(ix)
        for s in range(st.ns3 - 1):
            slot = slot + (u_c >= vt[3 + 3 * s]).to(_I)
        ssa_sel = vt[4]
        apf_sel = vt[5]
        for s in range(1, st.ns3):
            m = slot == s
            ssa_sel = torch.where(m, vt[4 + 3 * s], ssa_sel)
            apf_sel = torch.where(m, vt[5 + 3 * s], apf_sel)
        ssa_c = torch.where(in3, ssa_sel, 1.0)
        apf_c = torch.where(in3, apf_sel, 0.0).to(_I)
        c_aer = torch.clamp(torch.sum(torch.cumsum(sig_ac, dim=0)
                                      < (pick - sig_r)[None, :], dim=0),
                            0, self.n_aer - 1)
        apf_a = self.scene.aer_apf[c_aer]
        ssa_a = self.scene.aer_ssa[c_aer]
        apf = torch.where(ch_cld, apf_c, torch.where(ch_aer, apf_a, 0))
        ssa_ev = torch.where(ch_cld, ssa_c, torch.where(ch_aer, ssa_a, 1.0))

        # scattering cosine toward the sensor (for the camera: toward a
        # point of its aperture, nearest periodic image); one fused lookup
        # of the eval row (TMS rows for never-scattered lanes) and the
        # sample row
        if self.camera:
            cam_x, cam_y = self.cam_x, self.cam_y
            if cfg.cam_apsize > 0:
                # finite aperture (MCARaTS Rad_apsize): a fresh uniform
                # point of the horizontal aperture disk per estimate
                r_ap = cfg.cam_apsize * torch.sqrt(u[12])
                ph_ap = (2.0 * math.pi) * u[13]
                cam_x = cam_x + r_ap * torch.cos(ph_ap)
                cam_y = cam_y + r_ap * torch.sin(ph_ap)
            dxs = torch.remainder(cam_x - x + 0.5 * lx, lx) - 0.5 * lx
            dys = torch.remainder(cam_y - y + 0.5 * ly, ly) - 0.5 * ly
            dzs = self.cam_z - z
            r_cam = torch.clamp(torch.sqrt(dxs * dxs + dys * dys + dzs * dzs),
                                min=cfg.cam_rmin)
            wsx_c, wsy_c, wsz_c = dxs / r_cam, dys / r_cam, dzs / r_cam
            mu_sc = ux * wsx_c + uy * wsy_c + uz * wsz_c
        else:
            mu_sc = ux * sx + uy * sy + uz * mu_s
        if 'phase' in self.ablate:
            # profiling (reference :348-349, 357-358, 1051): the Rayleigh
            # evaluation and a uniform cosine; the kernel is not launched
            k1 = (0.75 * (1.0 + mu_sc * mu_sc), u[5] * 2.0 - 1.0)
        else:
            row_e = apf + direct.to(_I) * self.n_pf
            k1 = (apf, row_e, mu_sc, u[5].contiguous(), self.pt_p, self.pt_mu)
        return k1, _Mid(
            c=c, u=u, x=x, y=y, z=z, ux=ux, uy=uy, uz=uz, wsc=wsc, labs=labs,
            tau=tau, nscat=nscat, alive=alive, ix0=ix0, iy0=iy0, plen=plen,
            direct=direct, launched=launched, active=active, accept=accept,
            collided=collided, hit_sfc=hit_sfc, exit_toa=exit_toa,
            tclamp=tclamp, zclamp=zclamp, clamped=clamped, ix=ix, l_col=l_col,
            vt=vt, z_hi_col=z_hi_col, tau3_above=tau3_above,
            tau_sens_abs=tau_sens_abs, tau_sens_sig=tau_sens_sig,
            ssa_ev=ssa_ev, apf=apf, mu_sc=mu_sc,
            cam=(r_cam, wsx_c, wsy_c, wsz_c) if self.camera else None)

    def _step_post(self, mid: _Mid, pe_pair, mu_new) -> FlightCarry:
        """The step from K1's results (``pe_pair``, ``mu_new``) on: the
        local estimates, the turn and the roulette; ``mid`` as
        :meth:`_step_pre` returns it."""
        st, cfg = self.st, self.cfg
        ng = st.ng
        dx, lx, ly = st.dx, self.lx, self.ly
        sx, sy, mu_s = self.sx, self.sy, self.mu_s
        (c, u, x, y, z, ux, uy, uz, wsc, labs, tau, nscat, alive, ix0, iy0,
         plen, direct, launched, active, accept, collided, hit_sfc, exit_toa,
         tclamp, zclamp, clamped, ix, l_col, vt, z_hi_col, tau3_above,
         tau_sens_abs, tau_sens_sig, ssa_ev, apf, mu_sc, cam) = mid
        if self.camera:
            r_cam, wsx_c, wsy_c, wsz_c = cam
        flux, absorbed = c.flux, c.absorbed

        # ---------------- local estimates ----------------
        trace.phase('step.estimate')
        if self.uniform_sfc:
            srow = self.sfc_tab[0].expand(x.shape[0], 6)
        else:
            if st.nxs == st.nx:
                sxi = self._local_ix(x) if self.pinned else ix
            else:
                # independent surface grid: index by domain fraction
                sxi = torch.clamp(torch.floor(x / lx * st.nxs).to(_I),
                                  0, st.nxs - 1)
            syi = torch.remainder(torch.floor(y / ly * st.nys).to(_I), st.nys)
            srow = self.sfc_tab[sxi.long() * st.nys + syi]
        jsfc_l = srow[:, 0].to(_I)
        psfc_l = srow[:, 1:]

        rad, rad_pl = c.rad, c.rad_pl
        if self.radiance:
            pval = torch.where(apf == 0, 0.75 * (1.0 + mu_sc * mu_sc),
                               pe_pair)
            if self.camera:
                contrib, pidx = self._camera_estimate(
                    l_col, vt, z_hi_col, z, tau3_above, labs, tau_sens_abs,
                    tau_sens_sig, wsc, ssa_ev, pval, r_cam, wsx_c, wsy_c,
                    wsz_c, jsfc_l, psfc_l, ux, uy, uz, accept, hit_sfc)
                pl_det = plen + r_cam
            else:
                t_sens = torch.exp(labs[:ng] - tau_sens_abs
                                   - (tau_sens_sig + tau3_above)[None, :])
                c_vol = (wsc * ssa_ev * pval
                         / (4.0 * math.pi * mu_s))[None, :] * t_sens
                rho_sens = brdf_eval(jsfc_l, psfc_l, ux, uy, uz, sx, sy, mu_s)
                c_sfc = (wsc * rho_sens)[None, :] * t_sens
                contrib = torch.where(accept[None, :], c_vol,
                                      torch.where(hit_sfc[None, :], c_sfc,
                                                  0.0))
                if self.nxr * self.nyr == 1:
                    pidx = None
                elif st.ipa:
                    # IPA: the birth pixel (global column under a slab), no
                    # slant projection
                    pidx = (ix0.long() + self.ix_shift) * self.nyr + iy0
                else:
                    # slant projection onto the TOA image plane, periodic
                    # in x and y
                    xp = torch.remainder(x - sx / mu_s * z, lx)
                    yp = torch.remainder(y - sy / mu_s * z, ly)
                    gix = torch.clamp(torch.floor(xp / dx).to(_I),
                                      0, self.nx_glob - 1)
                    pidx = gix.long() * self.nyr + self._local_iy(yp)
                if cfg.pathlength:
                    # the path so far plus the slant exit path toward TOA
                    pl_det = plen + (self.z_top - z) / mu_s
            if 'firstdep' in self.ablate:
                # diagnostic (reference :1155-1159): first-order deposits
                # dropped; BIASED, never physics
                contrib = torch.where(direct[None, :], 0.0, contrib)
            if self.scalar_rad:
                contrib = self.rad_w @ contrib                   # (B,)
            if self.nxr * self.nyr == 1:
                rad += torch.sum(contrib, dim=-1)
                if cfg.pathlength:
                    rad_pl += torch.sum(contrib * pl_det[None, :], dim=-1)
            else:
                if 'deposit' in self.ablate:
                    # profiling (reference :1202-1206): no image scatter;
                    # the deposits' sum added to every pixel keeps them live
                    rad += torch.sum(contrib)
                else:
                    rad.index_add_(0, pidx,
                                   contrib if self.scalar_rad else contrib.T)
                if cfg.pathlength:
                    rad_pl.index_add_(0, pidx, (contrib * pl_det[None, :]).T)
        if self.tally_absorbed:
            # particulate absorption at accepted collisions (reference
            # :1214-1226): the collision layer absorbs wsc*(1-ssa), seen
            # through the gas transmission to the collision point
            ab_c = torch.where(accept, wsc * (1.0 - ssa_ev), 0.0)
            absorbed.index_add_(0, l_col,
                                (torch.exp(labs[:ng]) * ab_c[None, :]).T)

        # ---------------- direction updates ----------------
        trace.phase('step.turn')
        psi = u[6] * (2.0 * math.pi)
        ux_s, uy_s, uz_s = rotate(ux, uy, uz, mu_new, psi)
        bx, by, bz, bw, (is_cm, whitecap, up_ok) = brdf_sample_dir_weight(
            jsfc_l, psfc_l, ux, uy, uz, u[5], u[6], u[9], u[10])
        ux = torch.where(accept, ux_s, torch.where(hit_sfc, bx, ux))
        uy = torch.where(accept, uy_s, torch.where(hit_sfc, by, uy))
        uz = torch.where(accept, uz_s, torch.where(hit_sfc, bz, uz))
        wsc = torch.where(accept, wsc * ssa_ev,
                          torch.where(hit_sfc, wsc * bw, wsc))
        if self.p3d:
            # partial 3D: the column of the last low-order scatter
            low = accept & (nscat < self.p3d)
            ix0 = torch.where(low, self._local_ix(x), ix0)
            iy0 = torch.where(low, self._local_iy(y), iy0)
        nscat = nscat + accept.to(_I)
        direct = direct & ~accept & ~hit_sfc
        tau = torch.where(active, -torch.log(u[7]), tau)

        # ---------------- termination / roulette ----------------
        trace.phase('step.roulette')
        if self.outcome is not None:
            stopped = tclamp | zclamp
            if clamped is not None:
                stopped = stopped | clamped
            self.outcome += torch.sum(torch.stack(
                [accept, collided, hit_sfc, exit_toa, stopped]), dim=1)
        if self.sfc_branch is not None:
            facet = hit_sfc & is_cm & ~whitecap
            self.sfc_branch += torch.sum(torch.stack(
                [facet & up_ok, hit_sfc & is_cm & whitecap, facet & ~up_ok]),
                dim=1)
        if self.tile_stops is not None:
            self.tile_stops += torch.sum(torch.stack([active, tclamp]), dim=1)
        alive = alive & ~exit_toa & (nscat < cfg.n_scat_max) & (wsc > 0.0)
        wmax = wsc * torch.exp(labs[ng])
        need_rr = active & (wmax < cfg.rr_wmin)
        p_surv = torch.clamp(wmax / cfg.rr_wmin, 0.0, 1.0)
        if cfg.rr_value > 0 and self.radiance and not self.camera:
            # sensor-importance roulette (reference :1258-1268): future
            # deposits scale like wmax times the escape probability toward
            # the sensor, ~1 / (1 + tau_v)
            tau_v = (tau_sens_sig + tau3_above) * mu_s
            p_val = torch.clamp(wmax / ((1.0 + tau_v) * cfg.rr_value),
                                0.05, 1.0)
            need_rr = need_rr | (active & (p_val < 1.0))
            p_surv = torch.minimum(p_surv, p_val)
        die = need_rr & (u[8] > p_surv)
        wsc = torch.where(need_rr & ~die,
                          wsc / torch.clamp(p_surv, min=1e-12), wsc)
        alive = alive & ~die
        trace.phase(None)

        return FlightCarry(x=x, y=y, z=z, ux=ux, uy=uy, uz=uz, wsc=wsc,
                           labs=labs, tau=tau, nscat=nscat, alive=alive,
                           ix0=ix0, iy0=iy0, plen=plen, direct=direct,
                           launched=launched, step=c.step + 1, rad=rad,
                           rad_pl=rad_pl, flux=flux, absorbed=absorbed)

    def _camera_estimate(self, l_col, vt, z_hi_col, z, tau3_above, labs,
                         tau_sens_abs, tau_sens_sig, wsc, ssa_ev, pval,
                         r_cam, wsx_c, wsy_c, wsz_c, jsfc_l, psfc_l, ux, uy,
                         uz, accept, hit_sfc):
        """Point estimate toward the camera (reference :1093-1145): the
        volume and surface terms attenuated along the slant path, masked
        to the field of view, and the fisheye pixel of each event.
        Returns ((Ng, B) contributions, (B,) pixel rows)."""
        st, ng, npix = self.st, self.st.ng, self.nxr
        if st.has_3d and self.cam_above:
            # a camera above the deck top sees the deck part above the
            # event (tau3_above carries the satellite's 1/mu_s)
            tau3_cam = tau3_above * self.mu_s
        elif st.has_3d:
            # else the deck part below the event
            tau3_cam = torch.clamp(torch.where(
                l_col < st.iz3l, 0.0,
                torch.where(l_col >= st.iz3l + st.nz3, vt[2],
                            vt[2] - vt[1] - vt[0] * (z_hi_col - z))), min=0.0)
        else:
            tau3_cam = torch.zeros_like(z)
        slant = r_cam / torch.clamp(torch.abs(z - self.cam_z), min=1.0)
        t_sens = torch.exp(labs[:ng] - slant[None, :] * tau_sens_abs
                           - (slant * (tau_sens_sig + tau3_cam))[None, :])
        c_vol = (wsc * ssa_ev * pval
                 / (4.0 * math.pi * r_cam * r_cam))[None, :] * t_sens
        # fisheye pixel (equidistant projection) in the camera frame
        (r00, r01, r02), (r10, r11, r12), (r20, r21, r22) = self.cam_rot
        vx = r00 * -wsx_c + r01 * -wsy_c + r02 * -wsz_c
        vy = r10 * -wsx_c + r11 * -wsy_c + r12 * -wsz_c
        vz = r20 * -wsx_c + r21 * -wsy_c + r22 * -wsz_c
        theta = torch.arccos(torch.clamp(vz, -1.0, 1.0))
        phi_c = torch.atan2(vy, vx)
        in_fov = theta <= self.cam_qmax
        # surface estimate: rho(wi -> ws) cos(theta_out) / r^2
        rho_cam = brdf_eval(jsfc_l, psfc_l, ux, uy, uz, wsx_c, wsy_c, wsz_c)
        c_sfc = (wsc * rho_cam * torch.clamp(wsz_c, min=0.0)
                 / (r_cam * r_cam))[None, :] * t_sens
        contrib = torch.where((accept & in_fov)[None, :], c_vol,
                              torch.where((hit_sfc & in_fov)[None, :],
                                          c_sfc, 0.0))
        pr = torch.clamp(theta / self.cam_qmax, 0.0, 0.999)
        px = torch.clamp(((0.5 + 0.5 * pr * torch.cos(phi_c)) * npix)
                         .to(_I), 0, npix - 1)
        py = torch.clamp(((0.5 + 0.5 * pr * torch.sin(phi_c)) * npix)
                         .to(_I), 0, npix - 1)
        return contrib, px.long() * npix + py


# one side stream a device for every capture (a capture cannot use the
# default stream): each stream that runs a matmul keeps a cuBLAS workspace
# (32 MiB on the H100) for the life of the process
_CAPTURE_STREAMS = {}


class _StepGraphs:
    """The flight step at one batch width as two captured CUDA graphs.

    Issued one by one from Python, the step's ~600-720 small kernels keep
    the card idle most of the step.  Graph ``pre`` is
    :meth:`FlightKernel._step_pre` on static lanes and deviates; the
    phase-pair kernel (K1) is then launched eagerly on its outputs by
    :meth:`FlightKernel._pair`, as in the eager step, which copies its
    results to where graph ``post`` reads them (under the ``'phase'``
    ablation ``post`` reads ``pre``'s stand-in pair); ``post`` is
    :meth:`FlightKernel._post_half` writing the new lanes into the static
    lanes, so the carry it leaves is the next step's input.

    The tallies, the outcome counts and ``q_off`` are captured where they
    lie; a carry that holds them elsewhere is captured anew: ``pre``
    before its first replay, ``post`` after K1's launch, on the pair that
    launch leaves.  Lanes and deviates handed in from elsewhere (the first
    replayed step, after a drain compaction or a lane sort) are copied in
    first.  Both graphs of a capture share one private memory pool, freed
    with them."""

    def __init__(self, kern: FlightKernel, c: FlightCarry, u, u_split,
                 u_imp):
        self.kern = kern
        self.lanes = {f: torch.empty_like(getattr(c, f))
                      for f in _LANE_FIELDS + ('launched',)}
        self.inputs = {'u': torch.empty_like(u)}
        if u_split is not None:
            self.inputs['u_split'] = u_split.new_empty((1, u_split.shape[0]))
        if u_imp is not None:
            self.inputs['u_imp'] = torch.empty_like(u_imp)
        self.pair = (torch.empty_like(c.x), torch.empty_like(c.x))
        # what the graphs were captured with: the tallies they deposit into
        # (and the key of their addresses), their memory pool
        self.key = self.tallies = self.pool = None
        self.pre = self.post = self.k1 = self.mid = None

    def run(self, c: FlightCarry, u, q_off, u_split, u_imp) -> FlightCarry:
        """One step of ``c`` by replay (see :meth:`FlightKernel.step`)."""
        kern = self.kern
        for f, t in self.lanes.items():
            v = getattr(c, f)
            if v is not t:
                t.copy_(v)
        for name, v in (('u', u), ('u_split', u_split), ('u_imp', u_imp)):
            if v is not None and v.data_ptr() != self.inputs[name].data_ptr():
                self.inputs[name].copy_(v)
        key = tuple(t.data_ptr() if isinstance(t, torch.Tensor) else t
                    for t in (c.rad, c.rad_pl, c.flux, c.absorbed,
                              kern.outcome, q_off))
        fresh = key != self.key
        if fresh:
            inp = self.inputs
            carry = c._replace(**self.lanes)
            u_split = inp['u_split'][0] if 'u_split' in inp else None
            self.key, self.pool = key, None
            self.tallies = (c.rad, c.rad_pl, c.flux, c.absorbed)
            with trace.span('flight.graph.capture'):
                self.pre, (self.k1, self.mid) = self._capture(
                    lambda: kern._step_pre(carry, inp['u'], q_off, u_split,
                                           inp.get('u_imp')))
        self.pre.replay()
        pair = kern._pair(self.k1, out=self.pair)
        if fresh:
            with trace.span('flight.graph.capture'):
                self.post, _ = self._capture(
                    lambda: kern._post_half(self.mid, *pair, out=self.lanes))
            kern.graph_stats['captures'] += 2
        self.post.replay()
        kern.graph_stats['replays'] += 1
        return c._replace(step=c.step + 1, **self.lanes)

    def _capture(self, fn):
        """``fn()`` recorded, not run, as a CUDA graph in this width's
        memory pool, on the device's capture stream; returns (graph, its
        results)."""
        g = torch.cuda.CUDAGraph()
        dev = self.kern.device
        if dev not in _CAPTURE_STREAMS:
            _CAPTURE_STREAMS[dev] = torch.cuda.Stream(dev)
        with torch.cuda.stream(_CAPTURE_STREAMS[dev]):
            g.capture_begin(pool=self.pool)
            try:
                out = fn()
            finally:
                g.capture_end()
        self.pool = g.pool()
        return g, out


def flight_step(kern: FlightKernel, gen: torch.Generator, c: FlightCarry,
                q_off) -> FlightCarry:
    """One :meth:`FlightKernel.step` of the lanes of ``c``, its deviates
    drawn from ``gen`` (into the graphs' buffers where their width
    replays): ``u``, ``u_split`` with ``split_wmax`` > 0, ``u_imp`` with
    the camera-importance launch; the spans ``flight.deviates`` and
    ``flight.step``."""
    b = c.x.shape[0]
    g = kern.graphs.get(b) if kern.graphs is not None else None
    buf = g.inputs if g is not None else {}
    with trace.span('flight.deviates'):
        kw = {}
        u = draw_deviates(gen, b, kern.device, out=buf.get('u'))
        if kern.cfg.split_wmax > 0:
            kw['u_split'] = draw_deviates(gen, b, kern.device, rows=1,
                                          out=buf.get('u_split'))[0]
        if kern.cam_importance:
            kw['u_imp'] = draw_deviates(gen, b, kern.device, rows=3,
                                        out=buf.get('u_imp'))
    with trace.span('flight.step'):
        return kern.step(c, u, q_off, **kw)


def column_flux(kern: FlightKernel, c: FlightCarry) -> torch.Tensor:
    """The flux tally of ``c`` unpacked as (Nxf, Nyf, Nz+1, 3, Ng) (Ng -> 1
    with the in-step contraction), with the deterministic TOA down-direct
    entry added in f32: exactly 1 per launched photon (factor-contracted
    with ``flux_w``), spread over the columns (reference :1483-1497)."""
    nz = kern.st.nz
    flux = c.flux.reshape(kern.nxf, kern.nyf, nz + 1, 3, -1)
    toa1 = torch.sum(kern.flux_w[nz]) if kern.scalar_flux else 1.0
    flux[:, :, nz, 0, :] += (c.launched.to(_F) * toa1
                             / (kern.nxf * kern.nyf))
    return flux


def transport_flight(scene: SceneArrays, st: SceneStatic, cfg: SolverConfig,
                     n_photon: int, gen: torch.Generator, flux_w=None,
                     rad_w=None, stats: dict | None = None) -> Tallies:
    """Run ``n_photon`` photons to completion (reference :1383-1503).

    Deviates and the stratified-launch offset come from ``gen``, which must
    live on the scene's device; the splitting and camera-importance
    deviates are drawn only when their option is on.  The loop condition
    is read back from the device once per step, or once per block of
    ``cfg.sort_every`` steps, each block starting with a lane sort.
    Without sorting, once the budget is launched and the survivors fit,
    lanes are compacted alive-first into B/8 and then B/64 batches (each
    lane keeps its own state; later deviates are fresh draws).
    ``stats``: optional dict that receives ``stage_steps``, the steps run
    at the full batch and in each drain stage, ``max_steps``, the step cap
    (reference :1396-1399), ``in_flight``, the lanes still alive when the
    loop ended (non-zero only for a run stopped at its cap, whose photons
    in flight tally no more), and, where the condition is read before every
    step and no lane splits, ``lane_slots`` and ``idle_lanes``: the lane
    slots of all steps, and those of them with no live photon (a step's
    live lanes are those alive before it and those it launches, from the
    two numbers read back), ``graph_steps``, the steps replayed from
    captured CUDA graphs, and ``fused_post_steps``, the steps whose post
    half ran as one kernel: all of them where ``FlightKernel.fused_post``
    holds, else none.  On the card the step replays: the first step at
    each batch width runs eagerly, every later one replays that width's
    two graphs (:meth:`FlightKernel.step`), into whose buffers
    :func:`flight_step` draws the deviates; the graphs and their memory
    are freed before the flight returns.  Traced
    (:mod:`er3t_tpu_torch.util.trace`), the loop records the spans
    ``flight.deviates``, ``flight.step``, ``flight.read`` and
    ``flight.compact`` (and ``flight.graph.capture`` around each graph's
    capture), those counts as the counters ``flight.lane_slots`` and
    ``flight.idle_lanes``, the graphs captured, the steps replayed and the
    steps run eagerly while replaying as ``flight.graph.captures``,
    ``flight.graph.replays`` and ``flight.graph.eager_steps``, the fused
    post halves as ``flight.post.fused_steps``, and the classes of every
    active lane iteration (:data:`OUTCOMES`, counted on the device and
    read once at the end) as ``flight.iter_outcome.<class>`` and in
    ``stats['iter_outcome']``.  Traced or given ``stats``, a flight over a
    surface other than Lambertian counts its surface hits by Cox-Munk
    branch (``stats['sfc_branch']``, {branch: hits}, the counters
    ``flight.sfc.<branch>``), and one with tile clamps its ``active`` lane
    iterations and those ``clamped`` at a tile face
    (``stats['tile_stops']``, the counter ``flight.tile_clamps``), read
    back with the outcome counts.  Flux tallies come back as
    :func:`column_flux` unpacks them; ``rad_plen`` is the (Nxr, Nyr, Ng)
    pathlength-weighted image with ``cfg.pathlength``.
    """
    kern = FlightKernel(scene, st, cfg, n_photon, rad_w=rad_w, flux_w=flux_w)
    dev = kern.device
    n = kern.n_photon
    max_steps = cfg.max_events or (n // cfg.batch + 2) * 400
    stages = []
    if cfg.drain_compact and cfg.sort_every == 0 and cfg.batch >= 2048:
        b_s = cfg.batch // 8
        while b_s >= 256 and len(stages) < 2:
            stages.append(b_s)
            b_s //= 8
    q_off = (torch.randint(0, kern.n_cell, (), generator=gen, device=dev)
             if kern.strat else 0)
    if trace.enabled():
        kern.outcome = torch.zeros(len(OUTCOMES), dtype=torch.int64,
                                   device=dev)
    if trace.enabled() or stats is not None:
        if not st.sfc_lambertian:
            kern.sfc_branch = torch.zeros(len(SFC_BRANCHES),
                                          dtype=torch.int64, device=dev)
        if kern.tile_clamp:
            kern.tile_stops = torch.zeros(2, dtype=torch.int64, device=dev)
    # lane slots and idle lanes, where every step's live lanes are known
    lanes = [0, 0] if cfg.sort_every == 0 and cfg.split_wmax <= 0 else None

    def step(c, b, n_alive=None, launched=None):
        if lanes is not None:
            lanes[0] += b
            lanes[1] += b - n_alive - min(b - n_alive, n - launched)
        return flight_step(kern, gen, c, q_off)

    if dev.type == 'cuda':
        # replay the step's kernels as captured graphs (FlightKernel.step)
        kern.graphs = {}
    try:
        c = kern.carry0(cfg.batch)
        b1 = stages[0] if stages else None
        while True:
            n_alive, launched = read_counts(c, dev)
            more = (n_alive > 0 or launched < n) and c.step < max_steps
            if b1 is not None:
                more = more and (launched < n or n_alive > b1)
            if not more:
                break
            if cfg.sort_every > 0:
                # a sort, then a block of steps; the condition is checked per
                # block (a few steps of overshoot in the drain tail are
                # harmless: dead lanes tally nothing)
                c = _sort_lanes(c, st)
                for _ in range(cfg.sort_every):
                    c = step(c, cfg.batch)
            else:
                c = step(c, cfg.batch, n_alive, launched)
        lane_iters = c.step * cfg.batch
        stage_steps = [c.step]
        for si, b_s in enumerate(stages):
            prev = c.step
            with trace.span('flight.compact'):
                order = torch.argsort((~c.alive).to(_I), stable=True)
                c = _take_lanes(c, order[:b_s])
            nxt = stages[si + 1] if si + 1 < len(stages) else 0
            while True:
                n_alive, launched = read_counts(c, dev)
                if n_alive <= nxt or c.step >= max_steps:
                    break
                c = step(c, b_s, n_alive, launched)
            lane_iters += (c.step - prev) * b_s
            stage_steps.append(c.step - prev)
    finally:
        if kern.graphs:
            # drop the graphs, and free their memory pools
            kern.graphs.clear()
            torch.cuda.empty_cache()

    for k, v in kern.graph_stats.items():
        trace.count('flight.graph.' + k, v)
    if stats is not None:
        stats.update(stage_steps=stage_steps, max_steps=max_steps,
                     in_flight=read_counts(c, dev)[0],
                     graph_steps=kern.graph_stats['replays'])
    # the counts that go to both: (stats key, value, its counters)
    fused = c.step if kern.fused_post else 0
    counts = [('fused_post_steps', fused, {'flight.post.fused_steps': fused})]
    if lanes is not None:
        counts += [(k, v, {'flight.' + k: v})
                   for k, v in zip(('lane_slots', 'idle_lanes'), lanes)]
    # the device's counters, read back once
    ctrs = [t for t in (kern.outcome, kern.sfc_branch, kern.tile_stops)
            if t is not None]
    vals = iter(torch.cat(ctrs).tolist() if ctrs else ())
    if kern.outcome is not None:
        v = {k: next(vals) for k in OUTCOMES}
        v['null'] -= v['real']              # counted as tentative
        counts.append(('iter_outcome', v, {'flight.iter_outcome.' + k: n
                                           for k, n in v.items()}))
    if kern.sfc_branch is not None:
        v = {k: next(vals) for k in SFC_BRANCHES}
        counts.append(('sfc_branch', v,
                       {'flight.sfc.' + k: n for k, n in v.items()}))
    if kern.tile_stops is not None:
        v = {k: next(vals) for k in ('active', 'clamped')}
        counts.append(('tile_stops', v, {'flight.tile_clamps': v['clamped']}))
    for key, v, names in counts:
        for name, n in names.items():
            trace.count(name, n)
        if stats is not None:
            stats[key] = v
    ng_r = 1 if kern.scalar_rad else st.ng
    flux = (torch.zeros((1, 1, st.nz + 1, 3, st.ng), dtype=_F, device=dev)
            if kern.radiance else column_flux(kern, c))
    rad_plen = (c.rad_pl.reshape(kern.nxr, kern.nyr, st.ng) if cfg.pathlength
                else torch.zeros((), dtype=_F, device=dev))
    return Tallies(
        rad=c.rad.reshape(kern.nxr, kern.nyr, ng_r),
        flux=flux,
        n_launched=c.launched,
        n_steps=torch.tensor(c.step, dtype=torch.int64),
        rad_plen=rad_plen,
        lane_iters=torch.tensor(float(lane_iters), dtype=torch.float64),
        absorbed=c.absorbed)


def run_transport_flight(scene: SceneArrays, static: SceneStatic,
                         cfg: SolverConfig, n_photon: int, seed: int,
                         device='cuda', flux_w=None, rad_w=None,
                         stats=None) -> Tallies:
    """Entry point: one run on ``device`` (the card unless the caller asks
    for the CPU; the scene must be there) with a fresh generator seeded by
    ``seed``.  ``flux_w``: optional (Nz+1, Ng) spectral factors; per-column
    flux crossings (``flux_kcross`` > 0) are then contracted over g in the
    step, and ``Tallies.flux`` has a singleton g axis.  ``rad_w``: optional
    (Ng,) spectral factors, the same for radiance image deposits
    (``Tallies.rad``; not with ``cfg.pathlength``).  ``stats``: see
    :func:`transport_flight`."""
    device = resolve_device(scene, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return transport_flight(scene, static, cfg, int(n_photon), gen,
                            flux_w=flux_w, rad_w=rad_w, stats=stats)

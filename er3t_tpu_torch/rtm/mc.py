"""Solver configuration, tallies and the event-marching engine (port of
``er3t_tpu/rtm/mc.py``).

``SolverConfig`` keeps the reference's fields, defaults, order and
frozen-dataclass form, so one set of keyword arguments configures both
packages.  The field docs are abridged here — the reference module carries
the full notes.

:func:`transport` is the reference's event-marching engine (:288-686): each
step advances every lane to the nearer of its next tentative collision
against the per-layer majorant and its layer boundary, so one crossing is
tallied per lane and step.  It is the bitwise reference path of the flux
targets (``flux_engine='marching'``) and runs satellite radiance too.  What
differs from the reference is the execution shape, as in
:mod:`~.mc_flight`: :meth:`MarchingKernel.step` is one loop body of
``(carry, u)`` that draws nothing, the loop runs in Python with its deviates
from an explicit ``torch.Generator``, the two phase-table lookups go
through :func:`~.phase_pair.phase_pair` (the hand-written CUDA kernel on the
card), and the flux tally is unpacked rows (the reference's 8-rows-per-lane
packing is a TPU layout device).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..util import trace
from .brdf import brdf_eval, brdf_sample_dir_weight
from .phase_pair import phase_pair

__all__ = ['SolverConfig', 'Tallies', 'MarchingCarry', 'MarchingKernel',
           'transport', 'run_transport', 'draw_deviates']

_F = torch.float32
_I = torch.int32
_U_LO = np.float32(1e-7)                 # deviates lie in [1e-7, 1 - 1e-7]
_U_HI = np.float32(1.0 - 1e-7)


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Static solver configuration (hashable)."""
    target: str = 'radiance'           # 'radiance' | 'flux' | 'heating_rate'
    batch: int = 1 << 17               # photon lanes
    sensor_zenith: float = 0.0         # deg
    sensor_azimuth: float = 0.0        # deg
    flux_per_column: bool = False      # tally fluxes per (x, y) column
    max_events: int = 0                # step cap; 0 -> the engine's default:
    #                                     flight (n // batch + 2) * 400,
    #                                     marching ceil(n / batch + 1)
    #                                     * 4 * (nz + 40)
    rr_wmin: float = 0.1               # Russian-roulette threshold
    rr_value: float = 0.0              # >0: sensor-importance roulette
    n_scat_max: int = 2000
    p3d_order: int = 0                 # >0: partial-3D column pinning
    pathlength: bool = False           # mean pathlength tally (Rad_mplen)
    sensor_type: str = 'satellite'     # 'satellite' | 'camera'
    use_pallas: bool = False           # accepted for parity with the
    #                                     reference; the port's phase-pair
    #                                     lookup is exact f32 either way
    cf_dtau: float = 0.0               # >0: collision forcing threshold
    flux_engine: str = 'flight'        # 'flight' | 'marching' (one level
    #                                     crossing per step: the bitwise
    #                                     reference path of flux targets)
    flux_kcross: int = 4               # per-column flux crossing clamp:
    #                                     at most this many level crossings
    #                                     per flight (0: no clamp)
    tile_size: int = 0                 # >0: per-tile scattering majorants
    split_wmax: float = 0.0            # >0: weight-window splitting
    cam_xpos: float = 0.5              # camera position, domain fractions
    cam_ypos: float = 0.5
    cam_zloc: float = 0.0              # camera altitude [m]
    cam_phi: float = 0.0               # Z-Y-Z Euler camera pointing [deg]
    cam_the: float = 0.0
    cam_psi: float = 0.0
    cam_qmax: float = 89.0             # fisheye half-angle [deg]
    cam_npix: int = 64                 # image is (cam_npix, cam_npix)
    cam_rmin: float = 50.0             # point-estimator distance clamp [m]
    cam_apsize: float = 0.0            # aperture radius [m]
    qmc_launch: bool = False           # stratified-jitter launch
    launch_coherent: bool = False      # stratified launch, linear cell map
    cam_importance_sigma: float = 0.0  # camera importance-sampled launch
    drain_compact: bool = True         # compact survivors into B/8, B/64
    #                                     batches once the budget is launched
    sort_every: int = 0                # >0: periodic lane re-sort
    ablate: str = ''                   # profiling only: a comma-joined
    #                                     subset of {'vox', 'phase',
    #                                     'deposit', 'firstdep'}; the flight
    #                                     kernel replaces that gather or
    #                                     scatter by a stand-in ('firstdep'
    #                                     drops first-order radiance
    #                                     deposits, a biased diagnostic);
    #                                     the marching engine ignores it.
    #                                     NEVER use for physics


class Tallies(NamedTuple):
    """Raw transport tallies, in photon-weight units (torch tensors)."""
    rad: torch.Tensor             # (Nxr, Nyr, Ng), or (Nxr, Nyr, 1) with rad_w;
    #                               (Nx, Ny) satellite, (npix, npix) camera
    flux: torch.Tensor            # (Nxf, Nyf, Nz+1, 3, Ng) level crossings,
    #                               channels (down-direct, down-diffuse, up);
    #                               (..., 1) with flux_w; zeros for radiance
    n_launched: torch.Tensor      # () int64
    n_steps: torch.Tensor         # () int64 loop steps
    rad_plen: torch.Tensor        # (Nxr, Nyr, Ng) pathlength-weighted image
    #                               with cfg.pathlength, else a 0-d zero
    lane_iters: torch.Tensor      # () float64 sum over steps of batch width
    absorbed: torch.Tensor        # (Nz, Ng) direct absorbed-energy tally of
    #                               domain-average flux runs (MCARaTS
    #                               Flx_mhrt), else (1, 1) zeros


def _sensor_dir(cfg: SolverConfig):
    """Unit vector of radiation travelling TOWARD the sensor (upward)."""
    th = np.deg2rad(cfg.sensor_zenith)
    # sensor azimuth: position angle of the sensor from the target
    # (0 = north = +y), so travel direction components:
    ph = np.deg2rad(270.0 - cfg.sensor_azimuth)
    mu_s = float(np.cos(th))
    sx = float(np.sin(th) * np.cos(ph))
    sy = float(np.sin(th) * np.sin(ph))
    return sx, sy, mu_s


def draw_deviates(gen: torch.Generator, batch: int, device,
                  rows: int = 14, out=None) -> torch.Tensor:
    """(rows, batch) uniforms mapped to [1e-7, 1-1e-7] as
    ``jax.random.uniform`` maps them (``u * (hi - lo) + lo``, then
    ``max(lo, .)``); drawn into ``out`` where given (the same numbers)."""
    u = torch.rand((rows, batch), generator=gen, dtype=_F, device=device,
                   out=out)
    return u.mul_(float(_U_HI - _U_LO)).add_(float(_U_LO)) \
        .clamp_(min=float(_U_LO))


def read_counts(c, device) -> list:
    """The loop condition's two numbers of carry ``c``, lanes alive and
    photons launched, read back from ``device``.  Traced, the read is the
    span ``flight.read``: ``flight.read.wait`` until the device has done
    the work queued so far (a CUDA event), then ``flight.read.copy``."""
    if not trace.enabled():
        return torch.stack([torch.sum(c.alive), c.launched]).tolist()
    with trace.span('flight.read'):
        with trace.span('flight.read.wait'):
            if device.type == 'cuda':
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(device))
                ev.synchronize()
        with trace.span('flight.read.copy'):
            return torch.stack([torch.sum(c.alive), c.launched]).tolist()


def rotate(ux, uy, uz, mu, psi):
    """Turn (ux, uy, uz) by polar cosine ``mu`` and azimuth ``psi``
    (reference :444-461)."""
    sin_t = torch.sqrt(torch.clamp(1.0 - mu * mu, min=0.0))
    cp, sp = torch.cos(psi), torch.sin(psi)
    denom = torch.sqrt(torch.clamp(1.0 - uz * uz, min=1e-12))
    straight = torch.abs(uz) > 0.99999
    nx_ = sin_t * (ux * uz * cp - uy * sp) / denom + ux * mu
    ny_ = sin_t * (uy * uz * cp + ux * sp) / denom + uy * mu
    nz_ = -sin_t * cp * denom + uz * mu
    ux_n = torch.where(straight, sin_t * cp, nx_)
    uy_n = torch.where(straight, sin_t * sp, ny_)
    uz_n = torch.where(straight, mu * torch.sign(uz), nz_)
    norm = torch.rsqrt(ux_n ** 2 + uy_n ** 2 + uz_n ** 2)
    return ux_n * norm, uy_n * norm, uz_n * norm


def resolve_device(scene, device) -> torch.device:
    """The device of a run (an index-less ``'cuda'`` is the current card),
    checked against the scene's tensors and, on the card, against TF32
    matmuls (the absorption matmuls feed exp() in f32)."""
    device = torch.device(device)
    if device.type == 'cuda' and device.index is None:
        device = torch.device('cuda', torch.cuda.current_device())
    for name, t in zip(scene._fields, scene):
        if t.device != device:
            raise ValueError(f'scene.{name} is on {t.device}, not {device}')
    if device.type == 'cuda' and torch.backends.cuda.matmul.allow_tf32:
        raise ValueError('torch.backends.cuda.matmul.allow_tf32 must be False: '
                         'the absorption matmuls feed exp() in f32')
    return device


class MarchingCarry(NamedTuple):
    """Loop state of the marching engine (the reference's ``_State``):
    per-lane fields are (B,), ``S`` is (B, Nz)."""
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    l: torch.Tensor          # int32 current layer
    ux: torch.Tensor
    uy: torch.Tensor
    uz: torch.Tensor
    wsc: torch.Tensor        # scattering / roulette weight factor
    S: torch.Tensor          # (B, Nz) per-layer pathlength [m]
    tau: torch.Tensor        # remaining majorant optical depth
    nscat: torch.Tensor      # int32
    direct: torch.Tensor     # bool: never scattered or reflected
    alive: torch.Tensor      # bool
    ix0: torch.Tensor        # int32 birth column (IPA gathers and tallies)
    iy0: torch.Tensor
    launched: torch.Tensor   # () int64, on the device
    step: int                # loop steps taken
    rad: torch.Tensor        # (Nx*Ny, Ng) image for radiance, else (1, Ng)
    flux: torch.Tensor       # (Nxf*Nyf*(Nz+1)*3, Ng) level crossings for
    #                          flux targets, else (1, Ng)


class MarchingKernel:
    """Scene-derived tables and the step function of the marching loop
    (the closure of the reference's ``transport``, :296-652).

    Tables (reference :303-341): ``lay_tab`` (Nz, 4+Na) = [z_lo, z_hi,
    sig_maj, sig_ray, sig_aer...], ``vox3`` (Nvox, 1+3 Ns3) = [ext, then
    per 3D slot (cf, ssa, apf)], the cumulative 1D profiles ``cum_sig``
    (Nz+1,) and ``cum_abs`` (Nz+1, Ng) above each level, the per-column
    cumulative 3D extinction ``cum3d`` and ``kabs_min``.  Tensors live on
    the scene's device; scalar constants are Python floats, or 0-d f32
    tensors where the reference computes them in f32.
    """

    def __init__(self, scene, st, cfg: SolverConfig, n_photon: int):
        self.scene, self.st, self.cfg = scene, st, cfg
        self.n_photon = int(n_photon)
        dev = self.device = scene.z_lev.device
        nz, ng = st.nz, st.ng
        self.radiance = cfg.target == 'radiance'
        self.nlev = nz + 1
        self.nxf, self.nyf = ((st.nx, st.ny) if cfg.flux_per_column
                              else (1, 1))
        self.lx = st.nx * st.dx
        self.ly = st.ny * st.dy

        z_lev = scene.z_lev
        dz_lay = z_lev[1:] - z_lev[:-1]
        self.n_aer = scene.sig_aer.shape[1]
        self.sig_1d = scene.sig_ray + torch.sum(scene.sig_aer, dim=1)
        zero = torch.zeros(1, dtype=_F, device=dev)
        self.cum_sig = torch.cat([torch.flip(torch.cumsum(
            torch.flip(self.sig_1d * dz_lay, [0]), 0), [0]), zero])
        self.cum_abs = torch.cat([torch.flip(torch.cumsum(
            torch.flip(scene.kabs * dz_lay[:, None], [0]), 0), [0]),
            torch.zeros((1, ng), dtype=_F, device=dev)])
        dz3 = dz_lay[st.iz3l:st.iz3l + st.nz3]
        self.cum3d = torch.cat([torch.flip(torch.cumsum(torch.flip(
            scene.ext3d * dz3, [-1]), -1), [-1]),
            torch.zeros((st.nx, st.ny, 1), dtype=_F, device=dev)],
            dim=-1).reshape(-1)
        self.ext3d = scene.ext3d.reshape(-1)
        self.lay_tab = torch.cat([torch.stack(
            [z_lev[:-1], z_lev[1:], scene.sig_maj, scene.sig_ray], dim=1),
            scene.sig_aer], dim=1)
        ns3 = st.ns3
        self.vox3 = torch.cat([self.ext3d[:, None], torch.stack(
            [scene.cf3d.reshape(-1, ns3), scene.ssa3d.reshape(-1, ns3),
             scene.apf3d.reshape(-1, ns3).to(_F)], dim=2)
            .reshape(-1, 3 * ns3)], dim=1)
        self.kabs_min = torch.amin(scene.kabs, dim=1)
        self.n_pf = scene.pt_mu.shape[0]
        self.pt_p = scene.pt_p.contiguous()
        self.pt_mu = scene.pt_mu.contiguous()

        self.sx, self.sy, self.mu_s = _sensor_dir(cfg)
        self.nadir = abs(cfg.sensor_zenith) < 1e-3
        # the deck's level altitudes as 0-d f32 tensors (the slant sensor
        # path computes its midpoints in f32, as the reference does)
        self.z_deck = [z_lev[st.iz3l + k] for k in range(st.nz3 + 1)]

        # solar launch direction, computed on the device in f32 as the
        # reference does, then held as exact Python floats
        sin0 = torch.sqrt(torch.clamp(1.0 - scene.mu0 ** 2, min=0.0))
        self.u0x = float(sin0 * torch.cos(scene.phi0))
        self.u0y = float(sin0 * torch.sin(scene.phi0))
        self.u0z = float(-scene.mu0)
        self.z_top = float(z_lev[-1])
        self.sfc_tab = torch.cat([scene.jsfc.reshape(-1, 1).to(_F),
                                  scene.psfc.reshape(-1, 5)], dim=1)

    def max_steps(self) -> int:
        """The step cap: ``cfg.max_events``, else the reference's default
        ``ceil(n / batch + 1) * 4 * (nz + 40)`` (:355-359)."""
        cfg = self.cfg
        if cfg.max_events:
            return int(cfg.max_events)
        return int(np.ceil(self.n_photon / cfg.batch + 1) * 4
                   * (self.st.nz + 40))

    def carry0(self, batch: int) -> MarchingCarry:
        """All-dead initial state for ``batch`` lanes."""
        dev, st = self.device, self.st
        z = torch.zeros(batch, dtype=_F, device=dev)
        zi = torch.zeros(batch, dtype=_I, device=dev)
        zb = torch.zeros(batch, dtype=torch.bool, device=dev)
        rows_r = st.nx * st.ny if self.radiance else 1
        rows_f = 1 if self.radiance else self.nxf * self.nyf * self.nlev * 3
        return MarchingCarry(
            x=z, y=z.clone(), z=z.clone(), l=zi, ux=z.clone(), uy=z.clone(),
            uz=z.clone(), wsc=z.clone(),
            S=torch.zeros((batch, st.nz), dtype=_F, device=dev),
            tau=z.clone(), nscat=zi.clone(), direct=zb, alive=zb.clone(),
            ix0=zi.clone(), iy0=zi.clone(),
            launched=torch.zeros((), dtype=torch.int64, device=dev), step=0,
            rad=torch.zeros((rows_r, st.ng), dtype=_F, device=dev),
            flux=torch.zeros((rows_f, st.ng), dtype=_F, device=dev))

    def _col_index(self, x, y, ix0, iy0):
        """(ix, iy) of the 3D grid column; IPA pins the birth column."""
        if self.st.ipa:
            return ix0, iy0
        return (torch.remainder(torch.floor(x / self.st.dx).to(_I), self.st.nx),
                torch.remainder(torch.floor(y / self.st.dy).to(_I), self.st.ny))

    def _w_full(self, wsc, S):
        """(B, Ng) physical weights: scattering factor x gas transmission."""
        return wsc[:, None] * torch.exp(-(S @ self.scene.kabs))

    def _sensor_trans(self, x, y, z, l, ix, iy, S):
        """(B, Ng) attenuation from the event to TOA along the sensor
        direction times the photon's own gas transmission (reference
        :384-417): the nadir column of the 3D deck, or the slant path
        sampled at one midpoint column per deck layer."""
        st, scene = self.st, self.scene
        z_lev, kabs = scene.z_lev, scene.kabs
        lo = l.long()
        dz_up = z_lev[lo + 1] - z
        tau_sig = self.cum_sig[lo + 1] + self.sig_1d[lo] * dz_up
        tau_abs = self.cum_abs[lo + 1] + kabs[lo] * dz_up[:, None]
        col = ix.long() * st.ny + iy
        if self.nadir:
            k = torch.clamp(l - st.iz3l, 0, st.nz3 - 1)
            in3 = (l >= st.iz3l) & (l < st.iz3l + st.nz3)
            z_k = z_lev[torch.clamp(lo + 1, 0, st.nz)]
            part3 = self.ext3d[col * st.nz3 + k] * (z_k - z)
            tau3 = torch.where(
                in3, self.cum3d[col * (st.nz3 + 1) + k + 1] + part3,
                torch.where(l >= st.iz3l + st.nz3, 0.0,
                            self.cum3d[col * (st.nz3 + 1)]))
        else:
            sx_mu, sy_mu = self.sx / self.mu_s, self.sy / self.mu_s
            tau3 = torch.zeros_like(x)
            for k3 in range(st.nz3):
                z_lo, z_hi = self.z_deck[k3], self.z_deck[k3 + 1]
                z_mid = 0.5 * (z_lo + z_hi)
                seg = torch.minimum(torch.clamp(
                    z_hi - torch.maximum(z, z_lo), min=0.0), z_hi - z_lo)
                xm = x + sx_mu * (z_mid - z)
                ym = y + sy_mu * (z_mid - z)
                ixm, iym = self._col_index(torch.remainder(xm, self.lx),
                                           torch.remainder(ym, self.ly),
                                           ix, iy)
                idx = (ixm.long() * st.ny + iym) * st.nz3 + k3
                tau3 = tau3 + torch.where(seg > 0, self.ext3d[idx] * seg, 0.0)
        labs = -(S @ kabs)
        tau_tot = (tau_sig + tau3)[:, None] / self.mu_s + tau_abs / self.mu_s
        return torch.exp(labs - tau_tot)

    def _rad_pixel(self, x, y, z, ix0, iy0):
        """Image row of an event, projected along the view ray to z = 0."""
        st = self.st
        if st.ipa:
            return ix0.long() * st.ny + iy0
        xp = torch.remainder(x - self.sx / self.mu_s * z, self.lx)
        yp = torch.remainder(y - self.sy / self.mu_s * z, self.ly)
        ix = torch.remainder(torch.floor(xp / st.dx).to(_I), st.nx)
        iy = torch.remainder(torch.floor(yp / st.dy).to(_I), st.ny)
        return ix.long() * st.ny + iy

    def step(self, c: MarchingCarry, u: torch.Tensor) -> MarchingCarry:
        """One loop body (reference :463-657) for ``B = c.x.shape[0]``
        lanes; ``u``: (9, B) f32 deviates in [1e-7, 1-1e-7] (the transpose
        of the reference's (B, 9) draw).  Lane fields are replaced by new
        tensors; the tallies ``c.rad`` and ``c.flux`` are accumulated IN
        PLACE, so the returned carry shares them with ``c``."""
        st, cfg, scene = self.st, self.cfg, self.scene
        nz, ng = st.nz, st.ng
        lx, ly = self.lx, self.ly
        sx, sy, mu_s = self.sx, self.sy, self.mu_s
        radiance = self.radiance

        # ---------------- respawn dead lanes from the budget ----------------
        dead = ~c.alive
        order = torch.cumsum(dead, dim=0)                       # int64
        spawn = dead & (order <= self.n_photon - c.launched)
        launched = c.launched + torch.sum(spawn)
        x = torch.where(spawn, u[0] * lx, c.x)
        y = torch.where(spawn, u[1] * ly, c.y)
        z = torch.where(spawn, self.z_top, c.z)
        l = torch.where(spawn, nz - 1, c.l)
        ux = torch.where(spawn, self.u0x, c.ux)
        uy = torch.where(spawn, self.u0y, c.uy)
        uz = torch.where(spawn, self.u0z, c.uz)
        wsc = torch.where(spawn, 1.0, c.wsc)
        S = torch.where(spawn[:, None], 0.0, c.S)
        tau = torch.where(spawn, -torch.log(u[2]), c.tau)
        nscat = torch.where(spawn, 0, c.nscat)
        direct = spawn | c.direct
        alive = c.alive | spawn
        ix0 = torch.where(spawn, torch.remainder(
            torch.floor(x / st.dx).to(_I), st.nx), c.ix0)
        iy0 = torch.where(spawn, torch.remainder(
            torch.floor(y / st.dy).to(_I), st.ny), c.iy0)

        # ---------------- advance to the next event ----------------
        lo = torch.clamp(l, 0, nz - 1).long()
        lt = self.lay_tab[lo]                          # one packed row gather
        zl_lo, zl_hi, sig_m = lt[:, 0], lt[:, 1], lt[:, 2]
        s_col = tau / sig_m
        going_up = uz > 0.0
        uz_safe = torch.where(torch.abs(uz) < 1e-7,
                              torch.where(going_up, 1e-7, -1e-7), uz)
        s_bound = torch.clamp(torch.where(going_up, (zl_hi - z) / uz_safe,
                                          (zl_lo - z) / uz_safe), min=0.0)
        is_col = s_col < s_bound
        s = torch.where(alive, torch.where(is_col, s_col, s_bound), 0.0)
        if not st.ipa:
            # under IPA x and y never move
            x = torch.remainder(x + ux * s, lx)
            y = torch.remainder(y + uy * s, ly)
        z = torch.clamp(z + uz * s, 0.0, self.z_top)
        # gas-absorption pathlength: the reference's one-hot FMA is an add
        # at the layer's index only
        S.scatter_add_(1, lo[:, None], s[:, None])
        tau = torch.where(is_col, tau, tau - sig_m * s)
        ix, iy = self._col_index(x, y, ix0, iy0)

        # ---------------- collision: accept / channel ----------------
        if st.has_3d:
            in3 = (l >= st.iz3l) & (l < st.iz3l + st.nz3)
        else:
            in3 = torch.zeros_like(alive)
        k3 = torch.clamp(l - st.iz3l, 0, st.nz3 - 1)
        vr = self.vox3[(ix.long() * st.ny + iy) * st.nz3 + k3]
        ext_c = torch.where(in3, vr[:, 0], 0.0)
        sig_r = lt[:, 3]
        sig_ac = lt[:, 4:4 + self.n_aer]                # (B, Na)
        sig_a = torch.sum(sig_ac, dim=1)
        sig_real = sig_r + sig_a + ext_c
        accept = alive & is_col & (u[3] * sig_m < sig_real)

        pick = u[4] * sig_real
        ch_ray = accept & (pick < sig_r)
        ch_aer = accept & ~ch_ray & (pick < sig_r + sig_a)
        ch_cld = accept & ~ch_ray & ~ch_aer
        c_aer = torch.clamp(torch.sum(torch.cumsum(sig_ac, dim=1)
                                      < (pick - sig_r)[:, None], dim=1),
                            0, self.n_aer - 1)
        apf_a = scene.aer_apf[c_aer]
        ssa_a = scene.aer_ssa[c_aer]
        # 3D constituent slot by extinction share: given ch_cld,
        # (pick - sig_r - sig_a) / ext_c is a fresh U[0, 1) deviate
        u_c = torch.clamp((pick - sig_r - sig_a)
                          / torch.clamp(ext_c, min=1e-30), 0.0, 1.0 - 1e-7)
        slot = torch.zeros_like(l)
        for s_ in range(st.ns3 - 1):
            slot = slot + (u_c >= vr[:, 1 + 3 * s_]).to(_I)
        ssa_sel, apf_sel = vr[:, 2], vr[:, 3]
        for s_ in range(1, st.ns3):
            m = slot == s_
            ssa_sel = torch.where(m, vr[:, 2 + 3 * s_], ssa_sel)
            apf_sel = torch.where(m, vr[:, 3 + 3 * s_], apf_sel)
        ssa_c = torch.where(in3, ssa_sel, 1.0)
        apf_c = torch.where(in3, apf_sel, 0.0).to(_I)
        apf = torch.where(ch_cld, apf_c, torch.where(ch_aer, apf_a, 0))
        ssa_ev = torch.where(ch_cld, ssa_c, torch.where(ch_aer, ssa_a, 1.0))

        # one fused lookup: the eval row toward the sensor (TMS rows for
        # never-scattered lanes; unused by flux targets, whose cosine is 0)
        # and the inverse-CDF sample row
        if radiance:
            mu_sc = ux * sx + uy * sy + uz * mu_s
            row_e = apf + direct.to(_I) * self.n_pf
        else:
            mu_sc = torch.zeros_like(x)
            row_e = apf
        p_tab, mu_new = phase_pair(apf, row_e.contiguous(), mu_sc,
                                   u[5].contiguous(), self.pt_p, self.pt_mu)

        # ---------------- radiance local estimate ----------------
        rad = c.rad
        if radiance:
            pval = torch.where(apf == 0, 0.75 * (1.0 + mu_sc * mu_sc), p_tab)
            tsens = self._sensor_trans(x, y, z, l, ix, iy, S)
            contrib = (wsc * ssa_ev * pval
                       / (4.0 * math.pi * mu_s))[:, None] * tsens
            rad.index_add_(0, self._rad_pixel(x, y, z, ix0, iy0),
                           torch.where(accept[:, None], contrib, 0.0))

        # ---------------- scattering update ----------------
        psi = u[6] * (2.0 * math.pi)
        ux_s, uy_s, uz_s = rotate(ux, uy, uz, mu_new, psi)
        ux = torch.where(accept, ux_s, ux)
        uy = torch.where(accept, uy_s, uy)
        uz = torch.where(accept, uz_s, uz)
        wsc = torch.where(accept, wsc * ssa_ev, wsc)
        nscat = nscat + accept.to(_I)
        direct = direct & ~accept
        tau = torch.where(is_col, -torch.log(u[7]), tau)

        # ---------------- boundary crossing ----------------
        crossed = alive & ~is_col
        l_new = torch.where(crossed, torch.where(going_up, l + 1, l - 1), l)
        hit_sfc = crossed & (l_new < 0)
        exit_toa = crossed & (l_new >= nz)
        flux = c.flux
        if not radiance:
            lev = torch.clamp(torch.where(going_up, l + 1, l), 0, nz)
            ch = torch.where(going_up, 2, torch.where(direct, 0, 1))
            if cfg.flux_per_column:
                col = ix.long() * self.nyf + iy
            else:
                col = torch.zeros_like(lo)
            flux.index_add_(0, (col * self.nlev + lev) * 3 + ch,
                            torch.where(crossed[:, None],
                                        self._w_full(wsc, S), 0.0))

        # ---------------- surface: estimate and typed BRDF reflection ----
        if self.sfc_tab.shape[0] == 1:
            srow = self.sfc_tab[0].expand(x.shape[0], 6)
        else:
            sxi = torch.remainder(torch.floor(x / lx * st.nxs).to(_I), st.nxs)
            syi = torch.remainder(torch.floor(y / ly * st.nys).to(_I), st.nys)
            srow = self.sfc_tab[sxi.long() * st.nys + syi]
        jsfc_l = srow[:, 0].to(_I)
        psfc_l = srow[:, 1:]
        if radiance:
            rho_s = brdf_eval(jsfc_l, psfc_l, ux, uy, uz, sx, sy, mu_s)
            z0, l0 = torch.zeros_like(z), torch.zeros_like(l)
            c_sfc = (wsc * rho_s)[:, None] * self._sensor_trans(
                x, y, z0, l0, ix, iy, S)
            rad.index_add_(0, self._rad_pixel(x, y, z0, ix0, iy0),
                           torch.where(hit_sfc[:, None], c_sfc, 0.0))
        # the reflection reuses deviates 5, 6, 2 and 4, as the reference
        bx, by, bz, bw, _ = brdf_sample_dir_weight(
            jsfc_l, psfc_l, ux, uy, uz, u[5], u[6], u[2], u[4])
        ux = torch.where(hit_sfc, bx, ux)
        uy = torch.where(hit_sfc, by, uy)
        uz = torch.where(hit_sfc, bz, uz)
        wsc = torch.where(hit_sfc, wsc * bw, wsc)
        direct = direct & ~hit_sfc
        z = torch.where(hit_sfc, 0.0, z)
        tau = torch.where(hit_sfc, -torch.log(u[7]), tau)
        l = torch.where(hit_sfc, 0, torch.where(exit_toa, l, l_new))
        if not radiance:
            # the up-crossing of level 0 by a reflected photon, with the
            # post-reflection weight (the next step from l = 0 going up
            # tallies level 1 first)
            flux.index_add_(0, col * (self.nlev * 3) + 2,
                            torch.where(hit_sfc[:, None],
                                        self._w_full(wsc, S), 0.0))

        # ---------------- termination & Russian roulette ----------------
        alive = alive & ~exit_toa & (nscat < cfg.n_scat_max) & (wsc > 0.0)
        # roulette on the best-case (least-absorbed) weight
        wmax = wsc * torch.exp(-torch.sum(S * self.kabs_min, dim=1))
        need_rr = alive & (wmax < cfg.rr_wmin)
        p_surv = torch.clamp(wmax / cfg.rr_wmin, 0.0, 1.0)
        die = need_rr & (u[8] > p_surv)
        wsc = torch.where(need_rr & ~die,
                          wsc / torch.clamp(p_surv, min=1e-12), wsc)
        alive = alive & ~die

        return MarchingCarry(x=x, y=y, z=z, l=l, ux=ux, uy=uy, uz=uz, wsc=wsc,
                             S=S, tau=tau, nscat=nscat, direct=direct,
                             alive=alive, ix0=ix0, iy0=iy0, launched=launched,
                             step=c.step + 1, rad=rad, flux=flux)


def transport(scene, st, cfg: SolverConfig, n_photon: int, seed: int,
              device='cuda',
              deviates: Callable[[int], torch.Tensor] | None = None,
              stats: dict | None = None) -> Tallies:
    """Run ``n_photon`` photons of the marching engine on ``device`` (the
    card unless the caller asks for the CPU; the scene must be there);
    returns the raw tallies in photon-weight units (reference :288-686).

    The loop runs while a lane is alive or the budget is not launched, up
    to :meth:`MarchingKernel.max_steps`; its condition is read back from
    the device once per step.  Each step draws its (9, B) deviates from a
    ``torch.Generator`` seeded with ``seed``, or takes them from
    ``deviates(step)`` (the tests inject the reference's own draws).
    ``cfg.use_pallas`` is ignored, as in the reference.  ``stats``: an
    optional dict that receives ``max_steps``.  Traced
    (:mod:`er3t_tpu_torch.util.trace`), the loop records the spans
    ``flight.deviates``, ``flight.step`` and ``flight.read``.  Flux tallies
    come back as (Nxf, Nyf, Nz+1, 3, Ng) with the deterministic TOA
    down-direct entry added once after the loop (reference :678-683);
    ``lane_iters`` is steps x batch.
    """
    dev = resolve_device(scene, device)
    kern = MarchingKernel(scene, st, cfg, n_photon)
    n, b = kern.n_photon, cfg.batch
    max_steps = kern.max_steps()
    if deviates is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))

        def deviates(_step):
            return draw_deviates(gen, b, dev, rows=9)
    c = kern.carry0(b)
    while c.step < max_steps:
        n_alive, launched = read_counts(c, dev)
        if n_alive == 0 and launched >= n:
            break
        with trace.span('flight.deviates'):
            u = deviates(c.step)
        with trace.span('flight.step'):
            c = kern.step(c, u)
    if stats is not None:
        stats.update(max_steps=max_steps)

    nlev, ng = kern.nlev, st.ng
    if kern.radiance:
        rad = c.rad.reshape(st.nx, st.ny, ng)
        flux = torch.zeros((kern.nxf, kern.nyf, nlev, 3, ng), dtype=_F,
                           device=dev)
    else:
        rad = torch.zeros((st.nx, st.ny, ng), dtype=_F, device=dev)
        flux = c.flux.reshape(kern.nxf, kern.nyf, nlev, 3, ng)
        # TOA down-direct entry: exactly one crossing per launched photon
        flux[:, :, st.nz, 0, :] += c.launched.to(_F) / (kern.nxf * kern.nyf)
    return Tallies(
        rad=rad, flux=flux, n_launched=c.launched,
        n_steps=torch.tensor(c.step, dtype=torch.int64),
        rad_plen=torch.zeros((), dtype=_F, device=dev),
        lane_iters=torch.tensor(float(c.step * b), dtype=torch.float64),
        absorbed=torch.zeros((1, 1), dtype=_F, device=dev))


def run_transport(scene, static, cfg: SolverConfig, n_photon: int, seed=0,
                  device='cuda', stats: dict | None = None) -> Tallies:
    """Entry point of the marching engine: one run of ``n_photon`` photons
    on ``device`` with a fresh generator seeded by ``seed`` (the
    reference's signature plus ``device``); see :func:`transport`."""
    return transport(scene, static, cfg, int(n_photon), seed, device,
                     stats=stats)

"""Flight-based radiance transport (port of ``er3t_tpu/rtm/mc_flight.py``,
radiance/satellite branch).

A batch of B photon lanes advances in lock-step; every step each live lane
flies analytically through the layered (per-tile) majorant to its next
tentative collision, deposits a local estimate toward the satellite, and
scatters or reflects; dead lanes respawn from the remaining budget.  The
physics and the operation order are the reference's (see the design notes
there); what differs is the execution shape:

* :meth:`FlightKernel.step` is one loop body as a plain function of
  ``(carry, u, q_off)``: it draws nothing itself.  The loop draws the
  (14, B) deviates with an explicit ``torch.Generator``; the tests inject
  JAX's own deviates and step both packages from one carry.
* the loop runs in Python; its condition reads two numbers back from the
  device once per step (the cost is recorded in PERF.md).
* drain compaction permutes each lane field with one alive-first stable
  ``argsort``; no f32 lane-matrix packing is needed.
* the phase-table pair lookup goes through :func:`~.phase_pair.phase_pair`
  (a hand-written CUDA kernel on the card), whatever ``cfg.use_pallas``.

Supported: ``tile_size`` 0 or >0, ``qmc_launch``, ``rad_w`` given or not,
any satellite sensor direction, 1D aerosols, ns3 >= 1, uniform and
per-pixel surfaces, clear-sky scenes, ``n_scat_max``, ``rr_wmin``,
``max_events``, ``drain_compact``.  Every other option raises
``NotImplementedError`` naming its ROADMAP item.
"""

from __future__ import annotations

import math
import time
from typing import NamedTuple

import numpy as np
import torch

from .mc import SolverConfig, Tallies, _sensor_dir
from .phase_pair import phase_pair
from .brdf import brdf_eval, brdf_sample_dir_weight
from .scene import SceneArrays, SceneStatic

__all__ = ['FlightCarry', 'FlightKernel', 'check_supported',
           'transport_flight', 'run_transport_flight', 'draw_deviates']

_F = torch.float32
_I = torch.int32
_U_LO = np.float32(1e-7)                 # deviates lie in [1e-7, 1 - 1e-7]
_U_HI = np.float32(1.0 - 1e-7)


def _coprime_stride(n: int) -> int:
    """Largest stride <= min(0.618 n, (2^32-1)//n) coprime to ``n``: the
    bijective multiplicative shuffle ``cell = (i % n) * stride % n``."""
    s = max(1, min(int(0.618 * n), (2 ** 32 - 1) // max(n, 1)))
    while s > 1 and math.gcd(s, n) != 1:
        s -= 1
    return s


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
    ix0: torch.Tensor        # int32 birth column
    iy0: torch.Tensor
    plen: torch.Tensor       # geometric pathlength [m]
    direct: torch.Tensor     # bool: never scattered or reflected
    launched: torch.Tensor   # () int64, on the device
    step: int                # loop steps taken
    rad: torch.Tensor        # (Nx*Ny,) with rad_w, else (Nx*Ny, Ng)


_LANE_FIELDS = ('x', 'y', 'z', 'ux', 'uy', 'uz', 'wsc', 'labs', 'tau',
                'nscat', 'alive', 'ix0', 'iy0', 'plen', 'direct')


def _take_lanes(c: FlightCarry, idx: torch.Tensor) -> FlightCarry:
    """The lanes ``idx`` of every per-lane field (``labs`` along dim 1)."""
    return c._replace(**{f: (getattr(c, f)[:, idx] if f == 'labs'
                             else getattr(c, f)[idx]) for f in _LANE_FIELDS})


def check_supported(cfg: SolverConfig, ipa: bool) -> None:
    """Raise ``NotImplementedError`` for an option the port lacks."""
    unported = (
        (cfg.target != 'radiance',
         f'target={cfg.target!r}: flux targets are ROADMAP A8'),
        (cfg.sensor_type != 'satellite',
         f'sensor_type={cfg.sensor_type!r}: the camera is ROADMAP A9'),
        (ipa, 'IPA (independent pixels) is ROADMAP A9'),
        (cfg.p3d_order > 0, 'p3d_order>0 (partial 3D) is ROADMAP A9'),
        (cfg.cf_dtau > 0, 'cf_dtau (collision forcing) is ROADMAP A9'),
        (cfg.split_wmax > 0, 'split_wmax (splitting) is ROADMAP A9'),
        (cfg.rr_value > 0, 'rr_value (importance roulette) is ROADMAP A9'),
        (cfg.sort_every > 0, 'sort_every (lane sorting) is ROADMAP A9'),
        (cfg.launch_coherent, 'launch_coherent is ROADMAP A9'),
        (cfg.cam_importance_sigma > 0, 'cam_importance_sigma is ROADMAP A9'),
        (cfg.pathlength, 'pathlength tallies are ROADMAP A9'),
    )
    for bad, msg in unported:
        if bad:
            raise NotImplementedError('er3t_tpu_torch flight kernel: ' + msg)


class FlightKernel:
    """Scene-derived tables and the step function of the flight loop
    (the reference's ``make_flight_kernel`` closure, :107-1304).

    The step works for any batch width, so one kernel serves every drain
    stage.  All tables live on the scene's device; scalar constants are
    Python floats holding the exact f32 values the reference uses.
    """

    def __init__(self, scene: SceneArrays, st: SceneStatic,
                 cfg: SolverConfig, n_photon: int, rad_w=None):
        check_supported(cfg, st.ipa)
        self.scene, self.st, self.cfg = scene, st, cfg
        self.n_photon = int(n_photon)
        dev = self.device = scene.z_lev.device
        nz, ng = st.nz, st.ng
        self.lx = st.nx * st.dx
        self.ly = st.ny * st.dy
        self.scalar_rad = rad_w is not None
        self.rad_w = (None if rad_w is None else torch.as_tensor(
            rad_w, dtype=_F, device=dev).reshape(ng))

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
        # so one index_select yields the (Nz, B) frame of the flight core
        tile = self.tile = cfg.tile_size
        self.use_tiles = tile > 0 and st.has_3d
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
        self.u0x = float(sin0 * torch.cos(scene.phi0))
        self.u0y = float(sin0 * torch.sin(scene.phi0))
        self.u0z = float(-scene.mu0)

        self.uniform_sfc = st.nxs == 1 and st.nys == 1
        # packed surface table: [jsfc, p0..p4] (reference :289-293)
        self.sfc_tab = torch.cat([scene.jsfc.reshape(-1, 1).to(_F),
                                  scene.psfc.reshape(-1, 5)], dim=1)

        self.strat = cfg.qmc_launch
        self.n_cell = st.nx * st.ny
        self.q_stride = _coprime_stride(self.n_cell)

    # ------------------------------------------------------------------
    def carry0(self, batch: int) -> FlightCarry:
        """All-dead initial state for ``batch`` lanes."""
        dev, ng = self.device, self.st.ng
        z = torch.zeros(batch, dtype=_F, device=dev)
        zi = torch.zeros(batch, dtype=_I, device=dev)
        zb = torch.zeros(batch, dtype=torch.bool, device=dev)
        npix = self.st.nx * self.st.ny
        rad = torch.zeros((npix,) if self.scalar_rad else (npix, ng),
                          dtype=_F, device=dev)
        return FlightCarry(
            x=z, y=z.clone(), z=z.clone(), ux=z.clone(), uy=z.clone(),
            uz=z.clone(), wsc=z.clone(),
            labs=torch.zeros((ng + 1, batch), dtype=_F, device=dev),
            tau=z.clone(), nscat=zi, alive=zb, ix0=zi.clone(),
            iy0=zi.clone(), plen=z.clone(), direct=zb.clone(),
            launched=torch.zeros((), dtype=torch.int64, device=dev), step=0,
            rad=rad)

    def _local_ix(self, x):
        return torch.clamp(torch.floor(x / self.st.dx).to(_I),
                           0, self.st.nx - 1)

    def _local_iy(self, y):
        return torch.remainder(torch.floor(y / self.st.dy).to(_I), self.st.ny)

    @staticmethod
    def _rotate(ux, uy, uz, mu, psi):
        """Turn (ux, uy, uz) by polar cosine ``mu`` and azimuth ``psi``."""
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

    # ------------------------------------------------------------------
    def step(self, c: FlightCarry, u: torch.Tensor, q_off) -> FlightCarry:
        """One loop body (reference :376-1278) for ``B = c.x.shape[0]``
        lanes.

        ``u``: (14, B) f32 deviates in [1e-7, 1-1e-7]; ``q_off``: the
        stratified-launch cell offset (int or 0-d integer tensor).  Lane
        fields are replaced by new tensors; the image ``c.rad`` is
        accumulated IN PLACE (``index_add_``), so the returned carry shares
        it with ``c``.  On the card that deposit runs as atomics in a
        varying order, so images differ in the last bits from run to run.
        """
        st, cfg = self.st, self.cfg
        nz, ng = st.nz, st.ng
        dx, dy, lx, ly = st.dx, st.dy, self.lx, self.ly
        sx, sy, mu_s = self.sx, self.sy, self.mu_s
        z_lev = self.scene.z_lev

        # ---------------- respawn ----------------
        dead = ~c.alive
        order = torch.cumsum(dead, dim=0)                      # int64
        spawn = dead & (order <= self.n_photon - c.launched)
        launched = c.launched + torch.sum(spawn)
        if self.strat:
            # rank among spawning lanes -> shuffled cell + in-cell jitter;
            # int64 holds the reference's uint32 values (stride*n < 2^32)
            idx = c.launched + order - 1
            cell = torch.remainder(idx + q_off, self.n_cell) \
                * self.q_stride % self.n_cell
            x_sp = ((cell // st.ny).to(_F) + u[0]) * dx
            y_sp = ((cell % st.ny).to(_F) + u[1]) * dy
        else:
            x_sp = u[0] * lx
            y_sp = u[1] * ly
        x = torch.where(spawn, torch.remainder(x_sp, lx), c.x)
        y = torch.where(spawn, y_sp, c.y)
        z = torch.where(spawn, self.z_top, c.z)
        ux = torch.where(spawn, self.u0x, c.ux)
        uy = torch.where(spawn, self.u0y, c.uy)
        uz = torch.where(spawn, self.u0z, c.uz)
        wsc = torch.where(spawn, 1.0, c.wsc)
        labs = torch.where(spawn[None, :], 0.0, c.labs)
        tau = torch.where(spawn, -torch.log(u[2]), c.tau)
        nscat = torch.where(spawn, 0, c.nscat)
        alive = c.alive | spawn
        ix0 = torch.where(spawn, self._local_ix(x), c.ix0)
        iy0 = torch.where(spawn, self._local_iy(y), c.iy0)
        plen = torch.where(spawn, 0.0, c.plen)
        direct = spawn | c.direct
        active = alive

        # ---------------- analytic flight through the majorant ----------------
        going_up = uz > 0.0
        uz_safe = torch.where(torch.abs(uz) < 1e-6,
                              torch.sign(uz + 1e-30) * 1e-6, uz)
        inv_uz = 1.0 / uz_safe
        if self.use_tiles:
            # majorant of the tile at the flight's deck entry point
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
            txp = self._local_ix(xe_w) // self.tile
            typ = self._local_iy(ye_w) // self.tile
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

        if self.use_tiles:
            tx_lo = (txp * self.tile) * dx + offx
            tx_hi = torch.clamp((txp + 1) * self.tile, max=st.nx) * dx + offx
            ty_lo = (typ * self.tile) * dy + offy
            ty_hi = torch.clamp((typ + 1) * self.tile, max=st.ny) * dy + offy
            sfx = torch.where(ux > 1e-7, (tx_hi - x) / ux,
                              torch.where(ux < -1e-7, (tx_lo - x) / ux, 3e38))
            sfy = torch.where(uy > 1e-7, (ty_hi - y) / uy,
                              torch.where(uy < -1e-7, (ty_lo - y) / uy, 3e38))
            s_tile = torch.clamp(torch.minimum(sfx, sfy), min=0.0)
            can_clamp = active & (s_tile < sd_out)

        collided = active & (tau < total_od)
        full = cum < tau[None, :]
        n_full = torch.sum(full, dim=0)
        l_col = torch.clamp(torch.where(going_up, n_full, nz - 1 - n_full),
                            0, nz - 1)
        if self.use_tiles:
            sig_m = torch.gather(sig_col, 0, l_col[None, :])[0]
        else:
            sig_m = self.scene.sig_maj[l_col]
        cum_before = torch.sum(od * full, dim=0)
        d_before = torch.sum(seg * full, dim=0)
        s_col = d_before + (tau - cum_before) / sig_m
        s_star = torch.where(collided, s_col, s_exit)
        s_star = torch.where(active, s_star, 0.0)

        if self.use_tiles:
            # clamp at the faces of the deck-entry tile (exact by
            # memorylessness: tau is redrawn every step)
            tclamp = can_clamp & (s_tile < s_star)
            s_star = torch.where(tclamp, s_tile, s_star)
            collided = collided & ~tclamp
        else:
            tclamp = torch.zeros_like(active)

        # traveled path per layer, valid for collided/exit/clamped alike
        trav = torch.minimum(torch.clamp(
            torch.minimum(d_out, s_star[None, :]) - d_in, min=0.0), seg)
        trav = torch.where(active[None, :], trav, 0.0)           # (Nz, B)
        term = active & ~collided & ~tclamp

        x = torch.where(active, torch.remainder(x + ux * s_star, lx), x)
        y = torch.where(active, torch.remainder(y + uy * s_star, ly), y)
        if self.use_tiles:
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
        hit_sfc = term & ~going_up
        exit_toa = term & going_up
        z = torch.where(hit_sfc, 0.0, z)

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
        ix, iy = self._local_ix(x), self._local_iy(y)
        k3 = torch.clamp(l_col - st.iz3l, 0, st.nz3 - 1)
        if st.has_3d:
            in3 = (l_col >= st.iz3l) & (l_col < st.iz3l + st.nz3)
        else:
            in3 = torch.zeros_like(active)
        vt = self.vox[(ix.long() * st.ny + iy) * st.nz3 + k3].T  # (3+3Ns3, B)
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

        # scattering cosine toward the sensor; one fused lookup of the eval
        # row (TMS rows for never-scattered lanes) and the sample row
        mu_sc = ux * sx + uy * sy + uz * mu_s
        row_e = apf + direct.to(_I) * self.n_pf
        pe_pair, mu_new = phase_pair(apf, row_e, mu_sc, u[5].contiguous(),
                                     self.pt_p, self.pt_mu)
        pval = torch.where(apf == 0, 0.75 * (1.0 + mu_sc * mu_sc), pe_pair)

        # ---------------- local estimates ----------------
        if self.uniform_sfc:
            srow = self.sfc_tab[0].expand(x.shape[0], 6)
        else:
            if st.nxs == st.nx:
                sxi = ix
            else:
                # independent surface grid: index by domain fraction
                sxi = torch.clamp(torch.floor(x / lx * st.nxs).to(_I),
                                  0, st.nxs - 1)
            syi = torch.remainder(torch.floor(y / ly * st.nys).to(_I), st.nys)
            srow = self.sfc_tab[sxi.long() * st.nys + syi]
        jsfc_l = srow[:, 0].to(_I)
        psfc_l = srow[:, 1:]

        t_sens = torch.exp(labs[:ng] - tau_sens_abs
                           - (tau_sens_sig + tau3_above)[None, :])
        c_vol = (wsc * ssa_ev * pval / (4.0 * math.pi * mu_s))[None, :] * t_sens
        rho_sens = brdf_eval(jsfc_l, psfc_l, ux, uy, uz, sx, sy, mu_s)
        c_sfc = (wsc * rho_sens)[None, :] * t_sens
        contrib = torch.where(accept[None, :], c_vol,
                              torch.where(hit_sfc[None, :], c_sfc, 0.0))
        if self.scalar_rad:
            contrib = self.rad_w @ contrib                       # (B,)
        rad = c.rad
        if st.nx * st.ny == 1:
            rad += torch.sum(contrib, dim=-1)
        else:
            # slant projection onto the TOA image plane, periodic in x, y
            xp = torch.remainder(x - sx / mu_s * z, lx)
            yp = torch.remainder(y - sy / mu_s * z, ly)
            gix = torch.clamp(torch.floor(xp / dx).to(_I), 0, st.nx - 1)
            pidx = gix.long() * st.ny + self._local_iy(yp)
            rad.index_add_(0, pidx, contrib if self.scalar_rad else contrib.T)

        # ---------------- direction updates ----------------
        psi = u[6] * (2.0 * math.pi)
        ux_s, uy_s, uz_s = self._rotate(ux, uy, uz, mu_new, psi)
        bx, by, bz, bw = brdf_sample_dir_weight(
            jsfc_l, psfc_l, ux, uy, uz, u[5], u[6], u[9], u[10])
        ux = torch.where(accept, ux_s, torch.where(hit_sfc, bx, ux))
        uy = torch.where(accept, uy_s, torch.where(hit_sfc, by, uy))
        uz = torch.where(accept, uz_s, torch.where(hit_sfc, bz, uz))
        wsc = torch.where(accept, wsc * ssa_ev,
                          torch.where(hit_sfc, wsc * bw, wsc))
        nscat = nscat + accept.to(_I)
        direct = direct & ~accept & ~hit_sfc
        tau = torch.where(active, -torch.log(u[7]), tau)

        # ---------------- termination / roulette ----------------
        alive = alive & ~exit_toa & (nscat < cfg.n_scat_max) & (wsc > 0.0)
        wmax = wsc * torch.exp(labs[ng])
        need_rr = active & (wmax < cfg.rr_wmin)
        p_surv = torch.clamp(wmax / cfg.rr_wmin, 0.0, 1.0)
        die = need_rr & (u[8] > p_surv)
        wsc = torch.where(need_rr & ~die,
                          wsc / torch.clamp(p_surv, min=1e-12), wsc)
        alive = alive & ~die

        return FlightCarry(x=x, y=y, z=z, ux=ux, uy=uy, uz=uz, wsc=wsc,
                           labs=labs, tau=tau, nscat=nscat, alive=alive,
                           ix0=ix0, iy0=iy0, plen=plen, direct=direct,
                           launched=launched, step=c.step + 1, rad=rad)


def draw_deviates(gen: torch.Generator, batch: int, device) -> torch.Tensor:
    """(14, batch) uniforms mapped to [1e-7, 1-1e-7] as ``jax.random.uniform``
    maps them (``u * (hi - lo) + lo``, then ``max(lo, .)``)."""
    u = torch.rand((14, batch), generator=gen, dtype=_F, device=device)
    return u.mul_(float(_U_HI - _U_LO)).add_(float(_U_LO)) \
        .clamp_(min=float(_U_LO))


def transport_flight(scene: SceneArrays, st: SceneStatic, cfg: SolverConfig,
                     n_photon: int, gen: torch.Generator,
                     rad_w=None, stats: dict | None = None) -> Tallies:
    """Run ``n_photon`` photons to completion (reference :1383-1503).

    Deviates and the stratified-launch offset come from ``gen``, which must
    live on the scene's device.  The loop condition is read back from the
    device once per step.  Once the budget is launched and the survivors
    fit, lanes are compacted alive-first into B/8 and then B/64 batches
    (each lane keeps its own state; later deviates are fresh draws).
    ``stats``: optional dict that receives ``host_read_s``, the wall time
    spent in the per-step read-back (it includes waiting for the device to
    finish the step), and ``stage_steps``, the steps run at the full batch
    and in each drain stage.
    """
    kern = FlightKernel(scene, st, cfg, n_photon, rad_w=rad_w)
    dev = kern.device
    n = kern.n_photon
    max_steps = cfg.max_events or (n // cfg.batch + 2) * 400
    stages = []
    if cfg.drain_compact and cfg.batch >= 2048:
        b_s = cfg.batch // 8
        while b_s >= 256 and len(stages) < 2:
            stages.append(b_s)
            b_s //= 8
    q_off = (torch.randint(0, kern.n_cell, (), generator=gen, device=dev)
             if kern.strat else 0)

    host_read_s = 0.0

    def counts(c):
        nonlocal host_read_s
        t0 = time.perf_counter()
        n_alive, launched = torch.stack(
            [torch.sum(c.alive), c.launched]).tolist()
        host_read_s += time.perf_counter() - t0
        return n_alive, launched

    c = kern.carry0(cfg.batch)
    b1 = stages[0] if stages else None
    while True:
        n_alive, launched = counts(c)
        more = (n_alive > 0 or launched < n) and c.step < max_steps
        if b1 is not None:
            more = more and (launched < n or n_alive > b1)
        if not more:
            break
        c = kern.step(c, draw_deviates(gen, cfg.batch, dev), q_off)
    lane_iters = c.step * cfg.batch
    stage_steps = [c.step]
    for si, b_s in enumerate(stages):
        prev = c.step
        order = torch.argsort((~c.alive).to(_I), stable=True)
        c = _take_lanes(c, order[:b_s])
        nxt = stages[si + 1] if si + 1 < len(stages) else 0
        while counts(c)[0] > nxt and c.step < max_steps:
            c = kern.step(c, draw_deviates(gen, b_s, dev), q_off)
        lane_iters += (c.step - prev) * b_s
        stage_steps.append(c.step - prev)

    if stats is not None:
        stats.update(host_read_s=host_read_s, stage_steps=stage_steps)
    ng_r = 1 if kern.scalar_rad else st.ng
    return Tallies(
        rad=c.rad.reshape(st.nx, st.ny, ng_r),
        flux=torch.zeros((1, 1, st.nz + 1, 3, st.ng), dtype=_F, device=dev),
        n_launched=c.launched,
        n_steps=torch.tensor(c.step, dtype=torch.int64),
        rad_plen=torch.zeros((), dtype=_F, device=dev),
        lane_iters=torch.tensor(float(lane_iters), dtype=torch.float64),
        absorbed=torch.zeros((1, 1), dtype=_F, device=dev))


def run_transport_flight(scene: SceneArrays, static: SceneStatic,
                         cfg: SolverConfig, n_photon: int, seed: int,
                         device='cuda', rad_w=None, stats=None) -> Tallies:
    """Entry point: one run on ``device`` (the card unless the caller asks
    for the CPU; the scene must be there) with a fresh generator seeded by
    ``seed``.  ``rad_w``: optional (Ng,) spectral factors; image deposits
    are then contracted over g in the step, and ``Tallies.rad`` has a
    singleton g axis.  ``stats``: see :func:`transport_flight`."""
    device = torch.device(device)
    if device.type == 'cuda' and device.index is None:
        device = torch.device('cuda', torch.cuda.current_device())
    for name, t in zip(SceneArrays._fields, scene):
        if t.device != device:
            raise ValueError(f'scene.{name} is on {t.device}, not {device}')
    if device.type == 'cuda' and torch.backends.cuda.matmul.allow_tf32:
        raise ValueError('torch.backends.cuda.matmul.allow_tf32 must be False: '
                         'the absorption matmul feeds exp(labs) in f32')
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return transport_flight(scene, static, cfg, int(n_photon), gen,
                            rad_w=rad_w, stats=stats)

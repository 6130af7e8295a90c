"""Plain Monte Carlo reference of ``solve``'s radiance, flux and heating-rate
targets.

It solves the same transfer problem as the port, from the same inputs,
with its own optics (the frozen scene body in ``benchmark/frozen``) and its
own transport, written for clarity and not for speed:

* photons start at the top of the atmosphere, uniformly over the periodic
  domain, travelling along the solar direction, with one weight for
  scattering and one log-transmission per g-point for gas absorption;
* inside one layer a tentative collision is drawn from the layer's
  majorant (Rayleigh plus the largest cloud extinction of that layer);
  a photon that reaches a level before colliding stops there and tallies
  the crossing, so flux needs no clamp and no prelude;
* a tentative collision is real with probability (real extinction) /
  (majorant); Rayleigh or cloud is then chosen by extinction share;
* at every real collision and every surface hit the nadir radiance gets a
  local estimate: the phase function toward the sensor (the full-phase
  "TMS" row for photons never scattered, the truncated row after) times
  the transmission up the column, in the pixel of the event;
* the surface is Lambertian; weights below 0.1 (at the most transparent
  g) play Russian roulette; a photon dies after ``n_scat_max`` scatters.

Tallies are contracted over g with the spectral factors of the frozen
``out.spectral_factors`` and reduced with the frozen ``reduce_radiance``
and ``reduce_flux``; the flux gets the incoming beam at the top level, as
the port's does.  Heating rate runs the flux transport, and its ``hr`` is
the frozen ``heating_rate`` of the domain-average net flux: in a periodic
domain its convergence in a layer is the energy the layer absorbs, which
the port tallies directly.  Every float the transport holds is of
``dtype``: float32 is the reference, bfloat16 the low-precision control.

Nothing here imports the port: it may run where the port is absent.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..frozen import heating
from ..frozen import out as fout
from ..frozen import scene_np

__all__ = ['Optics', 'optics', 'run', 'reduce']


class Optics:
    """The reference's own derivation of the scene, as tensors on
    ``device`` in ``dtype`` (from the frozen scene body)."""

    def __init__(self, leaves, static, factors_rad, factors_flux, device,
                 dtype):
        f = dict(dtype=dtype, device=device)
        st = self.st = static
        self.dtype, self.device = dtype, device
        self.nz, self.ng = st.nz, st.ng
        z_lev = np.asarray(leaves['z_lev'], dtype=np.float64)
        dz = np.diff(z_lev)
        sig_ray = np.asarray(leaves['sig_ray'], dtype=np.float64)
        if np.any(np.asarray(leaves['sig_aer']) != 0):
            raise ValueError('the reference has no 1D aerosol')
        if st.ns3 != 1:
            raise ValueError('the reference has one 3D constituent, the cloud')
        kabs = np.asarray(leaves['kabs'], dtype=np.float64)
        ext3d = np.asarray(leaves['ext3d'], dtype=np.float64)
        # column extinction between the top of each deck layer and the deck
        # top, and the whole deck column
        dz3 = dz[st.iz3l:st.iz3l + st.nz3]
        above = np.cumsum(ext3d[..., ::-1] * dz3[::-1], axis=-1)[..., ::-1]
        self.ext3d = torch.tensor(ext3d, **f)
        self.deck_above = torch.tensor(np.concatenate(
            [above[..., 1:], np.zeros(ext3d.shape[:2] + (1,))], axis=-1), **f)
        self.deck_col = torch.tensor(above[..., 0], **f)
        self.ssa3d = torch.tensor(np.asarray(leaves['ssa3d'])[..., 0], **f)
        self.apf3d = torch.tensor(np.asarray(leaves['apf3d'])[..., 0],
                                  dtype=torch.int64, device=device)
        ext_max = np.zeros(st.nz)
        ext_max[st.iz3l:st.iz3l + st.nz3] = ext3d.max(axis=(0, 1))
        self.sig_maj = torch.tensor(np.maximum(sig_ray + ext_max, 1e-12), **f)
        self.sig_ray = torch.tensor(sig_ray, **f)
        self.z_lev = torch.tensor(z_lev, **f)
        self.kabs = torch.tensor(kabs, **f)
        # optical depths from each level up to the top: Rayleigh and gas
        self.ray_up = torch.tensor(np.concatenate(
            [np.cumsum((sig_ray * dz)[::-1])[::-1], [0.0]]), **f)
        self.gas_up = torch.tensor(np.concatenate(
            [np.cumsum((kabs * dz[:, None])[::-1], axis=0)[::-1],
             np.zeros((1, st.ng))]), **f)
        self.pt_mu = torch.tensor(np.asarray(leaves['pt_mu']), **f)
        self.pt_p = torch.tensor(np.asarray(leaves['pt_p']), **f)
        self.n_pf = int(self.pt_mu.shape[0])
        if not st.sfc_lambertian \
                or np.asarray(leaves['psfc']).shape[:2] != (1, 1):
            raise ValueError('the reference has a uniform Lambertian surface')
        self.albedo = float(np.asarray(leaves['psfc'])[0, 0, 0])
        mu0 = float(leaves['mu0'])
        phi0 = float(leaves['phi0'])
        sin0 = math.sqrt(max(1.0 - mu0 * mu0, 0.0))
        self.u0 = (sin0 * math.cos(phi0), sin0 * math.sin(phi0), -mu0)
        self.mu0 = mu0
        self.lx, self.ly = st.nx * st.dx, st.ny * st.dy
        self.factors_rad = torch.tensor(factors_rad, **f)         # (Ng,)
        self.factors_flux = torch.tensor(factors_flux, **f)       # (Nz+1, Ng)


def optics(inputs, device, dtype=torch.float32):
    """Work out the scene from the inputs (``inputs.atm``, ``.abs_coef``,
    ``.cld``, ``.pha`` and the solve settings in ``inputs.solve_kw``)."""
    if inputs.solve_objects:
        raise ValueError('the reference takes no solve objects; a '
                         'configuration that has them names its own')
    kw = inputs.solve_kw
    leaves, static = scene_np._build_numpy(
        inputs.atm, inputs.abs_coef, inputs.cld, inputs.pha, (), (),
        kw.get('surface', 0.03), kw.get('solar_zenith_angle', 30.0),
        kw.get('solar_azimuth_angle', 0.0), False,
        kw.get('forward_trunc_deg'), None, None)
    f_rad, _ = fout.spectral_factors(inputs.abs_coef, nz_out=1)
    f_flux, _ = fout.spectral_factors(inputs.abs_coef, nz_out=static.nz + 1)
    o = Optics(leaves, static, f_rad[0], f_flux, device, dtype)
    o.atm = inputs.atm
    # the incoming beam at the top level, per area: one launched photon's
    # weight, contracted with that level's factors
    o.toa_down = o.mu0 * float(f_flux[-1].sum())
    return o


def _column(o, x, y):
    ix = torch.clamp(torch.floor(x / o.st.dx).long(), 0, o.st.nx - 1)
    iy = torch.remainder(torch.floor(y / o.st.dy).long(), o.st.ny)
    return ix, iy


def _tau_up(o, lay, z, ix, iy):
    """Vertical optical depths from height ``z`` in layer ``lay`` to the
    top: scattering (B,) and gas (B, Ng)."""
    st = o.st
    dz_top = torch.clamp(o.z_lev[lay + 1] - z, min=0.0)
    sca = o.ray_up[lay + 1] + o.sig_ray[lay] * dz_top
    k = torch.clamp(lay - st.iz3l, 0, st.nz3 - 1)
    in_deck = (lay >= st.iz3l) & (lay < st.iz3l + st.nz3)
    below = lay < st.iz3l
    deck = torch.where(
        in_deck, o.deck_above[ix, iy, k] + o.ext3d[ix, iy, k] * dz_top,
        torch.where(below, o.deck_col[ix, iy], torch.zeros_like(z)))
    gas = o.gas_up[lay + 1] + o.kabs[lay] * dz_top[:, None]
    return sca + deck, gas


def run(o, n_photon, seed, target='radiance', batch=1 << 20, n_tallies=1,
        n_scat_max=2000, rr_wmin=0.1):
    """Trace ``n_photon`` photons; returns the raw tallies (on the device,
    of ``o.dtype``) and the photons launched into each.

    The photons are dealt in turn to ``n_tallies`` independent tallies, so
    one pool of lanes (and one drain) gives as many independent batches.
    Radiance: (K, Nx, Ny) nadir images contracted over g; flux: (K, Nx,
    Ny, Nz+1, 3) level crossings contracted over g (down direct, down
    diffuse, up), with no deterministic TOA entry."""
    dev, dt, st = o.device, o.dtype, o.st
    nz = o.nz
    radiance = target == 'radiance'
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) % (1 << 63))
    kt = int(n_tallies)
    npix = st.nx * st.ny
    per = npix if radiance else npix * (nz + 1) * 3
    img = torch.zeros(kt * per, dtype=dt, device=dev)
    b = int(min(batch, max(n_photon, 1)))
    zf = torch.zeros(b, dtype=dt, device=dev)
    x, y, z, ux, uy, uz, w = (zf.clone() for _ in range(7))
    labs = torch.zeros((b, o.ng), dtype=dt, device=dev)
    lay = torch.zeros(b, dtype=torch.int64, device=dev)
    nscat = torch.zeros_like(lay)
    tid = torch.zeros_like(lay)
    alive = torch.zeros(b, dtype=torch.bool, device=dev)
    direct = torch.zeros_like(alive)
    launched = 0
    inv4pi = 1.0 / (4.0 * math.pi)

    def deposit(sel, ix, iy, contrib):
        """Radiance: (n, Ng) contributions of the lanes ``sel`` into their
        pixels."""
        img.index_add_(0, tid[sel] * per + ix * st.ny + iy,
                       (contrib * o.factors_rad).sum(dim=1).to(dt))

    def t_up(sel, ix, iy):
        sca, gas = _tau_up(o, lay[sel], z[sel], ix, iy)
        return torch.exp(labs[sel] - gas - sca[:, None])

    def cross(sel, lev, chi):
        """Flux: the crossings of the lanes ``sel`` at levels ``lev``."""
        ix, iy = _column(o, x[sel], y[sel])
        dep = (w[sel, None] * torch.exp(labs[sel])
               * o.factors_flux[lev]).sum(dim=1)
        row = (((tid[sel] * npix + ix * st.ny + iy) * (nz + 1) + lev) * 3
               + chi)
        img.index_add_(0, row, dep.to(dt))

    while True:
        n_alive = int(alive.sum())
        if n_alive == 0 and launched >= n_photon:
            break
        if launched >= n_photon and n_alive < x.shape[0] // 4:
            keep = torch.nonzero(alive).squeeze(1)
            x, y, z, ux, uy, uz, w, lay, nscat, tid, direct, alive = (
                v[keep] for v in (x, y, z, ux, uy, uz, w, lay, nscat, tid,
                                  direct, alive))
            labs = labs[keep]
        bl = x.shape[0]
        u = torch.rand((10, bl), generator=gen, device=dev,
                       dtype=torch.float32).clamp_(1e-7, 1.0 - 1e-7).to(dt)
        # ---- launch into dead lanes while the budget lasts ----
        if launched < n_photon:
            dead = ~alive
            rank = torch.cumsum(dead, 0)
            spawn = dead & (rank <= n_photon - launched)
            tid = torch.where(spawn, (launched + rank - 1) % kt, tid)
            launched += int(spawn.sum())
            x = torch.where(spawn, u[8] * o.lx, x)
            y = torch.where(spawn, u[9] * o.ly, y)
            z = torch.where(spawn, o.z_lev[nz], z)
            ux = torch.where(spawn, o.u0[0], ux)
            uy = torch.where(spawn, o.u0[1], uy)
            uz = torch.where(spawn, o.u0[2], uz)
            w = torch.where(spawn, 1.0, w)
            labs = torch.where(spawn[:, None], 0.0, labs)
            lay = torch.where(spawn, nz - 1, lay)
            nscat = torch.where(spawn, 0, nscat)
            direct = direct | spawn
            alive = alive | spawn
        # ---- flight within the current layer ----
        up = uz > 0
        z_face = torch.where(up, o.z_lev[lay + 1], o.z_lev[lay])
        d_exit = torch.where(uz.abs() > 1e-9,
                             torch.clamp((z_face - z) / uz, min=0.0),
                             torch.full_like(z, 1e30))
        s = -torch.log(u[2]) / o.sig_maj[lay]
        hit = alive & (s < d_exit)
        crossed = alive & ~hit
        step = torch.where(hit, s, torch.where(crossed, d_exit, 0.0))
        x = torch.remainder(x + ux * step, o.lx)
        y = torch.remainder(y + uy * step, o.ly)
        z = torch.where(crossed, z_face, z + uz * step)
        labs = labs - o.kabs[lay] * step[:, None]

        # ---- level crossings ----
        if not radiance:
            sel = torch.nonzero(crossed).squeeze(1)
            cross(sel, torch.where(up, lay + 1, lay)[sel],
                  torch.where(up, 2, torch.where(direct, 0, 1))[sel])
        lay = torch.where(crossed, torch.where(up, lay + 1, lay - 1), lay)
        alive = alive & ~(crossed & (lay >= nz))
        ground = crossed & (lay < 0)
        lay = torch.clamp(lay, 0, nz - 1)
        gsel = torch.nonzero(ground).squeeze(1)
        if radiance:
            # surface local estimate, before the reflection
            gx, gy = _column(o, x[gsel], y[gsel])
            deposit(gsel, gx, gy, (w[gsel] * (o.albedo / math.pi))[:, None]
                    * t_up(gsel, gx, gy))
        # Lambertian reflection: cosine-weighted upward direction
        mu_r = torch.sqrt(u[5])
        sin_r = torch.sqrt(torch.clamp(1.0 - u[5], min=0.0))
        ph = u[6] * (2.0 * math.pi)
        ux = torch.where(ground, sin_r * torch.cos(ph), ux)
        uy = torch.where(ground, sin_r * torch.sin(ph), uy)
        uz = torch.where(ground, mu_r, uz)
        w = torch.where(ground, w * o.albedo, w)
        direct = direct & ~ground
        if not radiance:
            cross(gsel, torch.zeros_like(gsel), torch.full_like(gsel, 2))

        # ---- tentative collisions ----
        ix, iy = _column(o, x, y)
        k = torch.clamp(lay - st.iz3l, 0, st.nz3 - 1)
        in_deck = (lay >= st.iz3l) & (lay < st.iz3l + st.nz3)
        ext_c = torch.where(in_deck, o.ext3d[ix, iy, k], 0.0)
        sig_r = o.sig_ray[lay]
        sig_real = sig_r + ext_c
        real = hit & (u[3] * o.sig_maj[lay] < sig_real)
        is_ray = u[4] * sig_real < sig_r
        apf = torch.where(is_ray, 0, o.apf3d[ix, iy, k])
        ssa = torch.where(is_ray, 1.0, o.ssa3d[ix, iy, k])
        if radiance:
            # volume local estimate toward the nadir sensor: cos = uz
            rsel = torch.nonzero(real).squeeze(1)
            mu_sc = uz[rsel]
            n_m = o.pt_p.shape[1]
            ib = torch.clamp(((mu_sc + 1.0) * 0.5 * (n_m - 1) + 0.5).long(),
                             0, n_m - 1)
            a_s = apf[rsel]
            row = a_s + torch.where(direct[rsel], o.n_pf, 0)
            p_val = torch.where(a_s == 0, 0.75 * (1.0 + mu_sc * mu_sc),
                                o.pt_p[row, ib])
            rx, ry = ix[rsel], iy[rsel]
            deposit(rsel, rx, ry, (w[rsel] * ssa[rsel] * p_val * inv4pi)
                    [:, None] * t_up(rsel, rx, ry))
        # new direction: Rayleigh analytically, the cloud from its table
        v = 2.0 * u[5] - 1.0
        q = 2.0 * v + torch.sqrt(4.0 * v * v + 1.0)
        qc = torch.sign(q) * torch.abs(q) ** (1.0 / 3.0)
        mu_ray = qc - 1.0 / qc
        n_u = o.pt_mu.shape[1]
        iu = torch.clamp((u[5] * (n_u - 1) + 0.5).long(), 0, n_u - 1)
        mu_n = torch.clamp(torch.where(apf == 0, mu_ray, o.pt_mu[apf, iu]),
                           -1.0, 1.0)
        psi = u[6] * (2.0 * math.pi)
        sn = torch.sqrt(torch.clamp(1.0 - mu_n * mu_n, min=0.0))
        cp, sp = torch.cos(psi), torch.sin(psi)
        st_ = torch.sqrt(torch.clamp(1.0 - uz * uz, min=0.0))
        vert = st_ < 1e-6
        nx_ = torch.where(vert, sn * cp,
                          mu_n * ux + sn * (ux * uz * cp - uy * sp)
                          / torch.clamp(st_, min=1e-6))
        ny_ = torch.where(vert, sn * sp,
                          mu_n * uy + sn * (uy * uz * cp + ux * sp)
                          / torch.clamp(st_, min=1e-6))
        nz_ = torch.where(vert, torch.sign(uz) * mu_n,
                          mu_n * uz - sn * cp * st_)
        ux = torch.where(real, nx_, ux)
        uy = torch.where(real, ny_, uy)
        uz = torch.where(real, nz_, uz)
        w = torch.where(real, w * ssa, w)
        direct = direct & ~real
        nscat = nscat + real.long()

        # ---- roulette and the scatter cap ----
        wmax = w * torch.exp(labs.max(dim=1).values)
        low = alive & (wmax < rr_wmin)
        p = torch.clamp(wmax / rr_wmin, 1e-12, 1.0)
        die = low & (u[7] > p)
        w = torch.where(low & ~die, w / p, w)
        alive = alive & ~die & (nscat < n_scat_max) & (w > 0)
    counts = [n_photon // kt + (1 if i < n_photon % kt else 0)
              for i in range(kt)]
    shape = (kt, st.nx, st.ny) if radiance else (kt, st.nx, st.ny, nz + 1, 3)
    return img.reshape(shape), counts


def reduce(o, img, n_launched, abs_coef, target):
    """Physical fields of one tally (``img[k]`` of :func:`run`, with its
    photons), by the frozen reductions: ``{'rad': (Nx, Ny)}``, or the flux
    dict of (Nx, Ny, Nz+1) arrays with the incoming beam at the top level;
    heating rate adds ``hr`` (Nz,) [K/day] of the domain-average net
    flux."""
    raw = img.float().cpu().numpy().astype(np.float64)[..., None]
    if target == 'radiance':
        return fout.reduce_radiance(raw, n_launched, abs_coef, o.mu0,
                                    precontracted=True)
    red = fout.reduce_flux(raw, n_launched, abs_coef, o.mu0,
                           precontracted=True)
    for k in ('f_down_direct', 'f_down'):
        red[k][..., -1] += o.toa_down
    if target == 'heating_rate':
        red['hr'] = heating.heating_rate(
            {k: red[k].mean(axis=(0, 1)) for k in ('f_down', 'f_up')},
            o.atm)
    return red

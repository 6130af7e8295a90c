"""Plain Monte Carlo reference of ``solve``'s nadir radiance over a uniform
Cox-Munk ocean, for the configuration ``oco2_o2a768``.

The transport is :mod:`.mc`'s (its optics, launch, per-layer majorant,
collisions, volume local estimate, roulette and reduction, unchanged), and
only the surface is this module's own:

* at a surface hit the nadir radiance gets the local estimate
  ``w * rho(wi -> nadir) * T``, ``T`` the transmission up the column;
* the reflected direction is drawn from a mixture (:func:`reflect`):
  with probability ``P_FACET`` a facet slope from the Gaussian density,
  mirrored, else a cosine-weighted direction; the weight is multiplied by
  ``rho(wi -> wo) mu_o / pdf(wo)``, ``pdf`` the mixture's density of
  ``wo`` (one-sample balance heuristic), whose mean is the directional
  albedo, whatever the BRDF.  The facet draw follows the glint, so the
  weights stay near the Fresnel reflectance; the cosine draw covers the
  whitecaps.  A Lambertian surface draws the cosine direction alone, with
  weight ``pi * rho``, the albedo;
* ``rho`` is the Cox-Munk ocean (:func:`coxmunk_rho`) written from its
  published form (Cox and Munk 1954, J. Opt. Soc. Am. 44, 838-850, in the
  angles of Nakajima and Tanaka 1983, JQSRT 29, 521-537): the Gaussian
  density of the facet slopes that mirror the sun into the view, times the
  Fresnel reflectance at the facet, over 4 mu_i mu_v cos^4 beta; whitecaps
  (Koepke 1984, Appl. Opt. 23, 1816-1824) add a Lambertian part.  A
  uniform Lambertian surface is ``rho = albedo / pi``.

Departures from the published model, as in the port's:

* the slope density is isotropic, with the total mean-square slope
  ``sigma^2 = 0.003 + 0.00512 u10`` of Cox and Munk's clean sea: no up-
  and cross-wind variances, no Gram-Charlier skewness or peakedness;
* no shadowing or hiding of facets by others (Smith 1967, Sancer 1969),
  and no second reflection between facets: what a facet would send into
  the lower hemisphere is lost, so ``rho`` lives on the upper one alone;
* the Fresnel reflectance is unpolarised and takes the real part of the
  refractive index (``refrac_r``); the imaginary part (~1e-7) is dropped;
* no light from below the surface: the water body is black;
* whitecaps cover ``diffuse_frac`` of the sea as a Lambertian reflector of
  albedo ``diffuse_alb``, and the glint is weighted by ``1 - diffuse_frac``.

Every float the transport holds is of ``dtype``: float32 is the reference,
bfloat16 the low-precision control.  Nothing here imports the port: it may
run where the port is absent.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..frozen import out as fout
from ..frozen import scene_np
from . import mc

__all__ = ['optics', 'run', 'reduce', 'coxmunk_rho', 'fresnel',
           'surface_rho', 'reflect']

_LAMBERTIAN, _COXMUNK = 1, 2
# the share of Cox-Munk reflections drawn by facet (the rest by cosine)
P_FACET = 0.75


def fresnel(cos_i, n):
    """Unpolarised Fresnel reflectance of a facet of real refractive index
    ``n`` (relative to air) at the cosine ``cos_i`` of incidence: the mean
    of the s and p reflectances (Born and Wolf, 1.5.2)."""
    cos_t = torch.sqrt(torch.clamp(1.0 - (1.0 - cos_i * cos_i) / (n * n),
                                   min=0.0))
    rs = (cos_i - n * cos_t) / (cos_i + n * cos_t)
    rp = (n * cos_i - cos_t) / (n * cos_i + cos_t)
    return 0.5 * (rs * rs + rp * rp)


def coxmunk_rho(mu_i, mu_v, cos_2w, refrac_r, slope_var, diffuse_frac,
                diffuse_alb):
    """Cox-Munk BRDF [1/sr] for the cosines ``mu_i`` of the sun's zenith
    angle and ``mu_v`` of the view's (both positive) and the cosine
    ``cos_2w`` of the angle between the directions toward the sun and
    toward the sensor.

    The facet that mirrors one into the other lies along their bisector:
    it is met at ``omega``, half that angle, and tilted by ``beta``, with
    ``cos beta = (mu_i + mu_v) / (2 cos omega)``; its slope density is
    ``exp(-tan^2 beta / sigma^2) / (pi sigma^2)``."""
    cos_w = torch.sqrt(torch.clamp(0.5 * (1.0 + cos_2w), min=1e-12))
    cos_b = (mu_i + mu_v) / (2.0 * cos_w)
    tan2_b = torch.clamp(1.0 / (cos_b * cos_b) - 1.0, min=0.0)
    p = torch.exp(-tan2_b / slope_var) / (math.pi * slope_var)
    glint = p * fresnel(cos_w, refrac_r) \
        / (4.0 * mu_i * mu_v * cos_b ** 4)
    return (1.0 - diffuse_frac) * glint + diffuse_frac * diffuse_alb / math.pi


def surface_rho(o, wx, wy, wz, vx, vy, vz):
    """BRDF [1/sr] of the surface from the travel direction ``w`` (down) of
    an incoming photon into the direction ``v`` (up)."""
    if o.sfc_kind == _LAMBERTIAN:
        return torch.full_like(wz, o.albedo / math.pi)
    mu_i = torch.clamp(-wz, min=1e-6)
    mu_v = torch.clamp(vz, min=1e-6)
    cos_2w = -(wx * vx + wy * vy + wz * vz)
    return coxmunk_rho(mu_i, mu_v, cos_2w, *o.ocean)


def reflect(o, wx, wy, wz, u_pick, u1, u2):
    """Draw the direction ``wo`` (up) into which a photon travelling along
    ``w`` (down) leaves the surface, and the factor ``rho mu_o / pdf`` of
    its weight (0 for a facet that mirrors it downward).

    Cox-Munk: with probability ``P_FACET`` (``u_pick``) a facet of slope
    ``(zx, zy)``, isotropic Gaussian of total variance ``sigma^2``
    (``|z|^2 = -sigma^2 ln u1``, azimuth ``2 pi u2``), mirrors ``w``;
    else ``wo`` is cosine-weighted (``mu_o = sqrt(u1)``).  The facet
    draw's density of ``wo`` is the density of its bisector ``h``,
    ``p(z) / cos^3 beta``, over ``4 wo.h``."""
    mu_c = torch.sqrt(u1)
    sin_c = torch.sqrt(torch.clamp(1.0 - u1, min=0.0))
    ph = u2 * (2.0 * math.pi)
    cos_d = (sin_c * torch.cos(ph), sin_c * torch.sin(ph), mu_c)
    if o.sfc_kind == _LAMBERTIAN:
        return cos_d, math.pi * surface_rho(o, wx, wy, wz, *cos_d)
    slope_var = o.ocean[1]
    t = torch.sqrt(-slope_var * torch.log(u1))
    c = 1.0 / torch.sqrt(1.0 + t * t)
    h = (-t * torch.cos(ph) * c, -t * torch.sin(ph) * c, c)
    wh = wx * h[0] + wy * h[1] + wz * h[2]
    fac = tuple(wv - 2.0 * wh * hv for wv, hv in zip((wx, wy, wz), h))
    pick = u_pick < P_FACET
    wo = tuple(torch.where(pick, a, b) for a, b in zip(fac, cos_d))
    up = wo[2] > 0.0
    # the bisector of -w and wo, and the two draws' densities of wo
    hb = tuple(v - wv for v, wv in zip(wo, (wx, wy, wz)))
    hn = torch.sqrt(hb[0] * hb[0] + hb[1] * hb[1] + hb[2] * hb[2])
    cos_b = torch.clamp(hb[2] / hn, min=1e-6)
    tan2_b = torch.clamp(1.0 / (cos_b * cos_b) - 1.0, min=0.0)
    p_h = torch.exp(-tan2_b / slope_var) / (math.pi * slope_var * cos_b ** 3)
    wo_h = torch.clamp((wo[0] * hb[0] + wo[1] * hb[1] + wo[2] * hb[2]) / hn,
                       min=1e-6)
    mu_o = torch.clamp(wo[2], min=0.0)
    pdf = P_FACET * p_h / (4.0 * wo_h) + (1.0 - P_FACET) * mu_o / math.pi
    f = surface_rho(o, wx, wy, wz, *wo) * mu_o / pdf
    return wo, torch.where(up, f, 0.0)


def optics(inputs, device, dtype=torch.float32):
    """:func:`.mc.optics` with the surface of ``inputs.solve_objects`` (a
    uniform Cox-Munk or Lambertian ``Surface``); float32 stays float32 on
    the card (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kw = inputs.solve_kw
    sfc = inputs.solve_objects.get('surface', kw.get('surface', 0.03))
    leaves, static = scene_np._build_numpy(
        inputs.atm, inputs.abs_coef, inputs.cld, inputs.pha, (), (), sfc,
        kw.get('solar_zenith_angle', 30.0),
        kw.get('solar_azimuth_angle', 0.0), False,
        kw.get('forward_trunc_deg'), None, None)
    jsfc = np.asarray(leaves['jsfc'])
    psfc = np.asarray(leaves['psfc'], dtype=np.float64)
    if jsfc.shape != (1, 1) or int(jsfc[0, 0]) not in (_LAMBERTIAN,
                                                       _COXMUNK):
        raise ValueError('the reference has a uniform Cox-Munk or '
                         'Lambertian surface')
    # mc's optics, handed the surface as a Lambertian stand-in: this
    # module draws and weighs every reflection itself
    f_rad, _ = fout.spectral_factors(inputs.abs_coef, nz_out=1)
    o = mc.Optics(dict(leaves, psfc=np.zeros((1, 1, 5), np.float32)),
                  dataclasses.replace(static, sfc_lambertian=True),
                  f_rad[0], np.zeros((static.nz + 1, static.ng)), device,
                  dtype)
    o.atm = inputs.atm
    o.sfc_kind = int(jsfc[0, 0])
    o.albedo = float(psfc[0, 0, 0])
    # (refrac_r, slope variance, whitecap fraction, whitecap albedo)
    p = psfc[0, 0]
    o.ocean = tuple(torch.tensor(float(v), dtype=dtype, device=device)
                    for v in (p[2], max(p[4], 1e-4), p[1], p[0]))
    return o


def run(o, n_photon, seed, target='radiance', batch=1 << 20, n_tallies=1,
        n_scat_max=2000, rr_wmin=0.1):
    """Trace ``n_photon`` photons: (K, Nx, Ny) nadir images contracted
    over g, dealt in turn to ``n_tallies`` independent tallies, and the
    photons launched into each (as :func:`.mc.run`)."""
    if target != 'radiance':
        raise ValueError('the reference traces nadir radiance only')
    dev, dt, st = o.device, o.dtype, o.st
    nz = o.nz
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) % (1 << 63))
    kt = int(n_tallies)
    npix = st.nx * st.ny
    img = torch.zeros(kt * npix, dtype=dt, device=dev)
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
        img.index_add_(0, tid[sel] * npix + ix * st.ny + iy,
                       (contrib * o.factors_rad).sum(dim=1).to(dt))

    def t_up(sel, ix, iy):
        sca, gas = mc._tau_up(o, lay[sel], z[sel], ix, iy)
        return torch.exp(labs[sel] - gas - sca[:, None])

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
        lay = torch.where(crossed, torch.where(up, lay + 1, lay - 1), lay)
        alive = alive & ~(crossed & (lay >= nz))
        ground = crossed & (lay < 0)
        lay = torch.clamp(lay, 0, nz - 1)

        # ---- the surface: local estimate toward nadir, then reflection --
        gsel = torch.nonzero(ground).squeeze(1)
        gx, gy = mc._column(o, x[gsel], y[gsel])
        wi = (ux[gsel], uy[gsel], uz[gsel])
        one, nil = torch.ones_like(wi[2]), torch.zeros_like(wi[2])
        rho_v = surface_rho(o, *wi, nil, nil, one)
        deposit(gsel, gx, gy, (w[gsel] * rho_v)[:, None] * t_up(gsel, gx, gy))
        # the reflection (u 3 and 4 decide nothing for a lane that
        # crossed a face this step)
        wo, f_r = reflect(o, *wi, u[3][gsel], u[5][gsel], u[6][gsel])
        w_r = w[gsel] * f_r
        ux, uy, uz = (v.index_put((gsel,), r) for v, r in zip((ux, uy, uz),
                                                              wo))
        w = w.index_put((gsel,), w_r.to(dt))
        direct = direct & ~ground

        # ---- tentative collisions ----
        ix, iy = mc._column(o, x, y)
        k = torch.clamp(lay - st.iz3l, 0, st.nz3 - 1)
        in_deck = (lay >= st.iz3l) & (lay < st.iz3l + st.nz3)
        ext_c = torch.where(in_deck, o.ext3d[ix, iy, k], 0.0)
        sig_r = o.sig_ray[lay]
        sig_real = sig_r + ext_c
        real = hit & (u[3] * o.sig_maj[lay] < sig_real)
        is_ray = u[4] * sig_real < sig_r
        apf = torch.where(is_ray, 0, o.apf3d[ix, iy, k])
        ssa = torch.where(is_ray, 1.0, o.ssa3d[ix, iy, k])
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
    return img.reshape(kt, st.nx, st.ny), counts


def reduce(o, img, n_launched, abs_coef, target):
    """``{'rad': (Nx, Ny)}`` of one tally, by :func:`.mc.reduce`."""
    return mc.reduce(o, img, n_launched, abs_coef, target)

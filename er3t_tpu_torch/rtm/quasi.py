"""Volume-rendered quasi-radiance, MCARaTS ``Wld_mtarget=3`` (port of
``er3t_tpu/rtm/quasi.py``).

Camera rays integrate the single-scattered solar source through the voxel
field — no Monte Carlo, one pass, noise-free — with the MC camera's model
and phase tables (TMS rows: single scattering exact under truncation):

    I(pixel) = int exp(-tau_view(s)) k_sca(s) P(Theta)/(4 pi)
               exp(-tau_sun(s)) ds   +  surface term,

the solar attenuation through the 3D deck marched along the slant sun path
(each deck layer sampled at the sun ray's midpoint column), or the local
vertical column under IPA, and gas absorption carried per g-point.  The
reference's ``lax.scan`` over ray steps is a plain loop here, accumulating
in the same order; the expressions keep the reference's operation order.
The ray march runs as plain PyTorch on the scene's device: it is not a
Pallas kernel in the reference.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .brdf import fresnel_unpolarized
from .mc import SolverConfig, resolve_device
from .scene import SceneArrays, SceneStatic, camera_rotation

__all__ = ['quasi_radiance']

_F = torch.float32
_I = torch.int32


def quasi_radiance(scene: SceneArrays, st: SceneStatic, cfg: SolverConfig,
                   n_steps: int = 512, *, device='cuda') -> torch.Tensor:
    """Render a (npix, npix, Ng) quasi-radiance image from the camera
    config (the ``cam_*`` fields of ``cfg``) on ``device`` (the card unless
    the caller asks for the CPU; the scene must be there).  Radiance is in
    the MC camera reduction's per-unit-solar-flux units; pixels outside the
    fisheye circle are NaN."""
    dev = resolve_device(scene, device)
    n_steps = int(n_steps)
    npix = cfg.cam_npix
    nz, ng = st.nz, st.ng
    z_lev = scene.z_lev
    dz_lay = z_lev[1:] - z_lev[:-1]
    z_top = z_lev[-1]
    lx = st.nx * st.dx
    ly = st.ny * st.dy

    # pixel directions: equidistant fisheye in the rotated camera frame
    i = (torch.arange(npix, dtype=_F, device=dev) + 0.5) / npix * 2.0 - 1.0
    px, py = torch.meshgrid(i, i, indexing='ij')
    pr = torch.sqrt(px ** 2 + py ** 2)
    # jnp.deg2rad of the half-angle: f32(qmax) * f32(pi / 180)
    qmax = float(np.float32(cfg.cam_qmax) * np.float32(np.pi / 180))
    theta = pr * qmax
    phi = torch.atan2(py, px)
    inside = pr < 1.0
    vx = torch.sin(theta) * torch.cos(phi)
    vy = torch.sin(theta) * torch.sin(phi)
    vz = torch.cos(theta)
    # camera -> world: the direction each pixel looks along
    rot = [[float(v) for v in row]
           for row in camera_rotation(cfg.cam_phi, cfg.cam_the, cfg.cam_psi)]
    d = torch.stack([(rot[r][0] * vx + rot[r][1] * vy + rot[r][2] * vz)
                     .reshape(-1) for r in range(3)], dim=1)      # (Np, 3)
    n_ray = d.shape[0]
    cam = torch.tensor([cfg.cam_xpos * lx, cfg.cam_ypos * ly, cfg.cam_zloc],
                       dtype=_F, device=dev)

    # ray length to the domain z-boundary (x, y wrap periodically)
    dzr = torch.where(torch.abs(d[:, 2]) < 1e-6,
                      1e-6 * torch.sign(d[:, 2] + 1e-30), d[:, 2])
    s_end = torch.where(d[:, 2] > 0, (z_top - cam[2]) / dzr,
                        (0.0 - cam[2]) / dzr)
    s_end = torch.minimum(torch.clamp(s_end, min=0.0),
                          4.0 * (z_top + lx + ly))
    ds = s_end / n_steps                                          # (Np,)

    # 1D profiles and the solar geometry
    sig_1d = scene.sig_ray + torch.sum(scene.sig_aer, dim=1)
    mu0 = scene.mu0
    cum_sig = torch.cat([torch.flip(torch.cumsum(
        torch.flip(sig_1d * dz_lay, [0]), 0), [0]),
        torch.zeros(1, dtype=_F, device=dev)])
    cum_abs = torch.cat([torch.flip(torch.cumsum(
        torch.flip(scene.kabs * dz_lay[:, None], [0]), 0), [0]),
        torch.zeros((1, ng), dtype=_F, device=dev)])
    dz3 = dz_lay[st.iz3l:st.iz3l + st.nz3]
    cum3d = torch.cat([torch.flip(torch.cumsum(
        torch.flip(scene.ext3d * dz3, [-1]), -1), [-1]),
        torch.zeros((st.nx, st.ny, 1), dtype=_F, device=dev)],
        dim=-1).reshape(-1)
    sin0 = torch.sqrt(torch.clamp(1.0 - mu0 ** 2, min=0.0))
    u0 = torch.stack([sin0 * torch.cos(scene.phi0),
                      sin0 * torch.sin(scene.phi0), -mu0])
    # scattering cosine sun -> camera per pixel: u0 . (-d)
    mu_sc = -(d @ u0)

    n_pf = scene.pt_mu.shape[0]
    n_m = scene.pt_p.shape[1]
    pt_p_flat = scene.pt_p.reshape(-1)

    def phase_eval(apf, mu):
        # TMS rows (second half): exact single scattering under truncation
        row = apf.long() + n_pf
        i0 = torch.clamp((((mu + 1.0) * 0.5 * (n_m - 1)) + 0.5).to(_I),
                         0, n_m - 1)
        return torch.where(apf == 0, 0.75 * (1.0 + mu * mu),
                           pt_p_flat[row * n_m + i0])

    p_ray = phase_eval(torch.zeros(n_ray, dtype=_I, device=dev), mu_sc)
    # per-constituent aerosol phase values per ray: (Np, Na)
    p_aer = torch.stack([phase_eval(r.expand(n_ray), mu_sc)
                         for r in scene.aer_apf], dim=1)

    ns3 = st.ns3
    # [ext_tot, cf_0..cf_{Ns-1}, ssa_0.., apf_0..] per voxel
    vox = torch.cat([scene.ext3d[..., None], scene.cf3d, scene.ssa3d,
                     scene.apf3d.to(_F)], dim=-1).reshape(-1, 1 + 3 * ns3)
    ext3d_flat = scene.ext3d.reshape(-1)
    z_hi_top = z_top - 1e-3
    # the deck's level altitudes, 0-d f32 tensors
    z_deck = [z_lev[st.iz3l + k] for k in range(st.nz3 + 1)]

    def sample(pos):
        """Optical properties and solar transmission at positions (Np, 3)."""
        x = torch.remainder(pos[:, 0], lx)
        y = torch.remainder(pos[:, 1], ly)
        z = torch.minimum(torch.clamp(pos[:, 2], min=0.0), z_hi_top)
        l = torch.clamp(torch.sum(z[:, None] >= z_lev[None, 1:], dim=1),
                        0, nz - 1)
        ix = torch.clamp((x / st.dx).to(_I), 0, st.nx - 1).long()
        iy = torch.clamp((y / st.dy).to(_I), 0, st.ny - 1).long()
        k3 = torch.clamp(l - st.iz3l, 0, st.nz3 - 1)
        if st.has_3d:
            in3 = (l >= st.iz3l) & (l < st.iz3l + st.nz3)
        else:
            in3 = torch.zeros(x.shape, dtype=torch.bool, device=dev)
        col = ix * st.ny + iy
        vr = vox[col * st.nz3 + k3]
        ext_c = torch.where(in3, vr[:, 0], 0.0)
        sig_r = scene.sig_ray[l]
        sig_ac = scene.sig_aer[l]                             # (Np, Na)
        kab = scene.kabs[l]                                   # (Np, Ng)
        # 1D solar attenuation: exact plane-parallel cumulative above z
        z_up = z_lev[l + 1]
        part = (sig_1d[l] * (z_up - z))[:, None] + kab * (z_up - z)[:, None]
        t_sun = cum_sig[l + 1][:, None] + cum_abs[l + 1] + part
        if st.has_3d and st.ipa:
            # IPA: vertical column by definition
            idx3 = col * (st.nz3 + 1) + torch.clamp(k3 + 1, 0, st.nz3)
            t3 = torch.where(in3, cum3d[idx3] + ext_c * (z_up - z),
                             torch.where(l >= st.iz3l + st.nz3, 0.0,
                                         cum3d[col * (st.nz3 + 1)]))
            t_sun = t_sun + t3[:, None]
        elif st.has_3d:
            # slant solar path: the sun ray up through each deck layer above
            # z, ext3d sampled at the ray's midpoint column
            t3 = torch.zeros_like(x)
            for k3s in range(st.nz3):
                z_lo3, z_hi3 = z_deck[k3s], z_deck[k3s + 1]
                z_b = torch.maximum(z, z_lo3)
                seg = torch.minimum(torch.clamp(z_hi3 - z_b, min=0.0),
                                    z_hi3 - z_lo3)
                z_mid = z_b + 0.5 * seg
                # going up by dz displaces horizontally by -u0_xy dz / mu0
                xm = torch.remainder(x - u0[0] * (z_mid - z) / mu0, lx)
                ym = torch.remainder(y - u0[1] * (z_mid - z) / mu0, ly)
                ixm = torch.clamp((xm / st.dx).to(_I), 0, st.nx - 1).long()
                iym = torch.clamp((ym / st.dy).to(_I), 0, st.ny - 1).long()
                idx = (ixm * st.ny + iym) * st.nz3 + k3s
                t3 = t3 + torch.where(seg > 0, ext3d_flat[idx] * seg, 0.0)
            t_sun = t_sun + t3[:, None]
        t_sun = t_sun / mu0
        return sig_r, sig_ac, ext_c, vr, in3, kab, t_sun, x, y

    tau_v = torch.zeros((n_ray, ng), dtype=_F, device=dev)
    acc = torch.zeros((n_ray, ng), dtype=_F, device=dev)
    for k in range(n_steps):
        s = (k + 0.5) * ds                # midpoint-sampled properties
        pos = cam[None, :] + d * s[:, None]
        sig_r, sig_ac, ext_c, vr, in3, kab, t_sun, _, _ = sample(pos)
        # source: Rayleigh + per-constituent aerosol + each 3D slot's
        # extinction share x its own ssa and phase (the exact mixture the
        # MC kernels sample by extinction share)
        cld_src = torch.zeros_like(ext_c)
        cf_prev = torch.zeros_like(ext_c)
        for s_ in range(ns3):
            cf_s = torch.where(in3, vr[:, 1 + s_], 1.0)
            ssa_s = vr[:, 1 + ns3 + s_]
            apf_s = torch.where(in3, vr[:, 1 + 2 * ns3 + s_], 0.0).to(_I)
            cld_src = cld_src + (cf_s - cf_prev) * ssa_s * phase_eval(apf_s,
                                                                     mu_sc)
            cf_prev = cf_s
        src = (sig_r * p_ray
               + torch.sum(sig_ac * scene.aer_ssa[None, :] * p_aer, dim=1)
               + ext_c * cld_src) / (4.0 * math.pi)
        sig_t = sig_r + torch.sum(sig_ac, dim=1) + ext_c      # scattering
        # exact within-step integral (constant properties per step):
        # src e^{-tau0} (1 - e^{-k ds}) / k
        k_ext = sig_t[:, None] + kab                          # (Np, Ng)
        dtau = k_ext * ds[:, None]
        atten = torch.exp(-tau_v - t_sun)
        seg_t = -torch.expm1(-dtau) / torch.clamp(k_ext, min=1e-12)
        acc = acc + atten * src[:, None] * seg_t
        tau_v = tau_v + dtau

    # surface term at the ray's surface hit: an effective Lambertian albedo
    # per surface type (quicklook-grade); for Cox-Munk psfc[..., 0] is the
    # whitecap albedo, blended with the Fresnel directional albedo at the
    # solar zenith for the specular fraction
    hit_sfc = d[:, 2] < 0
    pos_s = cam[None, :] + d * s_end[:, None]
    _, _, _, _, _, _, t_sun_s, xs, ys = sample(pos_s)
    psfc_f = scene.psfc.reshape(-1, 5)
    jsfc_f = scene.jsfc.reshape(-1)
    if st.nxs == 1 and st.nys == 1:
        idx_s = torch.zeros(n_ray, dtype=torch.long, device=dev)
    else:
        sxi = torch.clamp((xs / lx * st.nxs).to(_I), 0, st.nxs - 1).long()
        syi = torch.clamp((ys / ly * st.nys).to(_I), 0, st.nys - 1).long()
        idx_s = sxi * st.nys + syi
    p_s = psfc_f[idx_s]
    alb_cm = (p_s[:, 1] * p_s[:, 0]
              + (1.0 - p_s[:, 1])
              * fresnel_unpolarized(mu0.expand(n_ray), p_s[:, 2]))
    alb = torch.where(jsfc_f[idx_s] == 2, alb_cm, p_s[:, 0])
    i_sfc = (alb * mu0 / math.pi)[:, None] * torch.exp(-tau_v - t_sun_s)
    acc = acc + torch.where(hit_sfc[:, None], i_sfc, 0.0)
    acc = torch.where(inside.reshape(-1)[:, None], acc, math.nan)
    return acc.reshape(npix, npix, ng)

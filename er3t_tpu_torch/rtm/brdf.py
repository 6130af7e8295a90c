"""Surface BRDF evaluation and sampling (port of ``er3t_tpu/rtm/brdf.py``).

Three surface types, as in the reference: 1 Lambertian (param0 = albedo),
2 Cox-Munk ocean (diffuse_alb, diffuse_frac, refrac_r, refrac_i,
slope-variance), 4 LSRT RossThick-LiSparseR (f_iso, f_geo, f_vol).
``wi`` is the incident direction of travel (wi_z < 0), ``ws`` the direction
toward the sensor.  Every function is elementwise on (B,) tensors; ``psfc``
is (B, 5).  The expressions keep the reference's operation order so f32
results agree to the last few ulps of the transcendentals.
"""

from __future__ import annotations

import math

import torch

__all__ = ['fresnel_unpolarized', 'lsrt_brf', 'coxmunk_rho', 'brdf_eval',
           'brdf_sample_dir_weight']

_PI = math.pi


def fresnel_unpolarized(cos_i, n_ratio):
    """Unpolarized Fresnel reflectance at cos(incidence) for index ratio n."""
    cos_i = torch.clamp(cos_i, 1e-6, 1.0)
    sin2_t = torch.clamp((1.0 - cos_i ** 2) / n_ratio ** 2, 0.0, 1.0)
    cos_t = torch.sqrt(1.0 - sin2_t)
    rs = (cos_i - n_ratio * cos_t) / (cos_i + n_ratio * cos_t)
    rp = (n_ratio * cos_i - cos_t) / (n_ratio * cos_i + cos_t)
    return 0.5 * (rs * rs + rp * rp)


def _ross_thick(ci, cv, cphi, si, sv):
    cos_xi = torch.clamp(ci * cv + si * sv * cphi, -1.0, 1.0)
    xi = torch.arccos(cos_xi)
    return ((0.5 * _PI - xi) * cos_xi + torch.sin(xi)) / (ci + cv) - 0.25 * _PI


def _li_sparse_r(ci, cv, cphi, si, sv):
    # h/b = 2, b/r = 1 (MODIS MCD43 convention)
    ti = si / torch.clamp(ci, min=1e-6)
    tv = sv / torch.clamp(cv, min=1e-6)
    cos_xi = torch.clamp(ci * cv + si * sv * cphi, -1.0, 1.0)
    sec_i = 1.0 / torch.clamp(ci, min=1e-6)
    sec_v = 1.0 / torch.clamp(cv, min=1e-6)
    d2 = ti * ti + tv * tv - 2.0 * ti * tv * cphi
    sphi2 = torch.clamp(1.0 - cphi * cphi, 0.0, 1.0)
    cos_t = 2.0 * torch.sqrt(torch.clamp(d2, min=0.0) + ti * ti * tv * tv * sphi2) \
        / (sec_i + sec_v)
    cos_t = torch.clamp(cos_t, -1.0, 1.0)
    t = torch.arccos(cos_t)
    big_o = (t - torch.sin(t) * cos_t) * (sec_i + sec_v) / _PI
    return big_o - sec_i - sec_v + 0.5 * (1.0 + cos_xi) * sec_i * sec_v


def lsrt_brf(f_iso, f_geo, f_vol, mu_i, mu_v, cphi):
    """RossThick-LiSparseR bidirectional reflectance factor (unitless)."""
    mu_i = torch.clamp(mu_i, 1e-4, 1.0)
    mu_v = torch.clamp(mu_v, 1e-4, 1.0)
    si = torch.sqrt(torch.clamp(1.0 - mu_i ** 2, min=0.0))
    sv = torch.sqrt(torch.clamp(1.0 - mu_v ** 2, min=0.0))
    brf = f_iso + f_vol * _ross_thick(mu_i, mu_v, cphi, si, sv) \
        + f_geo * _li_sparse_r(mu_i, mu_v, cphi, si, sv)
    return torch.clamp(brf, min=0.0)


def coxmunk_rho(wix, wiy, wiz, wsx, wsy, wsz, refrac_r, slope_var,
                diffuse_alb, diffuse_frac):
    """Cox-Munk glint BRDF [1/sr] + whitecap Lambertian part."""
    # facet normal ~ ws - wi (wi is travel direction, pointing down)
    hx, hy, hz = wsx - wix, wsy - wiy, wsz - wiz
    hn = torch.sqrt(hx * hx + hy * hy + hz * hz)
    hn = torch.clamp(hn, min=1e-9)
    nx_, ny_, nz_ = hx / hn, hy / hn, hz / hn
    nz_ = torch.clamp(nz_, min=1e-4)
    sx = -nx_ / nz_
    sy = -ny_ / nz_
    p_slope = torch.exp(-(sx * sx + sy * sy) / slope_var) / (_PI * slope_var)
    cos_spec = torch.clamp(-(wix * nx_ + wiy * ny_ + wiz * nz_), 1e-6, 1.0)
    rf = fresnel_unpolarized(cos_spec, refrac_r)
    mu_i = torch.clamp(-wiz, 1e-4, 1.0)
    mu_v = torch.clamp(wsz, 1e-4, 1.0)
    glint = p_slope * rf / (4.0 * mu_i * mu_v * nz_ ** 4)
    wc = diffuse_frac * diffuse_alb / _PI
    return (1.0 - diffuse_frac) * glint + wc


def brdf_eval(jsfc, psfc, wix, wiy, wiz, wsx, wsy, wsz):
    """BRDF value [1/sr] toward the sensor, dispatched on surface type.

    ``ws*`` may be (B,) tensors or Python floats (a fixed sensor, filled
    to (B,) in f32 as JAX's weak-typed scalars are)."""
    if not isinstance(wsz, torch.Tensor):
        wsx, wsy, wsz = (torch.full_like(wiz, v) for v in (wsx, wsy, wsz))
    mu_i = torch.clamp(-wiz, 1e-4, 1.0)
    mu_v = torch.clamp(wsz, 1e-4, 1.0)
    si = torch.sqrt(torch.clamp(1.0 - mu_i ** 2, min=1e-12))
    sv = torch.sqrt(torch.clamp(1.0 - mu_v ** 2, min=1e-12))
    # relative azimuth between incident (reversed) and view directions
    cphi = torch.clamp((-wix * wsx - wiy * wsy) / (si * sv), -1.0, 1.0)

    rho_lam = psfc[:, 0] / _PI
    rho_lsrt = lsrt_brf(psfc[:, 0], psfc[:, 1], psfc[:, 2], mu_i, mu_v,
                        cphi) / _PI
    rho_cm = coxmunk_rho(wix, wiy, wiz, wsx, wsy, wsz,
                         psfc[:, 2], torch.clamp(psfc[:, 4], min=1e-4),
                         psfc[:, 0], psfc[:, 1])
    return torch.where(jsfc == 2, rho_cm,
                       torch.where(jsfc == 4, rho_lsrt, rho_lam))


def brdf_sample_dir_weight(jsfc, psfc, wix, wiy, wiz, u1, u2, u3, u4):
    """Sample a reflected direction and its weight multiplier.

    Lambertian: cosine direction, weight = albedo.  LSRT: cosine direction,
    weight = BRF(w').  Cox-Munk: whitecap bounce with prob diffuse_frac,
    else Gaussian-slope facet reflection with the Fresnel weight; downward
    reflections get weight 0.  Returns ``(ux, uy, uz, w, (is_cm,
    whitecap, up_ok))``: the masks of the Cox-Munk branch, a lane on a
    Cox-Munk surface, its whitecap draw and an upward facet reflection.
    """
    # cosine-weighted candidate
    mu_r = torch.sqrt(u1)
    sin_r = torch.sqrt(torch.clamp(1.0 - u1, min=0.0))
    psi = u2 * (2.0 * _PI)
    cx, cy, cz = sin_r * torch.cos(psi), sin_r * torch.sin(psi), mu_r

    # Cox-Munk: whitecap branch decided by u3, rescaled for the slope draw
    whitecap = u3 < psfc[:, 1]
    u3s = torch.clamp((u3 - psfc[:, 1])
                      / torch.clamp(1.0 - psfc[:, 1], min=1e-6), 1e-9, 1.0)
    slope_var = torch.clamp(psfc[:, 4], min=1e-4)
    r = torch.sqrt(-torch.log(u3s) * slope_var)
    th = u4 * (2.0 * _PI)
    sx, sy = r * torch.cos(th), r * torch.sin(th)
    inv = 1.0 / torch.sqrt(1.0 + sx * sx + sy * sy)
    nx_, ny_, nz_ = -sx * inv, -sy * inv, inv
    dot = wix * nx_ + wiy * ny_ + wiz * nz_
    rx = wix - 2.0 * dot * nx_
    ry = wiy - 2.0 * dot * ny_
    rz = wiz - 2.0 * dot * nz_
    cos_spec = torch.clamp(-dot, 1e-6, 1.0)
    rf = fresnel_unpolarized(cos_spec, psfc[:, 2])
    up_ok = rz > 1e-3
    # unbiased weight under Gaussian-slope sampling, R_F |wi.n| / (mu_i nz)
    # (see the reference for the Jacobians)
    mu_i_cm = torch.clamp(-wiz, 1e-4, 1.0)
    w_cm_spec = torch.where(up_ok, rf * cos_spec / (mu_i_cm * nz_), 0.0)
    # whitecap branch uses the cosine candidate
    w_cm = torch.where(whitecap, psfc[:, 0], w_cm_spec)
    ux_cm = torch.where(whitecap, cx, rx)
    uy_cm = torch.where(whitecap, cy, ry)
    uz_cm = torch.where(whitecap, cz, torch.where(up_ok, rz, 1.0))

    # LSRT weight under cosine sampling
    mu_i = torch.clamp(-wiz, 1e-4, 1.0)
    si = torch.sqrt(torch.clamp(1.0 - mu_i ** 2, min=1e-12))
    sv = torch.sqrt(torch.clamp(1.0 - mu_r ** 2, min=1e-12))
    cphi = torch.clamp((-wix * cx - wiy * cy) / (si * sv), -1.0, 1.0)
    w_lsrt = lsrt_brf(psfc[:, 0], psfc[:, 1], psfc[:, 2], mu_i, mu_r, cphi)

    is_cm = jsfc == 2
    is_lsrt = jsfc == 4
    ux = torch.where(is_cm, ux_cm, cx)
    uy = torch.where(is_cm, uy_cm, cy)
    uz = torch.where(is_cm, uz_cm, cz)
    w = torch.where(is_cm, w_cm, torch.where(is_lsrt, w_lsrt, psfc[:, 0]))
    return ux, uy, uz, torch.clamp(w, min=0.0), (is_cm, whitecap, up_ok)

// The second half of the flight step for one photon lane: the local
// estimate toward a nadir-or-slant satellite sensor, the absorbed-energy
// tally of domain-average flux, the turn (scattering or surface
// reflection), the Russian roulette and the counters of a stats flight.
//
// Every function here is __host__ __device__: flight_post.cu runs
// post_lane once per CUDA thread, and host_twin.cpp builds the same
// body with a host C++ compiler into a library that the CPU tests hold
// against FlightKernel._step_post (er3t_tpu_torch/rtm/mc_flight.py), the
// plain version.  The arithmetic follows the plain version's operation
// order (brdf.py, mc.py rotate); what differs is that a lane computes only
// its own surface branch, and that the device compiler may contract a*b+c
// into one FMA.  No include of the CUDA headers: a host compiler reads
// this file as plain C++.
#pragma once

#include <math.h>
#include <stdint.h>

#ifdef __CUDACC__
#define ER3T_HD __host__ __device__ __forceinline__
#else
#define ER3T_HD inline
#endif

namespace er3t {
namespace post {

// The kernel's one argument, passed by value; its layout is mirrored field
// for field by flight_post.PostArgs (ctypes) and checked at load through
// er3t_flight_post_args_size.  Lane arrays have n entries, rows of the
// (rows, n) arrays (labs, tau_sens_abs, u) are n apart.  bool lanes are
// one byte each (torch.bool).
struct PostArgs {
  // the lanes as the first half leaves them
  const float* x;
  const float* y;
  const float* z;
  const float* ux;
  const float* uy;
  const float* uz;
  const float* wsc;
  const float* labs;          // (ng + 1, n)
  const float* tau;
  const int* nscat;
  const uint8_t* alive;
  const uint8_t* direct;
  const int* ix0;
  const int* iy0;
  const float* plen;
  const int64_t* launched;    // one value
  // the step's locals
  const uint8_t* active;
  const uint8_t* accept;
  const uint8_t* collided;
  const uint8_t* hit_sfc;
  const uint8_t* exit_toa;
  const uint8_t* tclamp;
  const uint8_t* zclamp;
  const int* ix;              // the voxel column (surface rows by column)
  const int64_t* l_col;       // the collision layer
  const int* apf;             // the phase-function row (0: Rayleigh)
  const float* tau3_above;
  const float* tau_sens_abs;  // (ng, n)
  const float* tau_sens_sig;
  const float* ssa_ev;
  const float* mu_sc;
  const float* pe;            // K1's phase value toward the sensor
  const float* mu_new;        // K1's scattering cosine
  const float* u;             // (14, n) deviates; rows 5-10 are read
  // tables
  const float* sfc_tab;       // (surface rows, 6): jsfc, p0..p4
  const float* rad_w;         // (ng,) spectral factors of the image
  // the new lanes; a null pass-through pointer (x ... launched) is not
  // written, the caller keeps the first half's tensor
  float* o_x;
  float* o_y;
  float* o_z;
  float* o_labs;
  float* o_plen;
  int* o_ix0;
  int* o_iy0;
  int64_t* o_launched;
  float* o_ux;
  float* o_uy;
  float* o_uz;
  float* o_wsc;
  float* o_tau;
  int* o_nscat;
  uint8_t* o_alive;
  uint8_t* o_direct;
  // tallies and counters (accumulated; a null counter is not kept)
  float* rad;                 // (pixels,) image, with estimate
  float* absorbed;            // (nz, ng), with tally_absorbed
  int64_t* outcome;           // (5,) real, tentative, surface, toa, stopped
  int64_t* sfc_branch;        // (3,) specular, whitecap, lost
  int64_t* tile_stops;        // (2,) active, clamped at a tile face
  // sizes and switches
  int n;
  int ng;
  int nz;
  int estimate;               // 1: the nadir/slant image estimate
  int tally_absorbed;
  int sfc_mode;               // 0 uniform, 1 by voxel column, 2 by fraction
  int nxs;
  int nys;
  int nx_img;                 // image columns along x (the global nx)
  int ny_img;
  int n_scat_max;
  int rr_sensor;              // the sensor-importance roulette (rr_value)
  // constants, f32 as the plain version's scalars round them
  float lx;
  float ly;
  float dx;
  float dy;
  float sx;
  float sy;
  float mu_s;
  float sx_mu;                // sx / mu_s
  float sy_mu;
  float den_vol;              // 4 pi mu_s
  float rr_wmin;
  float rr_value;
};

// counter bits of one lane
enum : unsigned {
  kReal = 1u << 0,
  kTentative = 1u << 1,
  kSurface = 1u << 2,
  kToa = 1u << 3,
  kStopped = 1u << 4,
  kSpecular = 1u << 5,
  kWhitecap = 1u << 6,
  kLost = 1u << 7,
  kActive = 1u << 8,
  kTileClamp = 1u << 9,
};
constexpr int kCounterBits = 10;

constexpr float kPi = 3.14159265358979323846f;
constexpr float kHalfPi = 1.57079632679489662f;
constexpr float kQuarterPi = 0.785398163397448310f;
constexpr float kTwoPi = 6.28318530717958648f;

// torch.clamp: NaN passes through
ER3T_HD float clampf(float v, float lo, float hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}
ER3T_HD float clamp_lo(float v, float lo) { return v < lo ? lo : v; }
ER3T_HD int clamp_int(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}
// torch.remainder of floats: fmod, moved to the divisor's sign
ER3T_HD float remf(float a, float b) {
  float m = fmodf(a, b);
  if (m != 0.0f && ((b < 0.0f) != (m < 0.0f))) m += b;
  return m;
}
ER3T_HD int rem_int(int a, int b) {
  int m = a % b;
  if (m != 0 && ((b < 0) != (m < 0))) m += b;
  return m;
}
ER3T_HD float signf(float v) {
  return (float)((v > 0.0f) - (v < 0.0f));
}

// ---- surfaces (rtm/brdf.py) ----

ER3T_HD float fresnel_unpolarized(float cos_i, float n) {
  cos_i = clampf(cos_i, 1e-6f, 1.0f);
  const float sin2_t = clampf((1.0f - cos_i * cos_i) / (n * n), 0.0f, 1.0f);
  const float cos_t = sqrtf(1.0f - sin2_t);
  const float rs = (cos_i - n * cos_t) / (cos_i + n * cos_t);
  const float rp = (n * cos_i - cos_t) / (n * cos_i + cos_t);
  return 0.5f * (rs * rs + rp * rp);
}

ER3T_HD float lsrt_brf(float f_iso, float f_geo, float f_vol, float mu_i,
                       float mu_v, float cphi) {
  const float ci = clampf(mu_i, 1e-4f, 1.0f);
  const float cv = clampf(mu_v, 1e-4f, 1.0f);
  const float si = sqrtf(clamp_lo(1.0f - ci * ci, 0.0f));
  const float sv = sqrtf(clamp_lo(1.0f - cv * cv, 0.0f));
  const float cos_xi = clampf(ci * cv + si * sv * cphi, -1.0f, 1.0f);
  // RossThick
  const float xi = acosf(cos_xi);
  const float ross = ((kHalfPi - xi) * cos_xi + sinf(xi)) / (ci + cv)
      - kQuarterPi;
  // LiSparseR, h/b = 2, b/r = 1
  const float ti = si / clamp_lo(ci, 1e-6f);
  const float tv = sv / clamp_lo(cv, 1e-6f);
  const float sec_i = 1.0f / clamp_lo(ci, 1e-6f);
  const float sec_v = 1.0f / clamp_lo(cv, 1e-6f);
  const float d2 = ti * ti + tv * tv - 2.0f * ti * tv * cphi;
  const float sphi2 = clampf(1.0f - cphi * cphi, 0.0f, 1.0f);
  float cos_t = 2.0f * sqrtf(clamp_lo(d2, 0.0f) + ti * ti * tv * tv * sphi2)
      / (sec_i + sec_v);
  cos_t = clampf(cos_t, -1.0f, 1.0f);
  const float t = acosf(cos_t);
  const float big_o = (t - sinf(t) * cos_t) * (sec_i + sec_v) / kPi;
  const float li = big_o - sec_i - sec_v
      + 0.5f * (1.0f + cos_xi) * sec_i * sec_v;
  return clamp_lo(f_iso + f_vol * ross + f_geo * li, 0.0f);
}

// brdf_eval toward the sensor direction (wsx, wsy, wsz), for the lane's
// own surface type only
ER3T_HD float brdf_eval(int jsfc, const float* p, float wix, float wiy,
                        float wiz, float wsx, float wsy, float wsz) {
  if (jsfc == 2) {
    // Cox-Munk glint + whitecap Lambertian part
    const float hx = wsx - wix, hy = wsy - wiy, hz = wsz - wiz;
    const float hn = clamp_lo(sqrtf(hx * hx + hy * hy + hz * hz), 1e-9f);
    const float nx = hx / hn, ny = hy / hn;
    const float nz = clamp_lo(hz / hn, 1e-4f);
    const float slope_var = clamp_lo(p[4], 1e-4f);
    const float sx = -nx / nz, sy = -ny / nz;
    const float p_slope = expf(-(sx * sx + sy * sy) / slope_var)
        / (kPi * slope_var);
    const float cos_spec = clampf(-(wix * nx + wiy * ny + wiz * nz), 1e-6f,
                                  1.0f);
    const float rf = fresnel_unpolarized(cos_spec, p[2]);
    const float mu_i = clampf(-wiz, 1e-4f, 1.0f);
    const float mu_v = clampf(wsz, 1e-4f, 1.0f);
    const float nz2 = nz * nz;
    const float glint = p_slope * rf / (4.0f * mu_i * mu_v * (nz2 * nz2));
    const float wc = p[1] * p[0] / kPi;
    return (1.0f - p[1]) * glint + wc;
  }
  if (jsfc == 4) {
    const float mu_i = clampf(-wiz, 1e-4f, 1.0f);
    const float mu_v = clampf(wsz, 1e-4f, 1.0f);
    const float si = sqrtf(clamp_lo(1.0f - mu_i * mu_i, 1e-12f));
    const float sv = sqrtf(clamp_lo(1.0f - mu_v * mu_v, 1e-12f));
    const float cphi = clampf((-wix * wsx - wiy * wsy) / (si * sv), -1.0f,
                              1.0f);
    return lsrt_brf(p[0], p[1], p[2], mu_i, mu_v, cphi) / kPi;
  }
  return p[0] / kPi;
}

// brdf_sample_dir_weight for the lane's own surface type: the reflected
// direction, its weight, and (Cox-Munk) the branch bits kSpecular,
// kWhitecap or kLost
ER3T_HD void brdf_sample(int jsfc, const float* p, float wix, float wiy,
                         float wiz, float u1, float u2, float u3, float u4,
                         float* ox, float* oy, float* oz, float* ow,
                         unsigned* branch) {
  // cosine-weighted candidate
  const float mu_r = sqrtf(u1);
  const float sin_r = sqrtf(clamp_lo(1.0f - u1, 0.0f));
  const float psi = u2 * kTwoPi;
  const float cx = sin_r * cosf(psi), cy = sin_r * sinf(psi), cz = mu_r;
  float w;
  *branch = 0u;
  if (jsfc == 2) {
    if (u3 < p[1]) {
      // whitecap bounce on the cosine candidate
      *ox = cx;
      *oy = cy;
      *oz = cz;
      w = p[0];
      *branch = kWhitecap;
    } else {
      const float u3s = clampf((u3 - p[1]) / clamp_lo(1.0f - p[1], 1e-6f),
                               1e-9f, 1.0f);
      const float slope_var = clamp_lo(p[4], 1e-4f);
      const float r = sqrtf(-logf(u3s) * slope_var);
      const float th = u4 * kTwoPi;
      const float sx = r * cosf(th), sy = r * sinf(th);
      const float inv = 1.0f / sqrtf(1.0f + sx * sx + sy * sy);
      const float nx = -sx * inv, ny = -sy * inv, nz = inv;
      const float dot = wix * nx + wiy * ny + wiz * nz;
      const float rx = wix - 2.0f * dot * nx;
      const float ry = wiy - 2.0f * dot * ny;
      const float rz = wiz - 2.0f * dot * nz;
      const bool up_ok = rz > 1e-3f;
      if (up_ok) {
        const float cos_spec = clampf(-dot, 1e-6f, 1.0f);
        const float rf = fresnel_unpolarized(cos_spec, p[2]);
        const float mu_i = clampf(-wiz, 1e-4f, 1.0f);
        w = rf * cos_spec / (mu_i * nz);
      } else {
        w = 0.0f;
      }
      *ox = rx;
      *oy = ry;
      *oz = up_ok ? rz : 1.0f;
      *branch = up_ok ? kSpecular : kLost;
    }
  } else {
    *ox = cx;
    *oy = cy;
    *oz = cz;
    if (jsfc == 4) {
      // LSRT weight under cosine sampling
      const float mu_i = clampf(-wiz, 1e-4f, 1.0f);
      const float si = sqrtf(clamp_lo(1.0f - mu_i * mu_i, 1e-12f));
      const float sv = sqrtf(clamp_lo(1.0f - mu_r * mu_r, 1e-12f));
      const float cphi = clampf((-wix * cx - wiy * cy) / (si * sv), -1.0f,
                                1.0f);
      w = lsrt_brf(p[0], p[1], p[2], mu_i, mu_r, cphi);
    } else {
      w = p[0];
    }
  }
  *ow = clamp_lo(w, 0.0f);
}

// mc.rotate: turn (ux, uy, uz) by polar cosine mu and azimuth psi
ER3T_HD void rotate(float ux, float uy, float uz, float mu, float psi,
                    float* ox, float* oy, float* oz) {
  const float sin_t = sqrtf(clamp_lo(1.0f - mu * mu, 0.0f));
  const float cp = cosf(psi), sp = sinf(psi);
  float nx, ny, nz;
  if (fabsf(uz) > 0.99999f) {
    nx = sin_t * cp;
    ny = sin_t * sp;
    nz = mu * signf(uz);
  } else {
    const float denom = sqrtf(clamp_lo(1.0f - uz * uz, 1e-12f));
    nx = sin_t * (ux * uz * cp - uy * sp) / denom + ux * mu;
    ny = sin_t * (uy * uz * cp + ux * sp) / denom + uy * mu;
    nz = -sin_t * cp * denom + uz * mu;
  }
  const float norm = 1.0f / sqrtf(nx * nx + ny * ny + nz * nz);
  *ox = nx * norm;
  *oy = ny * norm;
  *oz = nz * norm;
}

// ---- one lane ----

// Lane i of the post half.  Reads every input of the lane before it writes
// any output of the lane, so the new lanes may be written over the first
// half's (o_* == the input arrays).  The image deposit and the absorbed
// energy go to sink.deposit(pixel, value) and sink.absorb(entry, value);
// the return value holds the lane's counter bits.
template <class Sink>
ER3T_HD unsigned post_lane(const PostArgs& a, int i, Sink& sink) {
  const int n = a.n, ng = a.ng;
  const float x = a.x[i], y = a.y[i], z = a.z[i];
  const float ux = a.ux[i], uy = a.uy[i], uz = a.uz[i];
  const float wsc = a.wsc[i];
  const bool active = a.active[i] != 0, accept = a.accept[i] != 0;
  const bool hit_sfc = a.hit_sfc[i] != 0, exit_toa = a.exit_toa[i] != 0;
  const bool tclamp = a.tclamp[i] != 0;
  const float ssa = a.ssa_ev[i];
  const float sens_tau = a.tau_sens_sig[i] + a.tau3_above[i];
  const float labs_best = a.labs[(size_t)ng * n + i];
  const float* u = a.u;
  const float u5 = u[(size_t)5 * n + i], u6 = u[(size_t)6 * n + i];
  const float u7 = u[(size_t)7 * n + i], u8 = u[(size_t)8 * n + i];

  unsigned bits = 0u;
  if (accept) bits |= kReal;
  if (a.collided[i]) bits |= kTentative;
  if (hit_sfc) bits |= kSurface;
  if (exit_toa) bits |= kToa;
  if (tclamp || a.zclamp[i]) bits |= kStopped;
  if (active) bits |= kActive;
  if (tclamp) bits |= kTileClamp;

  // the surface row under the lane (read only where a surface term needs it)
  int jsfc = 1;
  float psfc[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (hit_sfc) {
    int row = 0;
    if (a.sfc_mode != 0) {
      const int sxi = a.sfc_mode == 1
          ? a.ix[i]
          : clamp_int((int)floorf(x / a.lx * (float)a.nxs), 0, a.nxs - 1);
      const int syi = rem_int((int)floorf(y / a.ly * (float)a.nys), a.nys);
      row = sxi * a.nys + syi;
    }
    const float* s = a.sfc_tab + (size_t)row * 6;
    jsfc = (int)s[0];
    for (int k = 0; k < 5; ++k) psfc[k] = s[k + 1];
  }

  // ---- the local estimate toward the sensor ----
  if (a.estimate && (accept || hit_sfc)) {
    float w_ev;  // the event's weight toward the sensor before attenuation
    if (accept) {
      const float m = a.mu_sc[i];
      const float pval = a.apf[i] == 0 ? 0.75f * (1.0f + m * m) : a.pe[i];
      w_ev = wsc * ssa * pval / a.den_vol;
    } else {
      w_ev = wsc * brdf_eval(jsfc, psfc, ux, uy, uz, a.sx, a.sy, a.mu_s);
    }
    float dep = 0.0f;
    for (int g = 0; g < ng; ++g) {
      const float t = expf(a.labs[(size_t)g * n + i]
                           - a.tau_sens_abs[(size_t)g * n + i] - sens_tau);
      dep += a.rad_w[g] * (w_ev * t);
    }
    // slant projection onto the TOA image plane, periodic in x and y
    const float xp = remf(x - a.sx_mu * z, a.lx);
    const float yp = remf(y - a.sy_mu * z, a.ly);
    const int gix = clamp_int((int)floorf(xp / a.dx), 0, a.nx_img - 1);
    const int giy = rem_int((int)floorf(yp / a.dy), a.ny_img);
    sink.deposit(gix * a.ny_img + giy, dep);
  }

  // particulate absorption at accepted collisions (domain-average flux)
  if (a.tally_absorbed && accept) {
    const float ab_c = wsc * (1.0f - ssa);
    const int row = (int)a.l_col[i] * ng;
    for (int g = 0; g < ng; ++g)
      sink.absorb(row + g, expf(a.labs[(size_t)g * n + i]) * ab_c);
  }

  // ---- the turn ----
  float nux = ux, nuy = uy, nuz = uz, nw = wsc;
  if (accept) {
    rotate(ux, uy, uz, a.mu_new[i], u6 * kTwoPi, &nux, &nuy, &nuz);
    nw = wsc * ssa;
  } else if (hit_sfc) {
    float bw;
    unsigned branch;
    brdf_sample(jsfc, psfc, ux, uy, uz, u5, u6, u[(size_t)9 * n + i],
                u[(size_t)10 * n + i], &nux, &nuy, &nuz, &bw, &branch);
    nw = wsc * bw;
    bits |= branch;
  }
  const int nscat = a.nscat[i] + (accept ? 1 : 0);
  const bool direct = a.direct[i] != 0 && !accept && !hit_sfc;
  const float tau = active ? -logf(u7) : a.tau[i];

  // ---- termination and the roulette ----
  bool alive = a.alive[i] != 0 && !exit_toa && nscat < a.n_scat_max
      && nw > 0.0f;
  const float wmax = nw * expf(labs_best);
  bool need_rr = active && wmax < a.rr_wmin;
  float p_surv = clampf(wmax / a.rr_wmin, 0.0f, 1.0f);
  if (a.rr_sensor) {
    // sensor-importance roulette: future deposits scale like wmax times
    // the escape probability toward the sensor, ~1 / (1 + tau_v)
    const float tau_v = sens_tau * a.mu_s;
    const float p_val = clampf(wmax / ((1.0f + tau_v) * a.rr_value), 0.05f,
                               1.0f);
    need_rr = need_rr || (active && p_val < 1.0f);
    // torch.minimum: NaN wins
    p_surv = (p_surv != p_surv || p_val != p_val) ? p_surv + p_val
        : (p_val < p_surv ? p_val : p_surv);
  }
  const bool die = need_rr && u8 > p_surv;
  if (need_rr && !die) nw = nw / clamp_lo(p_surv, 1e-12f);
  alive = alive && !die;

  // ---- the new lane ----
  if (a.o_x) {
    a.o_x[i] = x;
    a.o_y[i] = y;
    a.o_z[i] = z;
    a.o_plen[i] = a.plen[i];
    a.o_ix0[i] = a.ix0[i];
    a.o_iy0[i] = a.iy0[i];
    for (int g = 0; g <= ng; ++g)
      a.o_labs[(size_t)g * n + i] = a.labs[(size_t)g * n + i];
  }
  a.o_ux[i] = nux;
  a.o_uy[i] = nuy;
  a.o_uz[i] = nuz;
  a.o_wsc[i] = nw;
  a.o_tau[i] = tau;
  a.o_nscat[i] = nscat;
  a.o_alive[i] = alive ? 1 : 0;
  a.o_direct[i] = direct ? 1 : 0;
  return bits;
}

// The counters the arguments keep, as a mask of counter bits.
ER3T_HD unsigned counted_bits(const PostArgs& a) {
  unsigned m = 0u;
  if (a.outcome) m |= kReal | kTentative | kSurface | kToa | kStopped;
  if (a.sfc_branch) m |= kSpecular | kWhitecap | kLost;
  if (a.tile_stops) m |= kActive | kTileClamp;
  return m;
}

// The int64 counter that counter bit k adds to.
ER3T_HD int64_t* counter_of(const PostArgs& a, int k) {
  if (k < 5) return a.outcome ? a.outcome + k : nullptr;
  if (k < 8) return a.sfc_branch ? a.sfc_branch + (k - 5) : nullptr;
  return a.tile_stops ? a.tile_stops + (k - 8) : nullptr;
}

}  // namespace post
}  // namespace er3t

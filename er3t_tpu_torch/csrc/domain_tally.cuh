// The domain-average flux tallies of one flight, for one photon lane and
// one g-point: every level the flight crosses adds the lane's weight,
// attenuated by the gas absorption up to the crossing, to its (level,
// channel, g) entry; every layer it traverses adds the energy the gas
// absorbed there to its (layer, g) entry (MCARaTS Flx_mhrt).
//
// __host__ __device__, as flight_post.cuh: domain_tally.cu runs
// tally_lane_g once per CUDA thread, and the CPU tests build the same body
// for the host (host_twin.cpp) and hold it against the dense (B, Nlev, Ng)
// PyTorch tally of FlightKernel._step_pre (er3t_tpu_torch/rtm/mc_flight.py),
// the plain version.  The sums over layers run in the plain version's
// order (its cumsum); no include of the CUDA headers.
#pragma once

#include <math.h>
#include <stdint.h>

#ifdef __CUDACC__
#define ER3T_HD __host__ __device__ __forceinline__
#else
#define ER3T_HD inline
#endif

namespace er3t {
namespace tally {

// The kernel's one argument, passed by value; mirrored field for field by
// domain_tally.TallyArgs (ctypes).  Lane arrays have n entries; rows of
// labs (ng + 1, n) and trav (nz, n) are n apart.
struct TallyArgs {
  const float* z;             // the flight's start
  const float* uz;
  const float* inv_uz;        // 1 / uz, kept off zero
  const float* s_star;        // the flight's length
  const float* wsc;
  const float* labs;          // (ng + 1, n), before this flight's absorption
  const float* trav;          // (nz, n) path in each layer, 0 if inactive
  const uint8_t* active;
  const uint8_t* term;        // ended at the surface or TOA
  const uint8_t* direct;
  const float* z_lev;         // (nz + 1,)
  const float* kabs;          // (nz, ng) gas absorption coefficients
  float* flux;                // ((nz + 1) * 3, ng): level, channel, g
  float* absorbed;            // (nz, ng)
  int n;
  int ng;
  int nz;
};

// Lane i's tallies at g-point g, to sink.add_flux(entry, value) and
// sink.add_absorbed(entry, value).
template <class Sink>
ER3T_HD void tally_lane_g(const TallyArgs& a, int i, int g, Sink& sink) {
  if (!a.active[i]) return;
  const int n = a.n, ng = a.ng, nz = a.nz;
  const float z = a.z[i], inv_uz = a.inv_uz[i], s_star = a.s_star[i];
  const float wsc = a.wsc[i], lb = a.labs[(size_t)g * n + i];
  const bool up = a.uz[i] > 0.0f, term = a.term[i] != 0;
  // down-direct, down-diffuse, up
  const int chan = up ? 2 : (a.direct[i] != 0 ? 0 : 1);
  // a surface-reflected flight admits its level-0 crossing
  const bool up0 = up && z <= 0.0f;
  float total = 0.0f;
  for (int l = 0; l < nz; ++l)
    total += a.trav[(size_t)l * n + i] * a.kabs[l * ng + g];
  float a_up = 0.0f;  // absorption below the level
  for (int lev = 0; lev <= nz; ++lev) {
    const float s = (a.z_lev[lev] - z) * inv_uz;
    const bool crossed = (s > 0.0f && s < s_star)
        || (lev == 0 && ((term && !up) || up0))
        || (lev == nz && term && up);
    if (crossed) {
      sink.add_flux((lev * 3 + chan) * ng + g,
                wsc * expf(lb - (up ? a_up : total - a_up)));
    }
    if (lev < nz) {
      const float ee = a.trav[(size_t)lev * n + i] * a.kabs[lev * ng + g];
      const float next = a_up + ee;
      if (ee != 0.0f) {
        // the weight at the layer's entry, times the share it absorbs
        const float hb = up ? a_up : total - next;
        sink.add_absorbed(lev * ng + g, wsc * expf(lb - hb) * -expm1f(-ee));
      }
      a_up = next;
    }
  }
}

}  // namespace tally
}  // namespace er3t

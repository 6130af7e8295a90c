// Phase-function LUT pair lookup (eval + inverse-CDF sample) for Hopper.
//
// Replaces er3t_tpu/rtm/pallas_phase.py:phase_pair (the TPU form: one-hot
// MXU row selection over two-plane bf16 tables plus a 128-lane shuffle).
// Here each lane's two f32 values are read straight from the tables, so the
// result is exact f32 — bit for bit the plain PyTorch version
// er3t_tpu_torch.rtm.phase_pair.phase_pair_ref, which follows the
// reference's f32 XLA path (mc_flight.py:351-360).
//
//   pe[i] = pt_p [row_e[i], clip(int(((mu[i] + 1) * 0.5) * (n_m - 1) + 0.5))]
//   mn[i] = pt_mu[apf[i],   clip(int(u[i] * (n_u - 1) + 0.5))]
//
// Bound: bytes.  Per lane 16 B in (apf, row_e, mu, u) and 8 B out, read and
// written once: 3.15 MB at B = 2^17, 0.94 us at 3.35 TB/s; the tables (48 KB
// at the bench scene, ~490 KB with all 20 Mie rows) count once.  What holds
// it back on the card is not those bytes but latency: a lane's two table
// loads can only start once its lane data has arrived, so every launch is
// a chain of dependent round trips (lane loads, table loads, stores) behind
// the launch itself.
//
// The design is one thread per lane in 256-thread blocks, the lane data and
// the tables read through the read-only path (__ldg), the tables from
// L1/L2, any B (the ragged last block masked).  Two designs for Hopper were
// measured against it at the bench scene's tables and lost (PERF.md): 4
// lanes per thread with 16-byte streaming lane loads and stores (more bytes
// per instruction do not shorten the chain), and a persistent grid that
// stages both tables in shared memory with the bulk copy of smem_stage (one
// more round trip in front of the lookups).
//
// The bin index arithmetic uses __fmul_rn/__fadd_rn: nvcc would otherwise
// contract a*b+c into one FMA, and a lane at a bin edge would then pick the
// neighbouring bin of what PyTorch's separately rounded ops pick.
// Row indices are clamped into each table, as JAX's gathers clamp, so a bad
// row can never read outside the table.
//
// The kernel is a template on the table element type.  The f32 instance
// (er3t_phase_pair) is the main path's.  The bf16 instance
// (er3t_phase_pair_bf16) replaces make_pair of scripts/tpu_gather_probe3.py
// and tpu_gather_probe3b.py, the one-plane prototype of pallas_phase.py that
// looks up cast(pt)[row, bin] through a bf16 one-hot MXU product; it reads
// the 16-bit value and widens it exactly, so it equals
// pt.to(bfloat16)[row, bin].float() bit for bit and moves half the table
// bytes of the f32 instance.

#include "common.cuh"

namespace {

using er3t::clampi;
using er3t::ldf;

template <typename T>
__global__ void phase_pair_kernel(const int* __restrict__ apf,
                                  const int* __restrict__ row_e,
                                  const float* __restrict__ mu,
                                  const float* __restrict__ u,
                                  const T* __restrict__ pt_p,
                                  const T* __restrict__ pt_mu,
                                  float* __restrict__ pe_out,
                                  float* __restrict__ mu_out,
                                  int n, int rows_e, int n_m, int rows_s,
                                  int n_u) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float m = __ldg(mu + i);
  const float uu = __ldg(u + i);
  const int a = clampi(__ldg(apf + i), 0, rows_s - 1);
  const int r = clampi(__ldg(row_e + i), 0, rows_e - 1);

  // ((mu + 1) * 0.5) * (n_m - 1) + 0.5, truncated toward zero, then clipped
  const float tm = __fadd_rn(
      __fmul_rn(__fmul_rn(__fadd_rn(m, 1.0f), 0.5f), (float)(n_m - 1)), 0.5f);
  const int ib = clampi(__float2int_rz(tm), 0, n_m - 1);
  // u * (n_u - 1) + 0.5
  const float tu = __fadd_rn(__fmul_rn(uu, (float)(n_u - 1)), 0.5f);
  const int iu = clampi(__float2int_rz(tu), 0, n_u - 1);

  pe_out[i] = ldf(pt_p + (size_t)r * n_m + ib);
  mu_out[i] = ldf(pt_mu + (size_t)a * n_u + iu);
}

template <typename T>
int launch(const void* apf, const void* row_e, const void* mu, const void* u,
           const void* pt_p, const void* pt_mu, void* pe_out, void* mu_out,
           int n, int rows_e, int n_m, int rows_s, int n_u, void* stream) {
  phase_pair_kernel<T><<<er3t::blocks_for(n), er3t::kThreads, 0,
                         (cudaStream_t)stream>>>(
      (const int*)apf, (const int*)row_e, (const float*)mu, (const float*)u,
      (const T*)pt_p, (const T*)pt_mu, (float*)pe_out, (float*)mu_out, n,
      rows_e, n_m, rows_s, n_u);
  return (int)cudaGetLastError();
}

}  // namespace

// C entries bound with ctypes: each launches on the caller's stream, does
// not synchronise, and returns cudaGetLastError() (0 = launched).
extern "C" int er3t_phase_pair(const void* apf, const void* row_e,
                               const void* mu, const void* u,
                               const void* pt_p, const void* pt_mu,
                               void* pe_out, void* mu_out, int n, int rows_e,
                               int n_m, int rows_s, int n_u, void* stream) {
  return launch<float>(apf, row_e, mu, u, pt_p, pt_mu, pe_out, mu_out, n,
                       rows_e, n_m, rows_s, n_u, stream);
}

extern "C" int er3t_phase_pair_bf16(const void* apf, const void* row_e,
                                    const void* mu, const void* u,
                                    const void* pt_p, const void* pt_mu,
                                    void* pe_out, void* mu_out, int n,
                                    int rows_e, int n_m, int rows_s, int n_u,
                                    void* stream) {
  return launch<__nv_bfloat16>(apf, row_e, mu, u, pt_p, pt_mu, pe_out,
                               mu_out, n, rows_e, n_m, rows_s, n_u, stream);
}

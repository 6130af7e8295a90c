// The domain-average flux and absorbed-energy tallies of the flight step
// (heating rate) as one kernel, for Hopper.
//
// Replaces no TPU kernel: the JAX reference leaves this tally to XLA.  The
// port's plain version (FlightKernel._step_pre, the domain-average branch
// in er3t_tpu_torch/rtm/mc_flight.py) builds dense (B, Nz+1, Ng) arrays of
// every lane's attenuated weight at every level and absorbed energy in
// every layer, then sums them over the lanes: at B = 2^17 and 23 layers,
// 16 g-points each array is 200 MB, and the ~20 passes over them took
// ~4.5 ms of a 5.8 ms full-batch heating-rate step on the H100.  The
// tallies themselves are (Nz+1) x 3 x Ng + Nz x Ng numbers.
//
// Bound: bytes.  A lane reads its flight (z, uz, 1/uz, length, weight,
// three flags), its Ng + 1 log-transmissions and its Nz layer paths: ~200 B
// at 23 layers and 16 g, 26 MB and ~8 us at 2^17 lanes at 3.35 TB/s; the
// operations (an exp per crossed level and traversed layer and g) are few.
//
// Design: one thread per (lane, g), g fastest, so the 16 threads of a lane
// read its fields once (a broadcast) and neighbouring lanes' fields lie
// side by side; a thread walks the levels in order with the running
// absorption in a register.  No dense array: each block sums its lanes'
// tallies in shared memory (6 KB at the heating-rate scene; the threads of
// a warp hit one entry only when their lanes share the g-point, level and
// channel) and adds them to the device once.  A grid-stride loop over at
// most four blocks an SM keeps those device atomics to a few hundred
// thousand a step.

#include <cuda_runtime.h>

#include "common.cuh"
#include "domain_tally.cuh"

namespace {

using er3t::tally::TallyArgs;

constexpr int kMaxShared = 12288;  // floats of per-block partial sums, 48 KB

// Adds to the block's partial sums in shared memory, or straight to the
// device's tallies where they do not fit.  Host-device so that the host
// pass of tally_lane_g<BlockSink> compiles; it runs on the device.
struct BlockSink {
  float* flux;
  float* absorbed;
  __host__ __device__ void add_flux(int k, float v) {
#ifdef __CUDA_ARCH__
    atomicAdd(flux + k, v);
#endif
  }
  __host__ __device__ void add_absorbed(int k, float v) {
#ifdef __CUDA_ARCH__
    atomicAdd(absorbed + k, v);
#endif
  }
};

__global__ void __launch_bounds__(er3t::kThreads)
    domain_tally_kernel(const __grid_constant__ TallyArgs a, int shared) {
  extern __shared__ float part[];
  const int n_flux = (a.nz + 1) * 3 * a.ng, n_abs = a.nz * a.ng;
  BlockSink sink{a.flux, a.absorbed};
  if (shared) {
    for (int k = threadIdx.x; k < n_flux + n_abs; k += blockDim.x)
      part[k] = 0.0f;
    sink = BlockSink{part, part + n_flux};
    __syncthreads();
  }
  const long long total = (long long)a.n * a.ng;
  for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       t < total; t += (long long)gridDim.x * blockDim.x) {
    er3t::tally::tally_lane_g(a, (int)(t / a.ng), (int)(t % a.ng), sink);
  }
  if (shared) {
    __syncthreads();
    for (int k = threadIdx.x; k < n_flux + n_abs; k += blockDim.x) {
      const float v = part[k];
      if (v != 0.0f) {
        atomicAdd(k < n_flux ? a.flux + k : a.absorbed + (k - n_flux), v);
      }
    }
  }
}

}  // namespace

// C entries bound with ctypes.  er3t_domain_tally launches on the caller's
// stream (a CUDA graph being captured there records it), does not
// synchronise, allocates nothing, and returns cudaGetLastError() (0 =
// launched).
extern "C" int er3t_domain_tally(const TallyArgs* args, void* stream) {
  const TallyArgs a = *args;
  if (a.n <= 0) return 0;
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long need = ((long long)a.n * a.ng + er3t::kThreads - 1)
      / er3t::kThreads;
  const int blocks = (int)(need < 4LL * sms ? need : 4LL * sms);
  const int floats = ((a.nz + 1) * 3 + a.nz) * a.ng;
  const int shared = floats <= kMaxShared;
  domain_tally_kernel<<<blocks, er3t::kThreads,
                        shared ? floats * sizeof(float) : 0,
                        (cudaStream_t)stream>>>(a, shared);
  return (int)cudaGetLastError();
}

extern "C" int er3t_domain_tally_args_size(void* stream) {
  (void)stream;
  return (int)sizeof(TallyArgs);
}

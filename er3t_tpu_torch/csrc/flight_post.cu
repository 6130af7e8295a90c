// The second half of the flight step (estimate, turn, roulette) as one
// kernel, one thread per photon lane, for Hopper.
//
// Replaces no TPU kernel: the JAX reference leaves this part of the step to
// XLA, which fuses it.  The port issued it as the PyTorch ops of
// FlightKernel._step_post (er3t_tpu_torch/rtm/mc_flight.py), ~290-500
// elementwise kernels a step, each a few microseconds of launch and a pass
// over the lanes; replayed from a CUDA graph they still cost ~2 us apiece,
// at every batch width.  This kernel does the same work in one pass, and
// _step_post stays as its plain version (the CPU path, and the path of
// every mode this kernel does not take; flight_post.applies says which).
// The per-lane body is flight_post.cuh, shared with a host build that the
// CPU tests hold against _step_post.
//
// Bound: bytes.  A lane reads ~35 lane and step fields, the labs and
// tau_sens_abs rows and 6 deviate rows, and writes ~17 lane rows: about
// 350 B a lane at 16 g-points, 46 MB and ~14 us at 2^17 lanes at
// 3.35 TB/s.  The operations (a few transcendentals a g-point) are far
// below the card's rate.
//
// Design: structure-of-arrays loads, one lane per thread, so every load
// and store of a warp is one coalesced transaction; the lane's state stays
// in registers; the surface table and the spectral factors are small and
// read through the read-only cache.  A lane computes only its own surface
// branch (the plain version computes all three and selects).  Tallies:
// the image deposit is one float atomicAdd per depositing lane (the pixels
// of a warp are spread over the image, so atomics rarely collide); the
// absorbed-energy tally, (nz, ng) entries that every lane of a block may
// hit, is summed per block in shared memory and added to the device once
// per entry and block; each counter is summed per warp by ballot, per
// block in shared memory, and added once per block to its int64.
//
// In place: post_lane reads every input of its lane before it writes any
// output of that lane, and a thread touches no other lane, so the output
// lanes may be the very arrays of the inputs.

#include "common.cuh"
#include "flight_post.cuh"

namespace {

using er3t::post::PostArgs;

// absorbed-energy entries summed in shared memory per block, at most
constexpr int kMaxSharedAbsorbed = 8192;  // 32 KB

// The kernel's tallies.  Its methods are host-device only so that the
// host pass of post_lane<DeviceSink> compiles; they run on the device.
struct DeviceSink {
  float* rad;
  float* absorbed;
  float* sab;  // the block's absorbed partial sums, or null: to the device
  __host__ __device__ void deposit(int pix, float v) {
#ifdef __CUDA_ARCH__
    if (v != 0.0f) atomicAdd(rad + pix, v);
#endif
  }
  __host__ __device__ void absorb(int k, float v) {
#ifdef __CUDA_ARCH__
    if (v == 0.0f) return;
    atomicAdd((sab != nullptr ? sab : absorbed) + k, v);
#endif
  }
};

__global__ void __launch_bounds__(er3t::kThreads)
    flight_post_kernel(const __grid_constant__ PostArgs a) {
  extern __shared__ float sab[];
  __shared__ unsigned long long counts[er3t::post::kCounterBits];
  const int tid = threadIdx.x;
  const int n_ab = a.tally_absorbed ? a.nz * a.ng : 0;
  const bool shared_ab = n_ab > 0 && n_ab <= kMaxSharedAbsorbed;
  if (shared_ab) {
    for (int k = tid; k < n_ab; k += blockDim.x) sab[k] = 0.0f;
  }
  if (tid < er3t::post::kCounterBits) counts[tid] = 0ull;
  if (blockIdx.x == 0 && tid == 0 && a.o_launched != nullptr) {
    *a.o_launched = *a.launched;
  }
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + tid;
  unsigned bits = 0u;
  if (i < a.n) {
    DeviceSink sink{a.rad, a.absorbed, shared_ab ? sab : nullptr};
    bits = er3t::post::post_lane(a, i, sink);
  }

  // counters: per warp by ballot, per block in shared memory
  const unsigned mask = er3t::post::counted_bits(a);
  if (mask != 0u) {
    const int lane = tid & 31;
    for (int k = 0; k < er3t::post::kCounterBits; ++k) {
      if (!(mask & (1u << k))) continue;
      const unsigned ballot = __ballot_sync(0xffffffffu, (bits >> k) & 1u);
      if (lane == 0 && ballot != 0u) {
        atomicAdd(counts + k, (unsigned long long)__popc(ballot));
      }
    }
  }
  __syncthreads();
  if (tid < er3t::post::kCounterBits && counts[tid] != 0ull) {
    int64_t* c = er3t::post::counter_of(a, tid);
    atomicAdd(reinterpret_cast<unsigned long long*>(c), counts[tid]);
  }
  if (shared_ab) {
    for (int k = tid; k < n_ab; k += blockDim.x) {
      const float v = sab[k];
      if (v != 0.0f) atomicAdd(a.absorbed + k, v);
    }
  }
}

}  // namespace

// C entries bound with ctypes.  er3t_flight_post launches on the caller's
// stream (so a CUDA graph being captured there records it), does not
// synchronise, allocates nothing, and returns cudaGetLastError() (0 =
// launched).
extern "C" int er3t_flight_post(const PostArgs* args, void* stream) {
  const PostArgs a = *args;
  if (a.n <= 0) return 0;
  const int n_ab = a.tally_absorbed ? a.nz * a.ng : 0;
  const size_t smem = n_ab > 0 && n_ab <= kMaxSharedAbsorbed
      ? (size_t)n_ab * sizeof(float) : 0;
  flight_post_kernel<<<er3t::blocks_for(a.n), er3t::kThreads, smem,
                       (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int er3t_flight_post_args_size(void* stream) {
  (void)stream;
  return (int)sizeof(PostArgs);
}

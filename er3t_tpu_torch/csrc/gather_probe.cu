// Gather probes for Hopper: the hand-written counterparts of the Pallas
// kernels of the TPU gather probes (K2-K8 in PERF.md).
//
//   take_reps       scripts/tpu_gather_probe.py:115   (pallas_gather, K2)
//   gather_row_sum  scripts/tpu_gather_probe.py:152   (pallas_gather_2d, K3)
//                   scripts/tpu_gather_probe.py:185   (pallas_onehot, K4)
//   take2d          scripts/tpu_gather_probe2.py:63   (run_kernel, K6)
//                   scripts/tpu_gather_probe3.py:58,
//                   scripts/tpu_gather_probe3b.py:58  (mosaic_form, K7/K8)
//   smem_stage      scripts/tpu_gather_probe.py:215   (the VMEM ceiling, K5)
//   noop            none: the launch floor
//
// The phase-pair prototypes of K7/K8 (make_pair) are the bf16 and f32
// instances of phase_pair.cu.
//
// What the TPU kernels did to reach a gather (a whole table resident in
// VMEM, one-hot MXU products, 128-lane shuffles, lane blocks that divide B)
// has no role here.  Each gather is one thread per output element in
// 256-thread blocks with a masked ragged last block, so any size works; the
// tables are read through the read-only path (__ldg) and live in L1/L2.
// Bound: the latency of one dependent load per element (the index, then the
// table word it names); many resident warps hide it.  Every index is
// clamped (or, for take_reps, wrapped as the TPU kernel wraps it) into its
// table, so no input can read outside a table.  Sums run in a fixed order
// with no FMA, so each kernel equals its plain PyTorch version
// (er3t_tpu_torch/probes/gather.py) bit for bit.

#include "common.cuh"

namespace {

using er3t::clampi;

// out[b] = sum_{r<reps} tab[(idx[b] + r) mod rows, min(r, width - 1)],
// summed in r order; mod is the floor modulo of jnp's %.
__global__ void take_reps_kernel(const int* __restrict__ idx,
                                 const float* __restrict__ tab,
                                 float* __restrict__ out, int n, int rows,
                                 int width, int reps) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= n) return;
  int base = __ldg(idx + b) % rows;
  if (base < 0) base += rows;
  float acc = 0.0f;
  for (int r = 0; r < reps; ++r) {
    // base + (r mod rows) < 2 rows < 2^32: one subtraction wraps it
    unsigned row = (unsigned)base + (unsigned)(r % rows);
    if (row >= (unsigned)rows) row -= (unsigned)rows;
    acc += __ldg(tab + (size_t)row * width + min(r, width - 1));
  }
  out[b] = acc;
}

// out[b] = sum_{c<width} tab[idx[b] * width + c], summed in c order.
__global__ void gather_row_sum_kernel(const int* __restrict__ idx,
                                      const float* __restrict__ tab,
                                      float* __restrict__ out, int n,
                                      int rows, int width) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= n) return;
  const float* row = tab + (size_t)clampi(__ldg(idx + b), 0, rows - 1) * width;
  float acc = 0.0f;
  for (int c = 0; c < width; ++c) acc += __ldg(row + c);
  out[b] = acc;
}

// out[i, j] = tab[r, c] for an (n_i, n_j) output:
//   mode 0 (rows):  r = idx[i],    c = j       (idx (n_i,), n_j = tab_cols)
//   mode 1 (axis0): r = idx[i, j], c = j       (idx (n_i, n_j))
//   mode 2 (axis1): r = i,         c = idx[i, j]
__global__ void take2d_kernel(const int* __restrict__ idx,
                              const float* __restrict__ tab,
                              float* __restrict__ out, int mode, int n_i,
                              int n_j, int tab_rows, int tab_cols) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_i * n_j) return;
  const int i = t / n_j;
  const int j = t - i * n_j;
  int r = i, c = j;
  if (mode == 0) {
    r = __ldg(idx + i);
  } else if (mode == 1) {
    r = __ldg(idx + t);
  } else {
    c = __ldg(idx + t);
  }
  r = clampi(r, 0, tab_rows - 1);
  c = clampi(c, 0, tab_cols - 1);
  out[t] = __ldg(tab + (size_t)r * tab_cols + c);
}

// One block stages the whole n-float table in dynamic shared memory, then
// writes tab[0] + tab[n - 1] from it: the largest n that launches is the
// largest table a block can hold on chip (the counterpart of the TPU
// probe's VMEM ceiling).
//
// Bound: on the card, 232448 B over 3.35 TB/s is 0.07 us; what one block
// can draw is the rate of a single SM, which this probe measures.  A
// plain loop (each of 1024 threads: a 4-byte __ldg, then a shared store,
// ~57 dependent round trips each for 227 KB) reaches ~26 GB/s.  Here
// the bulk-copy engine (TMA) moves the table: one thread issues
// cp.async.bulk copies of at most 32 KB, all in flight at once, against one
// mbarrier.  The barrier must not cost shared memory beyond the table, or
// the ceiling would move below the opt-in limit, so it lives in the last 16
// bytes of the (16-byte rounded-down) table buffer: the bulk copy fills the
// bytes before it, and once the barrier is invalidated the threads load the
// 16 bytes it held and the ragged tail (n * 4 not a multiple of 16) with
// plain loads.  Tables under 32 B take plain loads only.  The wrapper
// refuses a table whose address is not 16-byte aligned.
__global__ void smem_stage_kernel(const float* __restrict__ tab,
                                  float* __restrict__ out, int n) {
  extern __shared__ __align__(16) float staged[];
  const int nbytes = n * static_cast<int>(sizeof(float));
  const int body = nbytes >= 32 ? (nbytes & ~15) - 16 : 0;
  if (body > 0) {
    const er3t::BulkPart parts[1] = {{staged, tab, body}};
    er3t::bulk_load(parts, reinterpret_cast<uint64_t*>(
                               reinterpret_cast<char*>(staged) + body));
  }
  for (int k = body / 4 + threadIdx.x; k < n; k += blockDim.x) {
    staged[k] = __ldg(tab + k);
  }
  __syncthreads();
  if (threadIdx.x == 0) out[0] = staged[0] + staged[n - 1];
}

// Does nothing: its launch, one 256-thread block, is the launch floor that
// every kernel's time is read against.
__global__ void noop_kernel() {}

}  // namespace

// C entries bound with ctypes: each launches on the caller's stream, does
// not synchronise, and returns cudaGetLastError() (0 = launched).
extern "C" int er3t_take_reps(const void* idx, const void* tab, void* out,
                              int n, int rows, int width, int reps,
                              void* stream) {
  take_reps_kernel<<<er3t::blocks_for(n), er3t::kThreads, 0,
                     (cudaStream_t)stream>>>(
      (const int*)idx, (const float*)tab, (float*)out, n, rows, width, reps);
  return (int)cudaGetLastError();
}

extern "C" int er3t_gather_row_sum(const void* idx, const void* tab,
                                   void* out, int n, int rows, int width,
                                   void* stream) {
  gather_row_sum_kernel<<<er3t::blocks_for(n), er3t::kThreads, 0,
                          (cudaStream_t)stream>>>(
      (const int*)idx, (const float*)tab, (float*)out, n, rows, width);
  return (int)cudaGetLastError();
}

extern "C" int er3t_take2d(const void* idx, const void* tab, void* out,
                           int mode, int n_i, int n_j, int tab_rows,
                           int tab_cols, void* stream) {
  take2d_kernel<<<er3t::blocks_for((long long)n_i * n_j), er3t::kThreads, 0,
                  (cudaStream_t)stream>>>((const int*)idx, (const float*)tab,
                                          (float*)out, mode, n_i, n_j,
                                          tab_rows, tab_cols);
  return (int)cudaGetLastError();
}

// Refuses a table that is not 16-byte aligned (the bulk copy needs it).
// Raises the kernel's dynamic shared memory limit to n * 4 bytes first;
// above the card's opt-in limit (227 KB on an H100) that call is refused and
// its error is returned, cleared from the runtime so later launches of the
// process do not see it.
extern "C" int er3t_smem_stage(const void* tab, void* out, int n,
                               void* stream) {
  if (!er3t::aligned16(tab)) return (int)cudaErrorInvalidValue;
  const int bytes = n * (int)sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(
      smem_stage_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  smem_stage_kernel<<<1, 1024, bytes, (cudaStream_t)stream>>>(
      (const float*)tab, (float*)out, n);
  return (int)cudaGetLastError();
}

extern "C" int er3t_noop(void* stream) {
  noop_kernel<<<1, er3t::kThreads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

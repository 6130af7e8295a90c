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
// has no role here.  The tables are read in place through the read-only
// path (__ldg) and live in L1/L2; blocks of 256 threads with a masked
// ragged end take any size.  take_reps is one thread per output element;
// gather_row_sum reads a row with one thread or with a group of lanes;
// take2d gives each output row a group of lanes, one kernel per mode.  Each
// kernel's note says what bounds it and what its design does about it.
// Every index is clamped (or, for take_reps, wrapped as the TPU kernel wraps
// it) into its table, so no input can read outside a table.  Sums run in a
// fixed, documented order with no FMA, so each kernel equals its plain
// PyTorch version (er3t_tpu_torch/probes/gather.py) bit for bit, whatever
// path it takes.

#include "common.cuh"

namespace {

using er3t::clampi;

constexpr unsigned kFull = 0xffffffffu;  // every lane of a warp

// ---- take_reps: K2, scripts/tpu_gather_probe.py:115 (pallas_gather) ----
//
// out[b] = sum_{r<reps} tab[(idx[b] + r) mod rows, min(r, width - 1)],
// summed in r order; mod is the floor modulo of jnp's %.
//
// Bound on this card: not bytes (2^17 lanes move 1 MB of indices and
// outputs; the window words come from a table that L1/L2 hold) but the
// latency of two dependent loads, the index and then its window, behind the
// launch.  The first design spent a runtime-divisor % on the index and on
// every r.  Here a lane does at most one % (none for an index inside the
// table) and advances its row by one compare and reset a step.  Measured
// (PERF.md): 16-byte window loads at width 1 and four outputs a thread
// (one int4 index load) gained nothing over this scalar loop and were
// removed, so the chain of two dependent loads is what is left.
__global__ void take_reps_kernel(const int* __restrict__ idx,
                                 const float* __restrict__ tab,
                                 float* __restrict__ out, int n, int rows,
                                 int width, int reps) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= n) return;
  int row = __ldg(idx + b);  // floor modulo; no division inside the table
  if ((unsigned)row >= (unsigned)rows) {
    row %= rows;
    if (row < 0) row += rows;
  }
  float acc = 0.0f;
  for (int r = 0; r < reps; ++r) {
    acc += __ldg(tab + (size_t)row * width + min(r, width - 1));
    if (++row == rows) row = 0;
  }
  out[b] = acc;
}

// ---- gather_row_sum: K3 scripts/tpu_gather_probe.py:152 (pallas_gather_2d),
// K4 scripts/tpu_gather_probe.py:185 (pallas_onehot) ----
//
// out[b] = sum_c tab[clamp(idx[b]), c] in the order that the docstring of
// gather_row_sum_ref (er3t_tpu_torch/probes/gather.py) writes down: the row
// is cut into chunks of 4 floats, chunk k goes to lane k mod L of the
// output's group of L lanes, each lane adds its elements in index order from
// 0, and lane 0 ends the __shfl_xor_sync butterfly L/2, ..., 2, 1 over the
// lane partials.  L = 1 is the plain column-order sum.
//
// Bound on this card: the bytes of the rows read, from L1/L2 (K4: 2^17 rows
// of 512 B, 64 MB, from a 256 KB table; K3: 8 B a row from a 7.4 MB table),
// and for small rows the latency of the dependent index -> row chain.  The
// first design was one thread per output with scalar loads: at width 128 a
// warp-wide load touched 32 rows, 32 sectors for 128 useful bytes, and each
// thread issued 128 loads behind one ordered add chain.  Here a warp owns 32
// consecutive outputs and loads their indices in one coalesced load; its
// lanes form aligned groups of L (1, 2, 4 or 8), each group reading the L
// rows of its L outputs together, each row index fetched from its owner
// lane by __shfl_sync.  At K4's width 128 and L = 8 a warp instruction
// reads 128 contiguous bytes of each of four rows with 16-byte loads (whole
// sectors), and a lane has 32 loads in flight (8 rows x 4 chunks).  After
// the butterfly every lane of a group holds the same sums; each lane keeps
// its own output's, and the warp writes its 32 outputs coalesced.  Loads
// are float4 where width % 4 == 0 and the table is 16-byte aligned, float2
// where width is even and the table 8-byte aligned, else scalar (a ragged
// width, a misaligned view); the order is the same for all three.  The
// wrapper picks L (gather.row_sum_lanes): as many lanes as the row has
// chunks, rounded up to a power of two, at most 8, the fastest of the lane
// counts measured at widths 1-1024 (PERF.md; 16 and 32 lanes a row were
// slower at every width and were removed).  So K3's width 2 is one thread
// a row, the voxel table's 5 two lanes, K4's 128 eight.

// Adds chunk c of `row` (floats 4c .. 4c + 3, those below width) to acc in
// index order, with loads of V floats.
template <int V>
__device__ __forceinline__ float add_chunk(float acc,
                                           const float* __restrict__ row,
                                           int c, int width) {
  if (V == 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(row) + c);
    return (((acc + v.x) + v.y) + v.z) + v.w;
  }
  if (V == 2) {
    const float2* p = reinterpret_cast<const float2*>(row) + 2 * c;
    const float2 v = __ldg(p);
    acc = (acc + v.x) + v.y;
    if (4 * c + 2 < width) {
      const float2 u = __ldg(p + 1);
      acc = (acc + u.x) + u.y;
    }
    return acc;
  }
  const float* p = row + 4 * c;
  const int m = min(4, width - 4 * c);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (k < m) acc += __ldg(p + k);
  }
  return acc;
}

template <int L, int V>
__global__ void gather_row_sum_kernel(const int* __restrict__ idx,
                                      const float* __restrict__ tab,
                                      float* __restrict__ out, int n,
                                      int rows, int width) {
  const int lane = threadIdx.x & 31;
  const int first = blockIdx.x * blockDim.x + threadIdx.x - lane;
  if (first >= n) return;  // whole warps: the shuffles need every lane
  const int own = first + lane;
  const int my_row = own < n ? clampi(__ldg(idx + own), 0, rows - 1) : 0;
  const int g0 = lane & ~(L - 1), rank = lane & (L - 1);
  const int chunks = (width + 3) >> 2;
  const float* row[L];
  float acc[L];
#pragma unroll
  for (int k = 0; k < L; ++k) {
    const int r = L == 1 ? my_row : __shfl_sync(kFull, my_row, g0 + k);
    row[k] = tab + (size_t)r * width;
    acc[k] = 0.0f;
  }
  for (int c = rank; c < chunks; c += L) {
#pragma unroll
    for (int k = 0; k < L; ++k) acc[k] = add_chunk<V>(acc[k], row[k], c, width);
  }
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1) {
#pragma unroll
    for (int k = 0; k < L; ++k) acc[k] += __shfl_xor_sync(kFull, acc[k], o);
  }
  float res = 0.0f;
#pragma unroll
  for (int k = 0; k < L; ++k) {
    if (rank == k) res = acc[k];  // constant indices: no local memory
  }
  if (own < n) out[own] = res;
}

// ---- take2d: K6 scripts/tpu_gather_probe2.py:63 (run_kernel), K7/K8
// scripts/tpu_gather_probe3.py:58, scripts/tpu_gather_probe3b.py:58
// (mosaic_form) ----
//
// out[i, j] = tab[r, c] for an (n_i, n_j) output, r and c clamped into the
// (rows, cols) table:
//   rows:  r = idx[i],    c = j          (idx (n_i,), n_j = cols)
//   axis0: r = idx[i, j], c = j          (idx (n_i, n_j), n_j = cols)
//   axis1: r = i,         c = idx[i, j]  (idx (n_i, n_j), n_i = rows)
//
// Bound on this card: not bytes (K6 moves 2 MB of indices and outputs and
// touches 1 MB of its 8 MB table, all of it in L2 when launched back to
// back) but the chain index load -> table load -> store behind the launch.
// The first design ran one thread per output with a runtime mode switch and
// a division t / n_j ahead of the first load.  Here each mode is its own
// kernel, and a block of 256 threads is lanes x (256 / lanes): threadIdx.y
// picks the output row i, threadIdx.x walks the row in chunks of V
// consecutive outputs, one chunk a lane where the row has at most 256 (no
// division anywhere).  V = 4 (an int4 index load, four gathers in flight, a
// float4 store; rows: float4 copies) where the wrapper says so
// (gather.take2d_vec: rows and axis1 with a row width that is a multiple
// of 4 and 16-byte aligned indices, or table for rows), else V = 1.
// Measured (PERF.md): the kernel per mode is what gains at K6; V = 4 ties
// there and wins at probe 2's rows and axis1 (2048, 128) forms.  Measured
// and removed: staging axis1's table rows in shared memory by cp.async
// while the indices load (slower at every shape tried with V = 4), blocks
// of 64 and 128 threads, and V = 4 for axis0 (slower at K7 than one output
// a lane).  Every path is a copy, so each equals the plain version bit for
// bit.

template <int V>
__device__ __forceinline__ void load_idx(const int* p, int (&v)[V]) {
  if constexpr (V == 4) {
    const int4 t = __ldg(reinterpret_cast<const int4*>(p));
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else {
    v[0] = __ldg(p);
  }
}

// rows: every lane of a row reads the same index, then the row is copied
// in chunks of V floats.
template <int V>
__global__ void __launch_bounds__(er3t::kThreads)
    take2d_rows_kernel(const int* __restrict__ idx,
                       const float* __restrict__ tab, float* __restrict__ out,
                       int n_i, int rows, int cols) {
  const int i = blockIdx.x * blockDim.y + threadIdx.y;
  if (i >= n_i) return;
  const int r = clampi(__ldg(idx + i), 0, rows - 1);
  const float* src = tab + (size_t)r * cols;
  float* dst = out + (size_t)i * cols;
  const int chunks = cols / V;
#pragma unroll 4
  for (int c = threadIdx.x; c < chunks; c += blockDim.x) {
    if constexpr (V == 4) {
      reinterpret_cast<float4*>(dst)[c] =
          __ldg(reinterpret_cast<const float4*>(src) + c);
    } else {
      dst[c] = __ldg(src + c);
    }
  }
}

// axis0 (AXIS 0) and axis1 (AXIS 1).
template <int AXIS, int V>
__global__ void __launch_bounds__(er3t::kThreads)
    take2d_along_kernel(const int* __restrict__ idx,
                        const float* __restrict__ tab,
                        float* __restrict__ out, int n_i, int n_j, int rows,
                        int cols) {
  const int i = blockIdx.x * blockDim.y + threadIdx.y;
  if (i >= n_i) return;
  const size_t base = (size_t)i * n_j;
  const int chunks = n_j / V;
#pragma unroll 4
  for (int c = threadIdx.x; c < chunks; c += blockDim.x) {
    int id[V];
    load_idx<V>(idx + base + c * V, id);
    float v[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      v[k] = AXIS == 0
                 ? __ldg(tab + (size_t)clampi(id[k], 0, rows - 1) * cols +
                         c * V + k)
                 : __ldg(tab + (size_t)i * cols + clampi(id[k], 0, cols - 1));
    }
    if constexpr (V == 4) {
      reinterpret_cast<float4*>(out + base)[c] =
          make_float4(v[0], v[1], v[2], v[3]);
    } else {
      out[base + c] = v[0];
    }
  }
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

template <int L>
void launch_row_sum(int v, const void* idx, const void* tab, void* out, int n,
                    int rows, int width, cudaStream_t stream) {
  const int g = er3t::blocks_for(n);
  const int* i = (const int*)idx;
  const float* t = (const float*)tab;
  float* o = (float*)out;
  if (v == 4) {
    gather_row_sum_kernel<L, 4><<<g, er3t::kThreads, 0, stream>>>(i, t, o, n,
                                                                  rows, width);
  } else if (v == 2) {
    gather_row_sum_kernel<L, 2><<<g, er3t::kThreads, 0, stream>>>(i, t, o, n,
                                                                  rows, width);
  } else {
    gather_row_sum_kernel<L, 1><<<g, er3t::kThreads, 0, stream>>>(i, t, o, n,
                                                                  rows, width);
  }
}

}  // namespace

// C entries bound with ctypes: each launches on the caller's stream, does
// not synchronise, and returns cudaGetLastError() (0 = launched).

extern "C" int er3t_take_reps(const void* idx, const void* tab, void* out,
                              int n, int rows, int width, int reps,
                              void* stream) {
  take_reps_kernel<<<er3t::blocks_for(n), er3t::kThreads, 0,
                     (cudaStream_t)stream>>>((const int*)idx, (const float*)tab,
                                             (float*)out, n, rows, width, reps);
  return (int)cudaGetLastError();
}

// lanes: the group size L, 1, 2, 4 or 8; the load width follows
// from the row width and the table's alignment.
extern "C" int er3t_gather_row_sum(const void* idx, const void* tab,
                                   void* out, int n, int rows, int width,
                                   int lanes, void* stream) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(tab);
  const int v = width % 4 == 0 && a % 16 == 0  ? 4
                : width % 2 == 0 && a % 8 == 0 ? 2
                                               : 1;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (lanes) {
    case 1: launch_row_sum<1>(v, idx, tab, out, n, rows, width, s); break;
    case 2: launch_row_sum<2>(v, idx, tab, out, n, rows, width, s); break;
    case 4: launch_row_sum<4>(v, idx, tab, out, n, rows, width, s); break;
    case 8: launch_row_sum<8>(v, idx, tab, out, n, rows, width, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// mode 0 rows, 1 axis0, 2 axis1; vec 1 or 4 outputs a chunk (4: rows and
// axis1 only, gather.take2d_vec).  A row gets a lane a chunk, rounded up
// to a power of two, at most 256; a block holds 256 / lanes rows.
// Refuses a vec whose mode, width or alignment does not allow it.
extern "C" int er3t_take2d(const void* idx, const void* tab, void* out,
                           int mode, int n_i, int n_j, int rows, int cols,
                           int vec, void* stream) {
  const int width = mode == 0 ? cols : n_j;
  const bool ok =
      mode >= 0 && mode <= 2 &&
      (vec == 1 || (vec == 4 && mode != 1 && width % 4 == 0 &&
                    er3t::aligned16(mode == 0 ? tab : idx) &&
                    er3t::aligned16(out)));
  if (!ok) return (int)cudaErrorInvalidValue;
  int lanes = 1;
  while (lanes < width / vec && lanes < er3t::kThreads) lanes <<= 1;
  const int rpb = er3t::kThreads / lanes;
  const dim3 block(lanes, rpb);
  const int grid = (n_i + rpb - 1) / rpb;
  const cudaStream_t s = (cudaStream_t)stream;
  const int* i = (const int*)idx;
  const float* t = (const float*)tab;
  float* o = (float*)out;
  if (mode == 0 && vec == 4) {
    take2d_rows_kernel<4><<<grid, block, 0, s>>>(i, t, o, n_i, rows, cols);
  } else if (mode == 0) {
    take2d_rows_kernel<1><<<grid, block, 0, s>>>(i, t, o, n_i, rows, cols);
  } else if (mode == 1) {
    take2d_along_kernel<0, 1><<<grid, block, 0, s>>>(i, t, o, n_i, n_j, rows,
                                                     cols);
  } else if (vec == 4) {
    take2d_along_kernel<1, 4><<<grid, block, 0, s>>>(i, t, o, n_i, n_j, rows,
                                                     cols);
  } else {
    take2d_along_kernel<1, 1><<<grid, block, 0, s>>>(i, t, o, n_i, n_j, rows,
                                                     cols);
  }
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

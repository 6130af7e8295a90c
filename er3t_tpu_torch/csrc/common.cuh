// Helpers shared by the kernels of csrc/.  _build.py hashes every *.cuh of
// this directory into each library's name, so an edit here rebuilds them.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace er3t {

constexpr int kThreads = 256;  // threads per block of the one-thread-per-element kernels

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// Read-only-path loads widened to f32.  A bf16 value is the upper half of
// the f32 with the same bits, so the widening is exact (the same value as
// torch's bf16 -> f32 conversion).
__device__ __forceinline__ float ldf(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldf(const __nv_bfloat16* p) {
  const unsigned short bits = __ldg(reinterpret_cast<const unsigned short*>(p));
  return __uint_as_float(static_cast<unsigned>(bits) << 16);
}

inline int blocks_for(long long n) {
  return static_cast<int>((n + kThreads - 1) / kThreads);
}

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// ---- bulk copies into shared memory (the Tensor Memory Accelerator) ----

// One contiguous piece of a bulk load: `bytes` from global `src` to shared
// `dst`; both addresses and `bytes` multiples of 16.
struct BulkPart {
  void* dst;
  const void* src;
  int bytes;
};

constexpr int kBulkChunk = 32 << 10;  // bytes per cp.async.bulk instruction

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Loads every part into shared memory with cp.async.bulk, all in flight at
// once, completing on the 8-byte mbarrier `bar` (shared memory, 8-byte
// aligned): thread 0 initialises it, declares the total byte count and
// issues the copies in chunks of at most 32 KB; every thread then waits for
// the barrier's phase 0.  On return the bytes are visible to the whole
// block, and the barrier is invalidated, so its 8 bytes may be reused as
// data.  Called by every thread of the block; the total must stay below the
// barrier's 2^20 - 1 transaction bytes.
template <int N>
__device__ __forceinline__ void bulk_load(const BulkPart (&parts)[N],
                                          uint64_t* bar) {
  const unsigned b = smem_u32(bar);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(b), "r"(1)
                 : "memory");
    // the initialised barrier, visible to the bulk-copy (async) proxy
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int k = 0; k < N; ++k) total += parts[k].bytes;
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 ::"r"(b), "r"(total) : "memory");
    for (int k = 0; k < N; ++k) {
      const char* src = static_cast<const char*>(parts[k].src);
      const unsigned dst = smem_u32(parts[k].dst);
      for (int off = 0; off < parts[k].bytes; off += kBulkChunk) {
        const int len = min(kBulkChunk, parts[k].bytes - off);
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
            " [%0], [%1], %2, [%3];"
            ::"r"(dst + off), "l"(src + off), "r"(len), "r"(b) : "memory");
      }
    }
  }
  unsigned done = 0;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(b), "r"(0) : "memory");
  } while (!done);
  __syncthreads();  // every thread is past its wait before the invalidation
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.inval.shared::cta.b64 [%0];" ::"r"(b) : "memory");
  }
  __syncthreads();
}

}  // namespace er3t

// Helpers shared by the kernels of csrc/.  _build.py hashes every *.cuh of
// this directory into each library's name, so an edit here rebuilds them.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

}  // namespace er3t

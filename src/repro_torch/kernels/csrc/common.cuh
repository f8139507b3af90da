// Device helpers shared by the join kernels: branchless binary searches
// over ascending int32 columns (search.cuh adds the searches of a sorted
// key column that join_count.cu, fused_join.cu, pair_semijoin.cu and
// semijoin.cu share; dedup.cuh the exact hash dedup of dedup_rows.cu
// and fused_join.cu).  Every entry point is a plain C function that
// launches on the caller's stream and returns cudaGetLastError().
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace rt {

constexpr int kThreads = 256;

inline unsigned grid_for(long long n, int threads = kThreads) {
  return (unsigned)((n + threads - 1) / threads);
}

// First index i in [0, n) with a[i] >= x (searchsorted side="left").
// The trip count depends on n only, so a warp never diverges on it.
__device__ __forceinline__ int lower_bound(const int* __restrict__ a, int n,
                                           int x) {
  int lo = 0, len = n;
  while (len > 0) {
    int half = len >> 1;
    bool go = a[lo + half] < x;
    lo = go ? lo + half + 1 : lo;
    len = go ? len - half - 1 : half;
  }
  return lo;
}

// First index i in [0, n) with a[i] > x (searchsorted side="right").
__device__ __forceinline__ int upper_bound(const int* __restrict__ a, int n,
                                           int x) {
  int lo = 0, len = n;
  while (len > 0) {
    int half = len >> 1;
    bool go = a[lo + half] <= x;
    lo = go ? lo + half + 1 : lo;
    len = go ? len - half - 1 : half;
  }
  return lo;
}

}  // namespace rt

// Device helpers shared by the join kernels: branchless binary searches
// over ascending int32 columns, the row hash, and the exact hash dedup
// (insert + first-occurrence keep) used by dedup_rows.cu and
// fused_join.cu (search.cuh adds the searches of a sorted key column
// that join_count.cu, fused_join.cu and pair_semijoin.cu share).  Every
// entry point is a plain C function that launches on the caller's
// stream and returns cudaGetLastError().
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

// Multiplicative xor-mix over the row's int32 columns, avalanched.
__device__ __forceinline__ uint32_t row_hash(const int* __restrict__ row,
                                             int V) {
  uint32_t h = 0x811C9DC5u;
  for (int v = 0; v < V; ++v) {
    h = (h ^ (uint32_t)row[v]) * 0x9E3779B1u;
    h ^= h >> 15;
  }
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ bool rows_equal(const int* __restrict__ bind,
                                           int V, int a, int b) {
  const int* ra = bind + (size_t)a * V;
  const int* rb = bind + (size_t)b * V;
  for (int v = 0; v < V; ++v)
    if (ra[v] != rb[v]) return false;
  return true;
}

// Open-addressed insert of valid row i into `slots` (H entries, a power
// of two >= 2C, preset to -1).  Rows with equal values walk the same
// probe sequence, so exactly one slot per distinct row is claimed
// (atomicCAS from -1); a row that meets its own value there lowers the
// slot to the smaller row index (atomicMin).  Once every row is in,
// every claimed slot holds the lowest index of its distinct row, and
// slot_of[i] names row i's slot (-1 for invalid rows).
__device__ __forceinline__ void dedup_insert_row(
    const int* __restrict__ bind, const unsigned char* __restrict__ valid,
    int i, int V, int* __restrict__ slots, int H, int* __restrict__ slot_of) {
  if (!valid[i]) {
    slot_of[i] = -1;
    return;
  }
  const uint32_t mask = (uint32_t)H - 1u;
  uint32_t s = row_hash(bind + (size_t)i * V, V) & mask;
  while (true) {
    int cur = atomicCAS(&slots[s], -1, i);
    if (cur == -1) break;
    if (rows_equal(bind, V, cur, i)) {
      atomicMin(&slots[s], i);
      break;
    }
    s = (s + 1u) & mask;
  }
  slot_of[i] = (int)s;
}

__global__ void dedup_insert_kernel(const int* __restrict__ bind,
                                    const unsigned char* __restrict__ valid,
                                    int C, int V, int* __restrict__ slots,
                                    int H, int* __restrict__ slot_of) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < C) dedup_insert_row(bind, valid, i, V, slots, H, slot_of);
}

// Row i survives iff it is valid and the lowest index of its value.
__device__ __forceinline__ bool first_occurrence(
    const int* __restrict__ slots, const int* __restrict__ slot_of, int i) {
  int s = slot_of[i];
  return s >= 0 && slots[s] == i;
}

}  // namespace rt

// The exact hash dedup shared by dedup_rows.cu and fused_join.cu: which
// valid rows of a (C, V) int32 binding table are the first occurrence
// of their value.
//
// The table holds H 64-bit slots (H a power of two >= 2C, preset to all
// ones = empty), each (32-bit row hash << 32 | row index), and one byte
// a row, `alive` (preset to 0xFF).  Every valid row inserts in
// parallel: rows of one value walk the same probe sequence from slot
// hash & (H - 1); the first claims a slot with a 64-bit atomicCAS, a
// later one that meets its own value there either sees a lower index
// (it is a duplicate: alive = 0) or lowers the slot with atomicMin, and
// the index that loses that exchange is the duplicate.  So every row
// but the lowest index of its value is marked exactly once, and after
// the launch row i survives iff valid[i] && alive[i]: no slot has to be
// found again.  A slot whose hash differs from the row's is passed
// without loading its row; equal hashes still compare every column and
// probe on when the rows differ, so the result never rests on the hash.
// Rows are staged in shared memory with 16-byte loads (up to
// kStageMaxV columns), so each row is read from device memory once,
// coalesced.
#pragma once

#include "common.cuh"

namespace rt {

constexpr unsigned long long kEmptySlot = ~0ull;
constexpr int kInsertThreads = 256;
constexpr int kStageMaxV = 16;  // wider rows are read in place

// Multiplicative xor-mix over the row's int32 columns, avalanched
// (kernels/ref.py row_hash_ref is its plain version).
__device__ __forceinline__ uint32_t row_hash(const int* row, int V) {
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

// dst[0, n) = src[0, n) by the block, 16 bytes a thread where both are
// 16-byte aligned; the caller syncs.
__device__ __forceinline__ void copy_ints(int* __restrict__ dst,
                                          const int* __restrict__ src,
                                          int n) {
  int from = 0;
  if (((reinterpret_cast<uintptr_t>(src) |
        reinterpret_cast<uintptr_t>(dst)) & 15) == 0) {
    const int n4 = n >> 2;
    for (int k = threadIdx.x; k < n4; k += blockDim.x)
      reinterpret_cast<int4*>(dst)[k] = reinterpret_cast<const int4*>(src)[k];
    from = n4 << 2;
  }
  for (int k = from + threadIdx.x; k < n; k += blockDim.x) dst[k] = src[k];
}

__device__ __forceinline__ bool same_row(const int* __restrict__ a,
                                         const int* b, int V) {
  for (int v = 0; v < V; ++v)
    if (a[v] != b[v]) return false;
  return true;
}

// Insert valid row i (its values `row`, its hash h).
__device__ __forceinline__ void dedup_insert(
    const int* __restrict__ bind, int V, const int* row, int i, uint32_t h,
    unsigned long long* __restrict__ slots, uint32_t mask,
    unsigned char* __restrict__ alive) {
  const unsigned long long me = ((unsigned long long)h << 32) | (uint32_t)i;
  uint32_t s = h & mask;
  while (true) {
    const unsigned long long cur = atomicCAS(&slots[s], kEmptySlot, me);
    if (cur == kEmptySlot) return;  // claimed: the lowest index so far
    if ((uint32_t)(cur >> 32) == h) {
      const int j = (int)(uint32_t)cur;
      if (same_row(bind + (size_t)j * V, row, V)) {
        // the slot's index only falls, so j < i settles it; else the
        // larger index of the exchange is the duplicate
        int dup = i;
        if (j > i) {
          const int old = (int)(uint32_t)atomicMin(&slots[s], me);
          dup = old > i ? old : i;
        }
        alive[dup] = 0;
        return;
      }
    }
    s = (s + 1u) & mask;
  }
}

// One thread a row; the block's rows staged in dynamic shared memory
// (kInsertThreads * V ints) when V <= kStageMaxV.  A tile with no valid
// row reads nothing more: the match loop's tables are compacted per
// site, valid rows first, so most tiles of a large capacity tier are
// padding.
__global__ void __launch_bounds__(kInsertThreads)
dedup_insert_kernel(const int* __restrict__ bind,
                    const unsigned char* __restrict__ valid, int C, int V,
                    unsigned long long* __restrict__ slots, int H,
                    unsigned char* __restrict__ alive) {
  extern __shared__ __align__(16) int tile[];
  const long long r0 = (long long)blockIdx.x * kInsertThreads;
  const int n = (int)min((long long)kInsertThreads, (long long)C - r0);
  const int t = threadIdx.x;
  const int i = (int)r0 + t;
  const bool mine = t < n && valid[i];
  if (!__syncthreads_or(mine)) return;
  const bool staged = V <= kStageMaxV;
  if (staged) {
    copy_ints(tile, bind + r0 * V, n * V);
    __syncthreads();
  }
  if (!mine) return;
  const int* row = staged ? tile + t * V : bind + (size_t)i * V;
  dedup_insert(bind, V, row, i, row_hash(row, V), slots, (uint32_t)H - 1u,
               alive);
}

// Launch the insert of all C rows on `stream` (slots and alive preset).
inline void launch_dedup_insert(const int* bind, const unsigned char* valid,
                                int C, int V, unsigned long long* slots,
                                int H, unsigned char* alive,
                                cudaStream_t stream) {
  const size_t smem =
      V <= kStageMaxV ? (size_t)kInsertThreads * V * sizeof(int) : 0;
  dedup_insert_kernel<<<grid_for(C, kInsertThreads), kInsertThreads, smem,
                        stream>>>(bind, valid, C, V, slots, H, alive);
}

// Row i survives the dedup.
__device__ __forceinline__ bool dedup_survives(
    const unsigned char* __restrict__ valid,
    const unsigned char* __restrict__ alive, long long i) {
  return valid[i] && alive[i];
}

}  // namespace rt

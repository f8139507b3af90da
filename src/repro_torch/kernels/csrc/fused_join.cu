// fused_join: dedup -> join range search -> exclusive scan -> expansion
// of a gathered binding table against a sorted (key -> payload) edge
// table, into a fixed `capacity`-row output plus the overflow count.
//
// Replaces the Pallas kernel repro/kernels/semijoin.py::_fused_join_kernel
// (fused_join_blocks, wrapper repro.kernels.ops.fused_join), one VMEM
// pass on the TPU.  The scan needs a barrier across the whole grid, so
// here it is several launches behind one entry point:
//   1. the parallel hash dedup of dedup_rows.cu (insert);
//   2. per surviving row, the [lo, hi) run of its probe key (two
//      branchless binary searches), the count, and the largest count;
//   3. a hand-written three-pass exclusive scan of the counts in int32
//      (tile scans, one block scanning the tile sums, tile offsets
//      added back), which also writes the total and the overflow count
//      with the reference's wrap guard: when any count exceeds
//      (2^31-1)/C the int32 sum could wrap, and the overflow is
//      reported as capacity + 1;
//   4. one thread per output slot t searching the offsets for its
//      source row r, then copying bind[r] and payload[lo[r] + t -
//      start[r]].
// Output rows follow the input row order (the reference's composition
// sorts rows during its dedup); row multiset and overflow count equal.
// Bound: memory.  The table is read about twice (hash, compare), the
// edge column log2(T) times per surviving row (L2-resident at the SPMD
// loop's window sizes) and the outputs written once; the scan adds
// three light passes over C int32 counts.
#include "common.cuh"

namespace {

constexpr int kScanThreads = 1024;
constexpr int kItems = 4;                       // counts per scan thread
constexpr int kTile = kScanThreads * kItems;

__global__ void probe_kernel(const int* __restrict__ slots,
                             const int* __restrict__ slot_of,
                             const int* __restrict__ probe, int C,
                             const int* __restrict__ keys, int T,
                             int* __restrict__ lo, int* __restrict__ cnt,
                             int* __restrict__ scalars) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  int l = 0, c = 0;
  if (i < C) {
    if (rt::first_occurrence(slots, slot_of, i)) {
      int x = probe[i];
      l = rt::lower_bound(keys, T, x);
      c = rt::upper_bound(keys, T, x) - l;
    }
    lo[i] = l;
    cnt[i] = c;
  }
  // the largest count feeds the wrap guard: one atomic per warp
  int wmax = __reduce_max_sync(0xFFFFFFFFu, c);
  if ((threadIdx.x & 31) == 0 && wmax > 0) atomicMax(&scalars[1], wmax);
}

// Exclusive scan of one value per thread across the block (unsigned, so
// an int32 wrap behaves like the reference's).  Returns the prefix and
// writes the block total.
__device__ unsigned block_exclusive_scan(unsigned v, unsigned* total) {
  __shared__ unsigned warp_sums[kScanThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  unsigned incl = v;
  for (int off = 1; off < 32; off <<= 1) {
    unsigned n = __shfl_up_sync(0xFFFFFFFFu, incl, off);
    if (lane >= off) incl += n;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    unsigned w = lane < nwarps ? warp_sums[lane] : 0u;
    for (int off = 1; off < 32; off <<= 1) {
      unsigned n = __shfl_up_sync(0xFFFFFFFFu, w, off);
      if (lane >= off) w += n;
    }
    if (lane < nwarps) warp_sums[lane] = w;
  }
  __syncthreads();
  unsigned base = warp > 0 ? warp_sums[warp - 1] : 0u;
  *total = warp_sums[nwarps - 1];
  return base + incl - v;
}

// Pass 1: exclusive scan inside each tile of kTile counts.
__global__ void scan_tiles_kernel(const int* __restrict__ cnt, int C,
                                  int* __restrict__ start,
                                  int* __restrict__ tile_sums) {
  long long base = (long long)blockIdx.x * kTile +
                   (long long)threadIdx.x * kItems;
  unsigned vals[kItems];
  unsigned sum = 0;
  for (int j = 0; j < kItems; ++j) {
    long long i = base + j;
    vals[j] = i < C ? (unsigned)cnt[i] : 0u;
    sum += vals[j];
  }
  unsigned total;
  unsigned run = block_exclusive_scan(sum, &total);
  for (int j = 0; j < kItems; ++j) {
    long long i = base + j;
    if (i < C) start[i] = (int)run;
    run += vals[j];
  }
  if (threadIdx.x == 0) tile_sums[blockIdx.x] = (int)total;
}

// Pass 2 (one block): exclusive scan of the tile sums in place.
__global__ void scan_tile_sums_kernel(int* __restrict__ tile_sums,
                                      int ntiles) {
  const int per = (ntiles + kScanThreads - 1) / kScanThreads;
  const int b = threadIdx.x * per;
  unsigned sum = 0;
  for (int j = 0; j < per && b + j < ntiles; ++j)
    sum += (unsigned)tile_sums[b + j];
  unsigned total;
  unsigned run = block_exclusive_scan(sum, &total);
  for (int j = 0; j < per && b + j < ntiles; ++j) {
    unsigned v = (unsigned)tile_sums[b + j];
    tile_sums[b + j] = (int)run;
    run += v;
  }
}

// Pass 3: add each tile's offset; the last row writes the total and the
// overflow count (wrap guard as in the reference).
__global__ void scan_add_kernel(int* __restrict__ start,
                                const int* __restrict__ cnt, int C,
                                const int* __restrict__ tile_sums,
                                int capacity, int* __restrict__ scalars,
                                int* __restrict__ over) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= C) return;
  unsigned s = (unsigned)start[i] + (unsigned)tile_sums[i / kTile];
  start[i] = (int)s;
  if (i == C - 1) {
    int total = (int)(s + (unsigned)cnt[i]);
    scalars[0] = total;
    bool wrap_risk = scalars[1] > 2147483647 / C;
    int o = total - capacity;
    over[0] = wrap_risk ? capacity + 1 : (o > 0 ? o : 0);
  }
}

__global__ void expand_kernel(const int* __restrict__ bind, int C, int V,
                              const int* __restrict__ start,
                              const int* __restrict__ cnt,
                              const int* __restrict__ lo,
                              const int* __restrict__ payload, int T,
                              const int* __restrict__ scalars, int capacity,
                              int* __restrict__ out_bind,
                              int* __restrict__ out_col,
                              unsigned char* __restrict__ out_valid) {
  int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= capacity) return;
  const int total = scalars[0];
  int r = rt::upper_bound(start, C, t) - 1;
  r = r < 0 ? 0 : (r > C - 1 ? C - 1 : r);
  const int k = t - start[r];
  const bool ok = t < total && k < cnt[r];
  int* ob = out_bind + (size_t)t * V;
  if (ok) {
    int src = lo[r] + k;
    src = src < 0 ? 0 : (src > T - 1 ? T - 1 : src);
    out_col[t] = payload[src];
    const int* rb = bind + (size_t)r * V;
    for (int v = 0; v < V; ++v) ob[v] = rb[v];
  } else {
    out_col[t] = -1;
    for (int v = 0; v < V; ++v) ob[v] = -1;
  }
  out_valid[t] = ok ? 1 : 0;
}

}  // namespace

// Scratch (int32, allocated by the caller): slots[H], slot_of[C], lo[C],
// cnt[C], start[C], tile_sums[ceil(C / 4096)], scalars[2].
extern "C" int rt_fused_join(const int* bind, const unsigned char* valid,
                             const int* probe, int C, int V, const int* keys,
                             const int* payload, int T, int capacity,
                             int* slots, int H, int* slot_of, int* lo,
                             int* cnt, int* start, int* tile_sums,
                             int* scalars, int* out_bind, int* out_col,
                             unsigned char* out_valid, int* over,
                             cudaStream_t stream) {
  cudaError_t err;
  if (C <= 0) {                     // nothing to join: all slots empty
    err = cudaMemsetAsync(out_bind, 0xFF, (size_t)capacity * V * sizeof(int),
                          stream);
    if (err == cudaSuccess)
      err = cudaMemsetAsync(out_col, 0xFF, (size_t)capacity * sizeof(int),
                            stream);
    if (err == cudaSuccess)
      err = cudaMemsetAsync(out_valid, 0, (size_t)capacity, stream);
    if (err == cudaSuccess) err = cudaMemsetAsync(over, 0, sizeof(int), stream);
    return (int)err;
  }
  err = cudaMemsetAsync(slots, 0xFF, (size_t)H * sizeof(int), stream);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(scalars, 0, 2 * sizeof(int), stream);
  if (err != cudaSuccess) return (int)err;
  const unsigned rows = rt::grid_for(C);
  rt::dedup_insert_kernel<<<rows, rt::kThreads, 0, stream>>>(
      bind, valid, C, V, slots, H, slot_of);
  probe_kernel<<<rows, rt::kThreads, 0, stream>>>(
      slots, slot_of, probe, C, keys, T, lo, cnt, scalars);
  const int ntiles = (C + kTile - 1) / kTile;
  scan_tiles_kernel<<<ntiles, kScanThreads, 0, stream>>>(cnt, C, start,
                                                         tile_sums);
  scan_tile_sums_kernel<<<1, kScanThreads, 0, stream>>>(tile_sums, ntiles);
  scan_add_kernel<<<rows, rt::kThreads, 0, stream>>>(
      start, cnt, C, tile_sums, capacity, scalars, over);
  if (capacity > 0)
    expand_kernel<<<rt::grid_for(capacity), rt::kThreads, 0, stream>>>(
        bind, C, V, start, cnt, lo, payload, T, scalars, capacity, out_bind,
        out_col, out_valid);
  return (int)cudaGetLastError();
}

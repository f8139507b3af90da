// fused_join: for each of m sites, dedup -> join range search ->
// exclusive scan -> expansion of one gathered binding table against the
// site's sorted (key -> payload) edge table, into a fixed
// `capacity`-row output per site plus the site's overflow count.
//
// Replaces the Pallas kernel repro/kernels/semijoin.py::_fused_join_kernel
// (fused_join_blocks, wrapper repro.kernels.ops.fused_join), one VMEM
// pass on the TPU, called there once per site.  The match loop's gather
// step joins the SAME gathered table against every site's window, so
// here one call serves all m sites (m = 1 is ops.fused_join):
//   0. one memset presets the hash slots, the tile tickets, the scan's
//      tile status words and the rows' alive bytes (all to ones);
//   1. the parallel hash insert of dedup_rows.cu, once for all sites
//      (dedup.cuh: 64-bit slots of hash and index; the insert marks
//      every duplicate, so a row survives iff valid && alive);
//   2. scan, grid.y = site: each tile of 1024 rows (claimed in order
//      through a per-site atomic ticket) probes its surviving rows
//      against the site's window (one lower-bound search and a gallop to
//      the run's end, search.cuh), scans the counts in the block, and
//      chains the tiles by a single-pass decoupled look-back: a 64-bit
//      status word per tile holds its aggregate or inclusive prefix and
//      the OR of its rows' wrap-risk flags (a count above (2^31-1)/C
//      could wrap the int32 scan).  The last tile writes the site's
//      total and its overflow: capacity + 1 under the wrap guard, as the
//      reference reports it.  Two variants of the search were measured
//      and lost (H100, PERF.md): join_count.cu's staged search (sampled
//      keys in shared memory), at every tier of the serve (4 x 4096 to
//      4 x 2^18 rows), likely because the persistent grid it needs
//      keeps fewer searches in flight than one block per tile; and a
//      thread's four searches interleaved level by level;
//   3. expand, grid (output tiles, site): each block owns 1024 output
//      slots of one site, finds its first source row with ONE search of
//      the inclusive ends, stages the ends of the rows it covers in
//      shared memory (1024 a round) and resolves each slot there, then
//      writes the bind columns with neighbouring threads on
//      neighbouring words.  Slots at or past the total (all of them
//      under the wrap guard) get -1 / -1 / 0.
// Each site's rows come out in the same order as the earlier six-launch
// kernel's: survivors in input order, each survivor's matches in key
// order (the reference's composition sorts rows during its dedup; row
// multiset and overflow count equal).
// Bound: memory and latency.  The table is read once to hash (a second
// row only where two hashes are equal) once per call instead of once
// per site, the survivors' flags once a site; each survivor costs
// one dependent search per site (L2-resident windows at the SPMD loop's
// sizes), the counts and offsets are written and read once, and the
// outputs written once.  Four device operations a call for all sites,
// where the earlier kernel issued three memsets and six launches per
// site.
#include <climits>

#include "dedup.cuh"
#include "search.cuh"

namespace {

constexpr int kScanThreads = 256;
constexpr int kItems = 4;                        // rows per scan thread
constexpr int kScanTile = kScanThreads * kItems;  // rows per scan tile
constexpr int kExpThreads = 256;
constexpr int kExpTile = 1024;                   // output slots a block
constexpr int kExpChunk = 1024;                  // row ends staged a round

// tile status word: bits 63-62 the flag, bit 61 the wrap risk, bits
// 31-0 the (unsigned, wrapping) sum; preset to all ones = not ready
constexpr unsigned long long kNotReady = ~0ull;
constexpr unsigned kAggregate = 1u, kInclusive = 2u;

__device__ __forceinline__ unsigned long long pack(unsigned flag, bool risk,
                                                   unsigned sum) {
  return ((unsigned long long)flag << 62) |
         ((unsigned long long)risk << 61) | sum;
}

// Exclusive scan of one value per thread across the block (unsigned, so
// an int32 wrap behaves like the reference's).  Returns the prefix and
// writes the block total.
__device__ unsigned block_exclusive_scan(unsigned v, unsigned* total) {
  __shared__ unsigned warp_sums[kScanThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int nwarps = kScanThreads / 32;
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

// lo and inclusive end of every row for site blockIdx.y, one tile per
// block, claimed in order.
__global__ void __launch_bounds__(kScanThreads)
scan_kernel(const unsigned char* __restrict__ valid,
            const unsigned char* __restrict__ alive,
            const int* __restrict__ probe, long long pstride, int C,
            const int* __restrict__ keys, rt::Sites sites, int T,
            int* __restrict__ ticket,
            unsigned long long* __restrict__ status, int ntiles,
            int capacity, int* __restrict__ lo_out,
            int* __restrict__ end_out, int* __restrict__ total_out,
            int* __restrict__ over) {
  __shared__ int tile_sh;
  __shared__ unsigned prefix_sh;
  const int j = blockIdx.y;
  const int* kj = keys + sites.off[j];
  const int n = sites.live[j];
  const int limit = 2147483647 / (C > 0 ? C : 1);
  volatile unsigned long long* st = status + (size_t)j * ntiles;
  if (threadIdx.x == 0) tile_sh = atomicAdd(&ticket[j], 1) + 1;
  __syncthreads();
  const int tile = tile_sh;
  const long long base =
      (long long)tile * kScanTile + (long long)threadIdx.x * kItems;
  int lo[kItems], cnt[kItems];
  unsigned sum = 0;
  bool risk = false;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const long long i = base + k;
    lo[k] = 0;
    cnt[k] = 0;
    if (i < C && rt::dedup_survives(valid, alive, i)) {
      const int x = probe[i * pstride];
      lo[k] = rt::lower_bound(kj, n, x);
      int h = rt::run_end(kj, n, lo[k], x);
      if (x == rt::kSentinel) h += T - n;  // the window's pad rows
      cnt[k] = h - lo[k];
    }
    sum += (unsigned)cnt[k];
    risk |= cnt[k] > limit;
  }
  unsigned block_sum;
  const unsigned excl = block_exclusive_scan(sum, &block_sum);
  const bool block_risk = __syncthreads_or(risk) != 0;
  if (threadIdx.x == 0) {
    unsigned prefix = 0;
    bool prefix_risk = false;
    if (tile > 0) {
      st[tile] = pack(kAggregate, block_risk, block_sum);
      for (int p = tile - 1;; --p) {  // tiles before were claimed first
        unsigned long long w;
        // a claimed tile publishes within microseconds; a wait of
        // seconds means a broken invariant: fail the launch, not hang
        for (long long polls = 0; (w = st[p]) == kNotReady; ++polls)
          if (polls > (1LL << 26)) __trap();
        prefix += (unsigned)w;
        prefix_risk |= ((w >> 61) & 1ull) != 0;
        if ((unsigned)(w >> 62) == kInclusive) break;
      }
    }
    const unsigned incl = prefix + block_sum;
    const bool incl_risk = prefix_risk || block_risk;
    st[tile] = pack(kInclusive, incl_risk, incl);
    prefix_sh = prefix;
    if (tile == ntiles - 1) {
      const int total = (int)incl;
      const int o = total - capacity;
      over[j] = incl_risk ? capacity + 1 : (o > 0 ? o : 0);
      total_out[j] = incl_risk ? -1 : total;  // no valid slot then
    }
  }
  __syncthreads();
  unsigned run = prefix_sh + excl;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const long long i = base + k;
    if (i < C) {
      run += (unsigned)cnt[k];
      lo_out[(size_t)j * C + i] = lo[k];
      end_out[(size_t)j * C + i] = (int)run;
    }
  }
}

__global__ void __launch_bounds__(kExpThreads)
expand_kernel(const int* __restrict__ bind, int C, int V,
              const int* __restrict__ lo_all, const int* __restrict__ end_all,
              const int* __restrict__ total_all,
              const int* __restrict__ payload, rt::Sites sites, int capacity,
              int* __restrict__ out_bind, int* __restrict__ out_col,
              unsigned char* __restrict__ out_valid) {
  // ends[0] = end of the row before r0 (0 before the first row),
  // ends[1 + i] = end of row r0 + i (INT_MAX past the last row)
  __shared__ int ends[kExpChunk + 1];
  __shared__ int row_of[kExpTile];  // source row of each slot, -1 if none
  __shared__ int r0_sh;
  const int j = blockIdx.y;
  const int t0 = blockIdx.x * kExpTile;
  const int n_slots = min(kExpTile, capacity - t0);
  const int total = total_all[j];
  const int t_end = min(t0 + n_slots, max(total, t0));  // valid: [t0, t_end)
  const size_t site = (size_t)j * capacity;
  const int* end = end_all + (size_t)j * C;
  const int* lo = lo_all + (size_t)j * C;
  const int* pay = payload + sites.off[j];
  const int live = sites.live[j];
  for (int s = threadIdx.x; s < kExpTile; s += kExpThreads) row_of[s] = -1;
  if (t_end > t0) {
    if (threadIdx.x == 0) r0_sh = rt::upper_bound(end, C, t0);
    __syncthreads();
    for (int r0 = r0_sh;; r0 += kExpChunk) {
      for (int i = threadIdx.x; i <= kExpChunk; i += kExpThreads) {
        const long long r = (long long)r0 - 1 + i;
        ends[i] = r < 0 ? 0 : (r < C ? end[r] : INT_MAX);
      }
      __syncthreads();
      const int last = ends[kExpChunk];
      for (int s = threadIdx.x; s < n_slots; s += kExpThreads) {
        const int t = t0 + s;
        if (t < t_end && row_of[s] < 0 && t < last) {
          // the first staged row whose end passes t; the one before it
          // ends at or before t, so t is match t - ends[i] of row r
          const int i = rt::upper_bound(ends + 1, kExpChunk, t);
          const int r = r0 + i;
          const int src = lo[r] + (t - ends[i]);
          row_of[s] = r;
          out_col[site + t] = src < live ? pay[src] : -1;
          out_valid[site + t] = 1;
        }
      }
      if (t_end - 1 < last) break;
      __syncthreads();  // every slot read `ends` before it is restaged
    }
  }
  __syncthreads();
  for (int s = threadIdx.x; s < n_slots; s += kExpThreads) {
    if (t0 + s >= t_end) {
      out_col[site + t0 + s] = -1;
      out_valid[site + t0 + s] = 0;
    }
  }
  int* ob = out_bind + (site + t0) * V;
  const int words = n_slots * V;
  for (int w = threadIdx.x; w < words; w += kExpThreads) {
    const int s = w / V, v = w - s * V;
    const int r = row_of[s];
    ob[w] = r >= 0 ? bind[(size_t)r * V + v] : -1;
  }
}

inline long long round4(long long n) { return (n + 3) / 4 * 4; }

}  // namespace

// One call for m <= rt::kMaxSites sites.  probe[i * pstride] is row i's
// probe key (pstride 0: one constant).  Site j's table: rows [off[j],
// off[j] + T) of keys / payload, the first live[j] stored, the rest pads
// (key INT32_SENTINEL, payload -1).  Scratch (int32, scratch_ints of
// them; kernels/ops.py sizes it the same way): the preset part [status
// words round4(2 m ntiles) | slots 2H | tickets round4(m) | alive bytes
// round4(ceil(C / 4))], then [lo m C | end m C | total m].  Outputs: out_bind (m,
// capacity, V), out_col and out_valid (m, capacity), over (m).
extern "C" int rt_fused_join(const int* bind, const unsigned char* valid,
                             const int* probe, long long pstride, int C, int V,
                             const int* keys, const int* payload,
                             const long long* off, const int* live, int m,
                             int T, int capacity, int* scratch,
                             long long scratch_ints, int* out_bind,
                             int* out_col, unsigned char* out_valid, int* over,
                             cudaStream_t stream) {
  if (m < 1 || m > rt::kMaxSites || C < 0 || V < 1 || capacity < 0)
    return (int)cudaErrorInvalidValue;
  const rt::Sites sites = rt::make_sites(off, live, m);
  const int ntiles = C > 0 ? (C + kScanTile - 1) / kScanTile : 1;
  int H = 8;
  while (H < 2 * C) H *= 2;
  const long long preset =
      round4(2LL * m * ntiles) + 2LL * H + round4(m) + round4((C + 3) / 4);
  if (preset + 2LL * m * C + m > scratch_ints)
    return (int)cudaErrorInvalidValue;
  auto* status = reinterpret_cast<unsigned long long*>(scratch);
  auto* slots = reinterpret_cast<unsigned long long*>(
      scratch + round4(2LL * m * ntiles));
  int* ticket = reinterpret_cast<int*>(slots + H);
  auto* alive = reinterpret_cast<unsigned char*>(ticket + round4(m));
  int* lo = scratch + preset;
  int* end = lo + (size_t)m * C;
  int* total = end + (size_t)m * C;
  cudaError_t err = cudaMemsetAsync(scratch, 0xFF, preset * sizeof(int),
                                    stream);
  if (err != cudaSuccess) return (int)err;
  if (C > 0)
    rt::launch_dedup_insert(bind, valid, C, V, slots, H, alive, stream);
  scan_kernel<<<dim3(ntiles, m), kScanThreads, 0, stream>>>(
      valid, alive, probe, pstride, C, keys, sites, T, ticket, status,
      ntiles, capacity, lo, end, total, over);
  if (capacity > 0)
    expand_kernel<<<dim3((capacity + kExpTile - 1) / kExpTile, m),
                    kExpThreads, 0, stream>>>(
        bind, C, V, lo, end, total, payload, sites, capacity, out_bind,
        out_col, out_valid);
  return (int)cudaGetLastError();
}

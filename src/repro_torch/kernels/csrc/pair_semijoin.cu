// pair_semijoin: exact int32 membership of query (s, o) pairs among the
// rows of one table of (s, o) pairs per site.
//
// Replaces the Pallas kernel repro/kernels/semijoin.py::_pair_kernel
// (pair_semijoin_blocks, wrapper repro.kernels.ops.pair_semijoin), a
// blocked dense compare over both sides lexsorted.  Every table the
// match loop passes is already lexsorted by (s, o) in equal-length runs:
// a site's property window sliced from the store's (p, s, o)-sorted CSR
// arrays (one run, read in place with its tail as (INT32_SENTINEL,
// INT32_SENTINEL) pads), or the edge-shipped table of m (s, o)-sorted,
// sentinel-filled runs.  So no sort runs on the card: each query does
// one (s, o) lower-bound search per run, and every site's answers come
// from one launch (grid.y = site).
// Bound: the L2 sectors of dependent, scattered loads, as join_count:
// moving the pairs in and the mask out takes microseconds.  Calls of at
// least the wrapper's threshold of queries (PAIR_STAGE_MIN_PROBES in
// kernels/ops.py, chosen from the card's device times of both modes at
// the serve's tiers) on one-run tables first gather every 2^shift-th
// subject of each window (search.cuh), then a persistent grid stages
// them in shared memory, finds the subject's first row by the staged,
// interpolating search of join_count.cu and gallops through the
// subject's short run to the object.  Smaller calls, and tables of
// several runs, search each run directly, one thread a query.
#include <algorithm>

#include "search.cuh"

namespace {

constexpr int kDirectThreads = 256;
constexpr int kStagedThreads = 1024;

__device__ __forceinline__ bool pair_less(int as, int ao, int s, int o) {
  return as < s || (as == s && ao < o);
}

// First row p of [0, n) with (ts[p], to[p]) >= (s, o).
__device__ __forceinline__ int pair_lower_bound(const int* __restrict__ ts,
                                                const int* __restrict__ to,
                                                int n, int s, int o) {
  int lo = 0, len = n;
  while (len > 0) {
    const int half = len >> 1, m = lo + half;
    const bool less = pair_less(ts[m], to[m], s, o);
    lo = less ? m + 1 : lo;
    len = less ? len - half - 1 : half;
  }
  return lo;
}

// The same row, given lo = the first row with ts >= s: gallop through
// s's run (lo+1, lo+2, lo+4, ...), then search the bracket.
__device__ __forceinline__ int pair_from(const int* __restrict__ ts,
                                         const int* __restrict__ to, int n,
                                         int lo, int s, int o) {
  if (lo >= n || !pair_less(ts[lo], to[lo], s, o)) return lo;
  int p = lo, step = 1;  // row p < (s, o)
  while (p + step < n && pair_less(ts[p + step], to[p + step], s, o)) {
    p += step;
    step <<= 1;
  }
  const int from = p + 1, end = min(p + step, n);
  return from + pair_lower_bound(ts + from, to + from, end - from, s, o);
}

// Row p of the n stored rows holds (s, o), or (s, o) is the pad pair
// and the table has pads.
__device__ __forceinline__ bool hit_at(const int* __restrict__ ts,
                                       const int* __restrict__ to, int n,
                                       int p, int s, int o, bool pads) {
  return (p < n && ts[p] == s && to[p] == o) ||
         (pads && s == rt::kSentinel && o == rt::kSentinel);
}

// Query i of site j: qs[j * qs_site + i * qs_step] (likewise qo).
struct Queries {
  const int* qs;
  const int* qo;
  long long qs_site, qs_step, qo_site, qo_step;
};

__global__ void __launch_bounds__(kDirectThreads)
pair_direct_kernel(Queries q, int C, const int* __restrict__ ts,
                   const int* __restrict__ to, rt::Sites sites, int size,
                   int runs, unsigned char* __restrict__ out) {
  const int j = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= C) return;
  const int s = q.qs[j * q.qs_site + i * q.qs_step];
  const int o = q.qo[j * q.qo_site + i * q.qo_step];
  const int L = size / runs;
  bool hit = false;
  for (int r = 0; r < runs; ++r) {
    const long long base = sites.off[j] + (long long)r * L;
    const int n = min(max(sites.live[j] - r * L, 0), L);
    const int p = pair_lower_bound(ts + base, to + base, n, s, o);
    hit = hit || hit_at(ts + base, to + base, n, p, s, o, n < L);
  }
  out[(size_t)j * C + i] = hit ? 1 : 0;
}

__global__ void gather_kernel(const int* __restrict__ ts, rt::Sites sites,
                              int m, int* __restrict__ samples) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  rt::gather_site_sample(t, ts, sites, m, samples);
}

// One-run tables: site j's samples in shared memory, grid-stride over
// the queries.
__global__ void __launch_bounds__(kStagedThreads)
pair_staged_kernel(Queries q, int C, const int* __restrict__ ts,
                   const int* __restrict__ to, rt::Sites sites, int size,
                   const int* __restrict__ samples_g,
                   unsigned char* __restrict__ out) {
  extern __shared__ __align__(16) int samples[];  // ns[j] ints
  const int j = blockIdx.y;
  const int n = sites.live[j], shift = sites.shift[j], ns = sites.ns[j];
  rt::load_samples(samples, samples_g + (size_t)j * rt::kMaxSamples, ns);
  __syncthreads();
  const int* tsj = ts + sites.off[j];
  const int* toj = to + sites.off[j];
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < C;
       i += gridDim.x * blockDim.x) {
    const int s = q.qs[j * q.qs_site + i * q.qs_step];
    const int o = q.qo[j * q.qo_site + i * q.qo_step];
    const int ls = rt::staged_lower_bound(tsj, n, shift, samples, ns, s);
    const int p = pair_from(tsj, toj, n, ls, s, o);
    out[(size_t)j * C + i] = hit_at(tsj, toj, n, p, s, o, n < size) ? 1 : 0;
  }
}

}  // namespace

// m <= rt::kMaxSites sites, C queries each (strides in elements).  Site
// j's table: rows [off[j], off[j] + size) of ts / to in `runs` equal
// runs, each lexsorted by (s, o); of its rows the first live[j] are
// stored and the rest are (INT32_SENTINEL, INT32_SENTINEL) pads.  Calls
// of at least stage_min queries on one-run tables stage the subjects'
// samples through `scratch` (m * rt::kMaxSamples ints).  out: (m, C).
extern "C" int rt_pair_semijoin(const int* qs, long long qs_site,
                                long long qs_step, const int* qo,
                                long long qo_site, long long qo_step, int C,
                                const int* ts, const int* to,
                                const long long* off, const int* live, int m,
                                int size, int runs, int stage_min,
                                int* scratch, unsigned char* out,
                                cudaStream_t stream) {
  if (m < 1 || m > rt::kMaxSites || runs < 1 || size % runs != 0)
    return (int)cudaErrorInvalidValue;
  if (C <= 0) return (int)cudaGetLastError();
  const rt::Sites sites = rt::make_sites(off, live, m);
  const Queries q{qs, qo, qs_site, qs_step, qo_site, qo_step};
  if (runs > 1 || C < stage_min || scratch == nullptr) {
    pair_direct_kernel<<<dim3(rt::grid_for(C, kDirectThreads), m),
                         kDirectThreads, 0, stream>>>(q, C, ts, to, sites,
                                                      size, runs, out);
    return (int)cudaGetLastError();
  }
  gather_kernel<<<rt::grid_for((long long)m * rt::kMaxSamples), rt::kThreads,
                  0, stream>>>(ts, sites, m, scratch);
  int max_ns = 0;
  for (int s = 0; s < m; ++s) max_ns = std::max(max_ns, sites.ns[s]);
  const size_t smem = ((size_t)max_ns + 3) / 4 * 16;
  static size_t asked_smem = ~(size_t)0;  // occupancy, asked per size
  static int per_sm = 0;
  if (smem != asked_smem) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, pair_staged_kernel, kStagedThreads, smem);
    asked_smem = smem;
  }
  const long long want = ((long long)C + kStagedThreads - 1) / kStagedThreads;
  const long long fill = (long long)per_sm * rt::sm_count() / m;
  const int blocks = (int)std::max(1LL, std::min(want, fill));
  pair_staged_kernel<<<dim3(blocks, m), kStagedThreads, smem, stream>>>(
      q, C, ts, to, sites, size, scratch, out);
  return (int)cudaGetLastError();
}

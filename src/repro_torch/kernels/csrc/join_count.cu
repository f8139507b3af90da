// join_count / join_range: where each probe key's run starts in an
// ascending int32 key column (lo, searchsorted side="left") and how long
// it is (its multiplicity).
//
// Replaces the Pallas kernel repro/kernels/semijoin.py::_count_kernel
// (semijoin_blocks(count=True), wrapper repro.kernels.ops.join_count),
// a blocked BM x BN dense compare over both sides sorted.  On the H100
// one thread per probe searches the key column, so neither side is
// sorted or padded first.
//
// Bound: the L2 traffic of dependent, scattered loads.  Moving the
// probes in and the results out takes microseconds.  A binary search
// over T = 1.43M keys is ~21 dependent levels; the top ones are shared
// by many probes and hit L1, the last ~8 each touch a 32-byte L2 sector
// of their own, and two such searches a probe (both ends of the run)
// made the earlier kernel ~22 L2 sectors a probe.  This design:
//  * runs one lower-bound search a probe; the end of the run is found
//    by galloping from lo (lo+1, lo+2, lo+4, ...) and a bounded search,
//    so a short run ends in the sector already loaded and a Zipf hub's
//    run costs O(log run);
//  * for large calls, a first launch gathers every 2^shift-th key (at
//    most kMaxSamples, 32 KB) into a scratch buffer; then a persistent
//    grid (two 1024-thread blocks an SM) copies them into shared memory
//    with coalesced loads and grid-strides over the probes.  Two staged
//    samples bracket a window of 2^shift keys (256 for T = 1.43M) that
//    holds lo.  Where the window's keys are spread (their value span at
//    least a quarter of its length, as the subject and object ids of a
//    property window are), lo's position is interpolated from the two
//    sample values and found by galloping from the guess: one or two
//    sectors instead of the ~6 of a binary search.  A window of long
//    runs is binary-searched.  A run longer than 8 keys ends by the same
//    sample search for its upper end instead of a long gallop;
//  * small calls (fewer probes than the caller's threshold, set in
//    kernels/ops.py from the card's times) skip the staging and search
//    the whole column, one thread a probe.
// lo is written only when the caller asks for it (join_range).  The
// searches live in search.cuh, shared with fused_join.cu and
// pair_semijoin.cu.
#include "search.cuh"

namespace {

constexpr int kStagedThreads = 1024;
constexpr int kStagedBlocksPerSm = 2;

__device__ __forceinline__ void store(int i, int lo, int hi,
                                      int* __restrict__ lo_out,
                                      int* __restrict__ cnt_out) {
  if (lo_out != nullptr) lo_out[i] = lo;
  cnt_out[i] = hi - lo;
}

__global__ void join_range_direct_kernel(const int* __restrict__ probe, int n,
                                         const int* __restrict__ keys, int T,
                                         int* __restrict__ lo_out,
                                         int* __restrict__ cnt_out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int x = probe[i];
  const int lo = rt::lower_bound(keys, T, x);
  store(i, lo, rt::run_end(keys, T, lo, x), lo_out, cnt_out);
}

__global__ void gather_samples_kernel(const int* __restrict__ keys, int ns,
                                      int shift, int* __restrict__ samples) {
  int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j < ns) samples[j] = keys[(long long)j << shift];
}

// samples[j] = keys[j << shift] for the ns = ceil(T / 2^shift) <=
// kMaxSamples samples (rt::staged_lower_bound, rt::staged_run_end).
__global__ void __launch_bounds__(kStagedThreads, kStagedBlocksPerSm)
join_range_staged_kernel(const int* __restrict__ probe, int n,
                         const int* __restrict__ keys, int T, int shift,
                         const int* __restrict__ gathered, int ns,
                         int* __restrict__ lo_out, int* __restrict__ cnt_out) {
  extern __shared__ __align__(16) int samples[];  // ns ints
  rt::load_samples(samples, gathered, ns);
  __syncthreads();
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    const int x = probe[i];
    const int lo = rt::staged_lower_bound(keys, T, shift, samples, ns, x);
    store(i, lo, rt::staged_run_end(keys, T, shift, samples, ns, lo, x),
          lo_out, cnt_out);
  }
}

}  // namespace

// lo_out may be null (counts only).  Calls with at least `stage_min`
// probes stage the column's top levels in shared memory first, through
// `scratch` (rt::kMaxSamples ints).
extern "C" int rt_join_count(const int* probe, int n, const int* keys, int T,
                             int* lo_out, int* cnt_out, int stage_min,
                             int* scratch, cudaStream_t stream) {
  if (n <= 0) return (int)cudaGetLastError();
  if (n < stage_min || T == 0) {
    join_range_direct_kernel<<<rt::grid_for(n), rt::kThreads, 0, stream>>>(
        probe, n, keys, T, lo_out, cnt_out);
    return (int)cudaGetLastError();
  }
  const int shift = rt::sample_shift(T);
  const int ns = rt::sample_count(T, shift);
  gather_samples_kernel<<<rt::grid_for(ns), rt::kThreads, 0, stream>>>(
      keys, ns, shift, scratch);
  const int sms = rt::sm_count();
  const long long want = ((long long)n + kStagedThreads - 1) / kStagedThreads;
  const int blocks = (int)(want < (long long)kStagedBlocksPerSm * sms
                               ? want
                               : (long long)kStagedBlocksPerSm * sms);
  // shared memory for the samples only: the rest of the SM's 256 KB
  // stays L1, which holds the searches' shared upper levels
  const size_t smem = ((size_t)ns + 3) / 4 * 16;
  join_range_staged_kernel<<<blocks, kStagedThreads, smem, stream>>>(
      probe, n, keys, T, shift, scratch, ns, lo_out, cnt_out);
  return (int)cudaGetLastError();
}

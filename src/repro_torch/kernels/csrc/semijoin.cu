// semijoin: membership mask of int32 queries in an ascending int32 table.
//
// Replaces the Pallas kernel repro/kernels/semijoin.py::_semijoin_kernel
// (semijoin_blocks(count=False), wrapper repro.kernels.ops.semijoin), a
// blocked BM x BN dense equality compare over both sides sorted and
// padded.  Here the queries are neither sorted nor padded and the mask
// comes back in query order.  The mask is exact membership: a table
// padded with INT32_MIN (or INT32_MAX) rows matches only a query equal
// to the pad, which real ids never are.
// Bound: the L2 sectors of dependent, scattered loads, as join_count.cu:
// moving Q queries in and Q mask bytes out takes microseconds, a binary
// search over T = 1.43M keys touches about 6 L2 sectors of its own.  So
// calls of at least the wrapper's threshold of queries
// (SEMI_STAGE_MIN_PROBES in kernels/ops.py, chosen from the card's
// device times of both modes) run the staged search of join_count.cu
// (search.cuh): a first launch gathers every 2^shift-th key, a
// persistent grid copies them into shared memory and interpolates
// within the window two samples bracket; membership needs lo and one
// compare, not the run's end.  Smaller calls run one branchless binary
// search a query over the whole table.
#include "search.cuh"

namespace {

constexpr int kStagedThreads = 1024;
constexpr int kStagedBlocksPerSm = 2;

__global__ void semijoin_direct_kernel(const int* __restrict__ q, int n,
                                       const int* __restrict__ table, int T,
                                       bool* __restrict__ out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int x = q[i];
  int pos = rt::lower_bound(table, T, x);
  out[i] = pos < T && table[pos] == x;
}

__global__ void gather_samples_kernel(const int* __restrict__ table, int ns,
                                      int shift, int* __restrict__ samples) {
  int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j < ns) samples[j] = table[(long long)j << shift];
}

__global__ void __launch_bounds__(kStagedThreads, kStagedBlocksPerSm)
semijoin_staged_kernel(const int* __restrict__ q, int n,
                       const int* __restrict__ table, int T, int shift,
                       const int* __restrict__ gathered, int ns,
                       bool* __restrict__ out) {
  extern __shared__ __align__(16) int samples[];  // ns ints
  rt::load_samples(samples, gathered, ns);
  __syncthreads();
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x)
    out[i] = rt::staged_contains(table, T, shift, samples, ns, q[i]);
}

}  // namespace

// Calls with at least `stage_min` queries stage the table's samples in
// shared memory first, through `scratch` (rt::kMaxSamples ints).
extern "C" int rt_semijoin(const int* q, int n, const int* table, int T,
                           bool* out, int stage_min, int* scratch,
                           cudaStream_t stream) {
  if (n <= 0) return (int)cudaGetLastError();
  if (n < stage_min || T == 0) {
    semijoin_direct_kernel<<<rt::grid_for(n), rt::kThreads, 0, stream>>>(
        q, n, table, T, out);
    return (int)cudaGetLastError();
  }
  const int shift = rt::sample_shift(T);
  const int ns = rt::sample_count(T, shift);
  gather_samples_kernel<<<rt::grid_for(ns), rt::kThreads, 0, stream>>>(
      table, ns, shift, scratch);
  const int sms = rt::sm_count();
  const long long want = ((long long)n + kStagedThreads - 1) / kStagedThreads;
  const int blocks = (int)(want < (long long)kStagedBlocksPerSm * sms
                               ? want
                               : (long long)kStagedBlocksPerSm * sms);
  const size_t smem = ((size_t)ns + 3) / 4 * 16;
  semijoin_staged_kernel<<<blocks, kStagedThreads, smem, stream>>>(
      q, n, table, T, shift, scratch, ns, out);
  return (int)cudaGetLastError();
}

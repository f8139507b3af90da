// pair_semijoin: exact int32 membership of query (s, o) pairs among the
// rows of a table of (s, o) pairs.
//
// Replaces the Pallas kernel repro/kernels/semijoin.py::_pair_kernel
// (pair_semijoin_blocks, wrapper repro.kernels.ops.pair_semijoin), a
// blocked dense compare over both sides lexsorted.  Here the wrapper
// lexsorts only the table (two stable sorts, as the reference wrapper
// does outside its kernel) and one thread per query binary-searches the
// (s, o) order; the query side needs no sort and no padding.
// Bound: memory, as join_count: log2(T) dependent loads per query into
// two columns that stay in L2 at the SPMD loop's table sizes.
#include "common.cuh"

namespace {

__global__ void pair_member_kernel(const int* __restrict__ qs,
                                   const int* __restrict__ qo, int n,
                                   const int* __restrict__ ts,
                                   const int* __restrict__ to, int T,
                                   unsigned char* __restrict__ out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int s = qs[i], o = qo[i];
  int lo = 0, len = T;
  while (len > 0) {                 // first row with (ts, to) >= (s, o)
    int half = len >> 1;
    int m = lo + half;
    bool less = ts[m] < s || (ts[m] == s && to[m] < o);
    lo = less ? m + 1 : lo;
    len = less ? len - half - 1 : half;
  }
  out[i] = (lo < T && ts[lo] == s && to[lo] == o) ? 1 : 0;
}

}  // namespace

extern "C" int rt_pair_semijoin(const int* qs, const int* qo, int n,
                                const int* ts, const int* to, int T,
                                unsigned char* out, cudaStream_t stream) {
  if (n > 0)
    pair_member_kernel<<<rt::grid_for(n), rt::kThreads, 0, stream>>>(
        qs, qo, n, ts, to, T, out);
  return (int)cudaGetLastError();
}

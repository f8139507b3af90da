// semijoin: membership mask of int32 queries in an ascending int32 table.
//
// Replaces the Pallas kernel repro/kernels/semijoin.py::_semijoin_kernel
// (semijoin_blocks(count=False), wrapper repro.kernels.ops.semijoin), a
// blocked BM x BN dense equality compare over both sides sorted and
// padded.  On the H100 one thread per query runs one branchless binary
// search (as join_count.cu does), so the queries are neither sorted nor
// padded and the mask comes back in query order.  The mask is exact
// membership: a table padded with INT32_MIN (or INT32_MAX) rows matches
// only a query equal to the pad, which real ids never are.
// Bound: memory.  Each query costs log2(T) dependent loads into the
// table (L2-resident at the windows the engine uses); the kernel moves
// its Q queries in, Q mask bytes out, plus one pass over the table.
#include "common.cuh"

namespace {

__global__ void semijoin_kernel(const int* __restrict__ q, int n,
                                const int* __restrict__ table, int T,
                                bool* __restrict__ out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int x = q[i];
  int pos = rt::lower_bound(table, T, x);
  out[i] = pos < T && table[pos] == x;
}

}  // namespace

extern "C" int rt_semijoin(const int* q, int n, const int* table, int T,
                           bool* out, cudaStream_t stream) {
  if (n > 0)
    semijoin_kernel<<<rt::grid_for(n), rt::kThreads, 0, stream>>>(q, n, table,
                                                                  T, out);
  return (int)cudaGetLastError();
}

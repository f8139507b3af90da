// join_count: multiplicity of each probe key in an ascending int32 key
// column.
//
// Replaces the Pallas kernel repro/kernels/semijoin.py::_count_kernel
// (semijoin_blocks(count=True), wrapper repro.kernels.ops.join_count),
// a blocked BM x BN dense compare over both sides sorted.  On the H100
// one thread per probe runs two branchless binary searches (left and
// right end of its run), so neither side is sorted or padded first.
// Bound: memory.  Each probe costs 2*log2(T) dependent loads into the
// key column; at the windows the SPMD loop uses (<= a few MB) the
// column stays in the 50 MB L2, so the kernel moves little more than
// its C probes in and C counts out, plus one pass over the column.
#include "common.cuh"

namespace {

__global__ void join_count_kernel(const int* __restrict__ probe, int n,
                                  const int* __restrict__ keys, int T,
                                  int* __restrict__ out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int x = probe[i];
  out[i] = rt::upper_bound(keys, T, x) - rt::lower_bound(keys, T, x);
}

}  // namespace

extern "C" int rt_join_count(const int* probe, int n, const int* keys, int T,
                             int* out, cudaStream_t stream) {
  if (n > 0)
    join_count_kernel<<<rt::grid_for(n), rt::kThreads, 0, stream>>>(
        probe, n, keys, T, out);
  return (int)cudaGetLastError();
}

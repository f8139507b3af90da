// dedup_rows: first-occurrence keep mask over the valid rows of a padded
// (C, V) int32 binding table.
//
// Replaces the Pallas kernel repro/kernels/semijoin.py::_dedup_kernel /
// _hash_dedup_rows (dedup_blocks, wrapper repro.kernels.ops.dedup_rows),
// whose open-addressed insert runs one row at a time.  Here every row
// inserts in parallel (common.cuh: atomicCAS to claim a slot, full-row
// compare on collision, atomicMin to keep the lowest index), and a
// second launch writes keep[i] = (slot of row i holds i) -- bit for bit
// the first occurrence by original index, in place.
// Bound: memory.  Each row is read once to hash and once more per
// collision compare; the H >= 2C int32 slots keep the load factor at or
// below 1/2, so probe chains stay short and the table's random accesses
// are the cost.  The slots are preset with cudaMemsetAsync.
#include "common.cuh"

namespace {

__global__ void dedup_keep_kernel(const int* __restrict__ slots,
                                  const int* __restrict__ slot_of, int C,
                                  unsigned char* __restrict__ keep) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= C) return;
  keep[i] = rt::first_occurrence(slots, slot_of, i) ? 1 : 0;
}

}  // namespace

extern "C" int rt_dedup_rows(const int* bind, const unsigned char* valid,
                             int C, int V, int* slots, int H, int* slot_of,
                             unsigned char* keep, cudaStream_t stream) {
  if (C <= 0) return (int)cudaGetLastError();
  cudaError_t err = cudaMemsetAsync(slots, 0xFF, (size_t)H * sizeof(int),
                                    stream);
  if (err != cudaSuccess) return (int)err;
  rt::dedup_insert_kernel<<<rt::grid_for(C), rt::kThreads, 0, stream>>>(
      bind, valid, C, V, slots, H, slot_of);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dedup_keep_kernel<<<rt::grid_for(C), rt::kThreads, 0, stream>>>(
      slots, slot_of, C, keep);
  return (int)cudaGetLastError();
}

// dedup_rows: first-occurrence keep mask over the valid rows of a padded
// (C, V) int32 binding table, and optionally the table with every row
// that is not kept set to -1 (the match loop's form), rows in place.
//
// Replaces the Pallas kernel repro/kernels/semijoin.py::_dedup_kernel /
// _hash_dedup_rows (dedup_blocks, wrapper repro.kernels.ops.dedup_rows;
// the reference's core/spmd.py::_dedup_padded applies its mask with a
// where), whose open-addressed insert runs one row at a time.  Three
// device operations a call:
//   0. one memset presets the 64-bit slots and the per-row alive bytes;
//   1. every valid row inserts in parallel (dedup.cuh): slots carry the
//      row's 32-bit hash beside its index, so a row loads another row
//      only when their hashes are equal, and the insert itself marks
//      every duplicate, so no slot is looked up again;
//   2. a streaming pass writes keep[i] = valid[i] && alive[i] and, for
//      the masked form, each row or -1 with 16-byte loads and stores.
// Bound: memory.  The valid rows are read twice (insert, masked copy:
// the second read mostly from L2), the table written once, the flags
// read and the mask written once; tiles of padding rows are not read.
// The 8H-byte slot table (16 MB at C = 2^20) stays in the 50 MB L2,
// where the inserts' atomics land at random.
#include "dedup.cuh"

namespace {

constexpr int kFinishThreads = 256;
constexpr int kFinishRows = 1024;  // rows a block

__global__ void __launch_bounds__(kFinishThreads)
dedup_finish_kernel(const int* __restrict__ bind,
                    const unsigned char* __restrict__ valid,
                    const unsigned char* __restrict__ alive, int C, int V,
                    unsigned char* __restrict__ keep, int* __restrict__ out) {
  __shared__ unsigned char kept[kFinishRows];
  const long long r0 = (long long)blockIdx.x * kFinishRows;
  const int n = (int)min((long long)kFinishRows, (long long)C - r0);
  for (int r = threadIdx.x; r < n; r += kFinishThreads) {
    const unsigned char k = rt::dedup_survives(valid, alive, r0 + r);
    kept[r] = k;
    keep[r0 + r] = k;
  }
  if (out == nullptr) return;
  __syncthreads();
  const int* src = bind + r0 * V;
  int* dst = out + r0 * V;
  const int words = n * V;
  int from = 0;
  if (((reinterpret_cast<uintptr_t>(src) |
        reinterpret_cast<uintptr_t>(dst)) & 15) == 0) {
    const int n4 = words >> 2;
    for (int k = threadIdx.x; k < n4; k += kFinishThreads) {
      bool in[4];  // word 4k + u belongs to a kept row
      int r = (4 * k) / V, c = 4 * k - r * V;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        in[u] = kept[r];
        if (++c == V) {
          c = 0;
          ++r;
        }
      }
      // words of rows that are not kept are never read (padding tiles)
      int4 a = make_int4(-1, -1, -1, -1);
      if (in[0] || in[1] || in[2] || in[3]) {
        a = reinterpret_cast<const int4*>(src)[k];
        a.x = in[0] ? a.x : -1;
        a.y = in[1] ? a.y : -1;
        a.z = in[2] ? a.z : -1;
        a.w = in[3] ? a.w : -1;
      }
      reinterpret_cast<int4*>(dst)[k] = a;
    }
    from = n4 << 2;
  }
  for (int w = from + threadIdx.x; w < words; w += kFinishThreads)
    dst[w] = kept[w / V] ? src[w] : -1;
}

}  // namespace

// scratch: H 64-bit slots, then C alive bytes (kernels/ops.py sizes it);
// out may be null (the keep mask only).
extern "C" int rt_dedup_rows(const int* bind, const unsigned char* valid,
                             int C, int V, void* scratch, int H,
                             unsigned char* keep, int* out,
                             cudaStream_t stream) {
  if (V < 1 || C < 0 || H < 2 * C || (H & (H - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  if (C == 0) return (int)cudaGetLastError();
  auto* slots = static_cast<unsigned long long*>(scratch);
  auto* alive = reinterpret_cast<unsigned char*>(slots + H);
  cudaError_t err = cudaMemsetAsync(
      scratch, 0xFF, (size_t)H * sizeof(unsigned long long) + C, stream);
  if (err != cudaSuccess) return (int)err;
  rt::launch_dedup_insert(bind, valid, C, V, slots, H, alive, stream);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dedup_finish_kernel<<<rt::grid_for(C, kFinishRows), kFinishThreads, 0,
                        stream>>>(bind, valid, alive, C, V, keep, out);
  return (int)cudaGetLastError();
}

// flash_attention: causal (optionally sliding-window) online-softmax
// attention with grouped-query heads.
//
// Replaces the Pallas kernel repro/kernels/flash_attention.py::
// _attn_kernel (wrapper repro.kernels.ops.attention).  The TPU kernel
// walks a (B*Hq, Sq/BQ, Skv/BK) grid with the KV axis innermost and
// keeps the running max, sum and accumulator in VMEM scratch between
// grid steps.  Blocks of a CUDA grid run in parallel and in no order,
// so here one block owns one (batch*head, query tile) and loops over
// the KV tiles itself, with the running statistics in registers.  The
// loop bounds skip every tile that causality or the window masks
// wholly; the tiles on the diagonal are masked element by element, as
// is the ragged end of either sequence, so every Sq, Skv works without
// padding.  Query row i sits at timeline position i + Skv - Sq, head h
// reads KV head h / (Hq / Hkv), and a row that sees no key returns 0.
//
// Two kernels, chosen by the input type:
//  * bf16: mma.sync.m16n8k16 (bf16 in, fp32 accumulate) on the tensor
//    cores.  Four warps own 16 query rows each; S = Q K^T and O += P V
//    run from shared-memory tiles (K and V row-major, V read through
//    ldmatrix.trans), P is rounded to bf16 in registers between the two
//    products, as flash attention does on this card.
//  * fp32: plain fp32 FMAs over shared-memory tiles (the tensor cores
//    would round fp32 to TF32, beyond the 2e-5 tolerance).
//
// Bound at the prefill shapes (S = 4096, D = 128): operations.  The
// causal products are 4*B*Hq*D*S^2/2 FLOP against 2 bytes per element
// of Q, K, V and O; a simple mma.sync kernel with no copy/compute
// overlap (no cp.async, TMA or wgmma yet) is expected well below the
// 989 TFLOP/s bf16 peak.
#include "common.cuh"

#include <cuda_bf16.h>
#include <math_constants.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreadsAttn = kWarps * 32;
constexpr int kBQ = 64;  // query rows per block (16 per warp)
constexpr int kBK = 64;  // keys per tile (bf16 kernel)
constexpr int kBKf = 32; // keys per tile (fp32 kernel)

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int Hq, Hkv, Sq, Skv;
  long long qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss;
  int causal, window;  // window <= 0: none
  float scale_log2;    // softmax scale * log2(e)
};

// Keys [k_lo, k_hi] that some query row of the tile [q0, q1] may see.
__device__ __forceinline__ void key_range(const Args& a, int q0, int q1,
                                          int& k_lo, int& k_hi) {
  const int off = a.Skv - a.Sq;
  k_hi = a.Skv - 1;
  if (a.causal) k_hi = min(k_hi, q1 + off);
  k_lo = 0;
  if (a.window > 0) k_lo = max(0, q0 + off - a.window + 1);
}

__device__ __forceinline__ bool visible(const Args& a, int qi, int kj) {
  const int qp = qi + a.Skv - a.Sq;
  return kj < a.Skv && (!a.causal || kj <= qp) &&
         (a.window <= 0 || kj > qp - a.window);
}

// ---------------------------------------------------------------------
// bf16 inputs: mma.sync tensor-core kernel
// ---------------------------------------------------------------------

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  uint32_t s = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// Copy rows [r0, r0 + rows) of one head (row stride `rs` elements) into a
// shared tile with row pitch P; rows past `n` are zero.  16-byte chunks.
template <int D, int P>
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* dst,
                                               const __nv_bfloat16* src,
                                               long long rs, int r0, int rows,
                                               int n) {
  constexpr int kChunks = D / 8;
  for (int i = threadIdx.x; i < rows * kChunks; i += kThreadsAttn) {
    int r = i / kChunks, c = (i % kChunks) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r0 + r < n)
      val = *reinterpret_cast<const uint4*>(src + (long long)(r0 + r) * rs + c);
    *reinterpret_cast<uint4*>(dst + r * P + c) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreadsAttn)
attn_bf16_kernel(Args a) {
  constexpr int P = D + 8;  // row pitch (bf16): conflict-free fragments
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + kBQ * P;
  __nv_bfloat16* Vs = Ks + kBK * P;

  const int bh = blockIdx.y;
  const int b = bh / a.Hq, h = bh % a.Hq;
  const int hk = h / (a.Hq / a.Hkv);
  // the longest causal tiles (the last queries) start first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int q1 = min(q0 + kBQ, a.Sq) - 1;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;

  const __nv_bfloat16* qp =
      static_cast<const __nv_bfloat16*>(a.q) + b * a.qsb + h * a.qsh;
  const __nv_bfloat16* kp =
      static_cast<const __nv_bfloat16*>(a.k) + b * a.ksb + hk * a.ksh;
  const __nv_bfloat16* vp =
      static_cast<const __nv_bfloat16*>(a.v) + b * a.vsb + hk * a.vsh;

  load_tile_bf16<D, P>(Qs, qp, a.qss, q0, kBQ, a.Sq);
  __syncthreads();
  uint32_t qf[D / 16][4];
  {
    const __nv_bfloat16* base = Qs + (warp * 16 + g) * P + 2 * t;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      qf[kk][0] = *reinterpret_cast<const uint32_t*>(base + kk * 16);
      qf[kk][1] = *reinterpret_cast<const uint32_t*>(base + 8 * P + kk * 16);
      qf[kk][2] = *reinterpret_cast<const uint32_t*>(base + kk * 16 + 8);
      qf[kk][3] =
          *reinterpret_cast<const uint32_t*>(base + 8 * P + kk * 16 + 8);
    }
  }

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};  // rows g, g + 8
  float l[2] = {0.f, 0.f};                      // this thread's share
  const int row0 = q0 + warp * 16 + g;

  int k_lo, k_hi;
  key_range(a, q0, q1, k_lo, k_hi);
  const int kt_end = k_hi < k_lo ? -1 : k_hi / kBK;
  for (int kt = k_hi < k_lo ? 0 : k_lo / kBK; kt <= kt_end; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();
    load_tile_bf16<D, P>(Ks, kp, a.kss, k0, kBK, a.Skv);
    load_tile_bf16<D, P>(Vs, vp, a.vss, k0, kBK, a.Skv);
    __syncthreads();

    float s[kBK / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const __nv_bfloat16* kb = Ks + (nt * 8 + g) * P + 2 * t;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t b0 = *reinterpret_cast<const uint32_t*>(kb + kk * 16);
        uint32_t b1 = *reinterpret_cast<const uint32_t*>(kb + kk * 16 + 8);
        mma_bf16(s[nt], qf[kk], b0, b1);
      }
    }
    // mask, scale, running max; only tiles on the edge of the visible
    // band (or of the sequences) are masked element by element
    int last = a.Skv - 1;  // the last key every query row of the tile sees
    if (a.causal) last = min(last, q0 + a.Skv - a.Sq);
    const bool edge = k0 + kBK - 1 > last ||
                      (a.window > 0 && k0 <= q1 + a.Skv - a.Sq - a.window);
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e / 2;
        float x = s[nt][e] * a.scale_log2;
        if (edge && !visible(a, row0 + 8 * r, k0 + nt * 8 + 2 * t + (e & 1)))
          x = -CUDART_INF_F;
        s[nt][e] = x;
        mx[r] = fmaxf(mx[r], x);
      }
    float alpha[2], mu[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float mn = fmaxf(m[r], mx[r]);
      mu[r] = mn == -CUDART_INF_F ? 0.f : mn;  // a row with nothing seen yet
      alpha[r] = exp2f(m[r] - mu[r]);
      m[r] = mn;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      acc[i][0] *= alpha[0];
      acc[i][1] *= alpha[0];
      acc[i][2] *= alpha[1];
      acc[i][3] *= alpha[1];
    }
    // O += P V, 16 keys per step; P from the S fragments, V by ldmatrix
#pragma unroll
    for (int kc = 0; kc < kBK / 16; ++kc) {
      float p[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[j][e] = exp2f(s[2 * kc + j][e] - mu[e / 2]);
          l[e / 2] += p[j][e];
        }
      uint32_t pa[4] = {pack_bf16(p[0][0], p[0][1]), pack_bf16(p[0][2], p[0][3]),
                        pack_bf16(p[1][0], p[1][1]), pack_bf16(p[1][2], p[1][3])};
      const int mat = lane / 8, rr = lane % 8;
      const __nv_bfloat16* vrow =
          Vs + (kc * 16 + (mat & 1) * 8 + rr) * P + (mat >> 1) * 8;
#pragma unroll
      for (int dn = 0; dn < D / 8; dn += 2) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, vrow + dn * 8);
        mma_bf16(acc[dn], pa, vb[0], vb[1]);
        mma_bf16(acc[dn + 1], pa, vb[2], vb[3]);
      }
    }
  }

  // finish the row sums across the four threads of each row and store
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = l[r] > 0.f ? 1.f / l[r] : 0.f;
  }
  __nv_bfloat16* op = static_cast<__nv_bfloat16*>(a.o) +
                      ((long long)bh * a.Sq) * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= a.Sq) continue;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
      *reinterpret_cast<__nv_bfloat162*>(op + (long long)row * D + dn * 8 +
                                         2 * t) =
          __floats2bfloat162_rn(acc[dn][2 * r] * l[r],
                                acc[dn][2 * r + 1] * l[r]);
  }
}

// ---------------------------------------------------------------------
// fp32 inputs: FMA kernel.  Thread (ty, tx) = (tid / 8, tid % 8) owns
// query rows ty*4 .. ty*4+3, score columns tx + 8j and output columns
// tx + 8j; a row's eight threads are lanes of one warp.
// ---------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreadsAttn)
attn_f32_kernel(Args a) {
  constexpr int QP = D + 1;  // padded pitches: conflict-free column reads
  constexpr int PP = kBKf + 1;
  constexpr int kCols = kBKf / 8, kOut = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* Ks = Qs + kBQ * QP;
  float* Vs = Ks + kBKf * QP;
  float* Ps = Vs + kBKf * D;

  const int bh = blockIdx.y;
  const int b = bh / a.Hq, h = bh % a.Hq;
  const int hk = h / (a.Hq / a.Hkv);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int q1 = min(q0 + kBQ, a.Sq) - 1;
  const int tx = threadIdx.x % 8, ty = threadIdx.x / 8;

  const float* qp = static_cast<const float*>(a.q) + b * a.qsb + h * a.qsh;
  const float* kp = static_cast<const float*>(a.k) + b * a.ksb + hk * a.ksh;
  const float* vp = static_cast<const float*>(a.v) + b * a.vsb + hk * a.vsh;

  for (int i = threadIdx.x; i < kBQ * D; i += kThreadsAttn) {
    int r = i / D, c = i % D;
    Qs[r * QP + c] = q0 + r < a.Sq ? qp[(long long)(q0 + r) * a.qss + c] : 0.f;
  }

  float acc[4][kOut];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kOut; ++j) acc[i][j] = 0.f;
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = -CUDART_INF_F, l[i] = 0.f;

  int k_lo, k_hi;
  key_range(a, q0, q1, k_lo, k_hi);
  const int kt_end = k_hi < k_lo ? -1 : k_hi / kBKf;
  for (int kt = k_hi < k_lo ? 0 : k_lo / kBKf; kt <= kt_end; ++kt) {
    const int k0 = kt * kBKf;
    __syncthreads();
    for (int i = threadIdx.x; i < kBKf * D; i += kThreadsAttn) {
      int r = i / D, c = i % D;
      bool in = k0 + r < a.Skv;
      Ks[r * QP + c] = in ? kp[(long long)(k0 + r) * a.kss + c] : 0.f;
      Vs[r * D + c] = in ? vp[(long long)(k0 + r) * a.vss + c] : 0.f;
    }
    __syncthreads();

    float s[4][kCols];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[kCols];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * QP + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv[j] = Ks[(tx + 8 * j) * QP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        float x = visible(a, row, k0 + tx + 8 * j) ? s[i][j] * a.scale_log2
                                                   : -CUDART_INF_F;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float mn = fmaxf(m[i], mx);
      const float mu = mn == -CUDART_INF_F ? 0.f : mn;
      const float alpha = exp2f(m[i] - mu);
      m[i] = mn;
      l[i] *= alpha;
#pragma unroll
      for (int j = 0; j < kOut; ++j) acc[i][j] *= alpha;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = exp2f(s[i][j] - mu);
        l[i] += p;
        Ps[(ty * 4 + i) * PP + tx + 8 * j] = p;
      }
    }
    __syncwarp();  // a row's P is written and read by one warp
    for (int c = 0; c < kBKf; ++c) {
      float pv[4], vv[kOut];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty * 4 + i) * PP + c];
#pragma unroll
      for (int j = 0; j < kOut; ++j) vv[j] = Vs[c * D + tx + 8 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kOut; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
    __syncwarp();
  }

  float* op = static_cast<float*>(a.o) + ((long long)bh * a.Sq) * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    li += __shfl_xor_sync(0xffffffffu, li, 4);
    const float inv = li > 0.f ? 1.f / li : 0.f;
    const int row = q0 + ty * 4 + i;
    if (row < a.Sq) {
#pragma unroll
      for (int j = 0; j < kOut; ++j)
        op[(long long)row * D + tx + 8 * j] = acc[i][j] * inv;
    }
  }
}

template <int D>
int launch(const Args& a, int B, int is_bf16, cudaStream_t stream) {
  dim3 grid((a.Sq + kBQ - 1) / kBQ, B * a.Hq);
  if (is_bf16) {
    const int smem = (kBQ + 2 * kBK) * (D + 8) * 2;
    cudaFuncSetAttribute(attn_bf16_kernel<D>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    attn_bf16_kernel<D><<<grid, kThreadsAttn, smem, stream>>>(a);
  } else {
    const int smem = ((kBQ + kBKf) * (D + 1) + kBKf * D + kBQ * (kBKf + 1)) * 4;
    cudaFuncSetAttribute(attn_f32_kernel<D>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    attn_f32_kernel<D><<<grid, kThreadsAttn, smem, stream>>>(a);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// q [B, Hq, Sq, D], k/v [B, Hkv, Skv, D] with the given element strides
// (the last dimension contiguous; bf16 rows 16-byte aligned), o a
// contiguous [B, Hq, Sq, D] of the same type.  D is 16, 32, 64 or 128.
extern "C" int rt_flash_attention(const void* q, const void* k, const void* v,
                                  void* o, int B, int Hq, int Hkv, int Sq,
                                  int Skv, int D, long long qsb, long long qsh,
                                  long long qss, long long ksb, long long ksh,
                                  long long kss, long long vsb, long long vsh,
                                  long long vss, int causal, int window,
                                  float scale, int is_bf16,
                                  cudaStream_t stream) {
  if (B == 0 || Hq == 0 || Sq == 0) return (int)cudaGetLastError();
  Args a{q,   k,   v,   o,   Hq,  Hkv, Sq,     Skv,    qsb, qsh,
         qss, ksb, ksh, kss, vsb, vsh, vss, causal, window,
         scale * 1.4426950408889634f};
  switch (D) {
    case 16: return launch<16>(a, B, is_bf16, stream);
    case 32: return launch<32>(a, B, is_bf16, stream);
    case 64: return launch<64>(a, B, is_bf16, stream);
    case 128: return launch<128>(a, B, is_bf16, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

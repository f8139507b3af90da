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
// The output is written through its own strides: the wrapper hands in
// a [B, Sq, Hq, D] buffer viewed as [B, Hq, Sq, D], so the model's
// merge of the heads is a view.
//
// Bound at the prefill shapes (S = 4096, D = 128): operations.  The
// causal products are 4*B*Hq*D*S^2/2 FLOP against 2 bytes per element
// of Q, K, V and O: about 1,400 FLOP a byte for qwen3-1.7b at 2 x 4096,
// almost five times the card's ratio of bf16 tensor rate to memory
// rate (295).  Only wgmma reaches the tensor cores' full rate, and only
// if loads never stall the products.
//
// Three kernels, chosen by the input type and head dim:
//  * bf16, D in {64, 128}: warp-specialised wgmma.  A block of 384
//    threads owns 128 query rows: 64 rows of two query heads that share
//    a KV head (Hq / Hkv even: each K/V tile then feeds both, half the
//    K/V traffic), else 128 rows of one head.  Warpgroups 0 and 1 are
//    the consumers, 64 rows each; warpgroup 2 gives up its registers
//    (setmaxnreg) and one of its threads starts the TMA copies: the Q
//    tile once, then a four-stage ring of 64-key K and V tiles, each with
//    "full" mbarriers (transaction bytes) and an "empty" mbarrier that
//    the consumers arrive on when they are done with it.  S = Q K^T is
//    wgmma from shared memory (fp32 accumulate); the online softmax runs
//    on the accumulator in registers (exp2, running max and sum); P is
//    rounded to bf16 and fed from registers as wgmma's A operand for
//    O += P V, with V read MN-major.  Each consumer pipelines its tiles:
//    tile i's S and tile i-1's P V start together and tile i's
//    softmax runs while P V is on the tensor cores; the first and last
//    tiles are peeled off so no product starts under a branch
//    (ptxas serialises those).  128-key tiles were tried and spill: the
//    pipelined consumer then needs more registers than ptxas gives it.
//    Tiles sit in shared memory with the 128B swizzle that the TMA maps
//    and the wgmma descriptors share (64-column blocks).  The TMA maps
//    are 4-D {D, S, H, B} over the strides the wrapper passes, encoded
//    on the host once per call; TMA zero-fills rows past Sq or Skv.
//    The output tile is staged through shared memory and stored as
//    16-byte rows.
//  * bf16, D in {16, 32} (and Skv = 0, which has no tile to map, or
//    a scale <= 0, which the wgmma kernel's softmax does not take):
//    mma.sync.m16n8k16 from plain shared-memory tiles, no copy/compute
//    overlap.  The 128B swizzle needs 64-element rows; these head dims
//    are on no model path and are kept for correctness.
//  * fp32: plain fp32 FMAs over shared-memory tiles (the tensor cores
//    would round fp32 to TF32, beyond the 2e-5 tolerance).
#include "common.cuh"
#include "hopper.cuh"

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
  long long qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, osb, osh, oss;
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
// bf16 inputs, D in {16, 32}: mma.sync tensor-core kernel
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
  __nv_bfloat16* op =
      static_cast<__nv_bfloat16*>(a.o) + b * a.osb + h * a.osh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= a.Sq) continue;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
      *reinterpret_cast<__nv_bfloat162*>(op + (long long)row * a.oss +
                                         dn * 8 + 2 * t) =
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

  float* op = static_cast<float*>(a.o) + b * a.osb + h * a.osh;
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
        op[(long long)row * a.oss + tx + 8 * j] = acc[i][j] * inv;
    }
  }
}

// ---------------------------------------------------------------------
// bf16 inputs, D in {64, 128}: warp-specialised wgmma + TMA kernel
// ---------------------------------------------------------------------

namespace ws {

constexpr int kBQ = 128;        // query rows per block (64 per consumer)
constexpr int kBN = 64;         // keys per K/V tile
constexpr int kStages = 4;      // K/V tiles in flight
// warps 0-7: two consumer warpgroups; warps 8-11: the producer
// warpgroup, which hands its registers to the consumers (setmaxnreg)
constexpr int kThreads = 384;
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
// setmaxnreg moves registers within the block's launch allocation (168
// a thread: 65536 / 384, rounded down to 8); asking for more hangs.
// The producer's TMA loop spills below 40.
static_assert(2 * 128 * kConsumerRegs + 128 * kProducerRegs <=
                  168 * kThreads,
              "register budget of the warp-specialised block");

// One tile is D / 64 column blocks of [rows][64] bf16 (128-byte rows,
// 128B swizzle), each block 1024-byte aligned.
template <int D>
struct Smem {
  alignas(1024) __nv_bfloat16 q[D / 64][kBQ * 64];
  alignas(1024) __nv_bfloat16 k[kStages][D / 64][kBN * 64];
  alignas(1024) __nv_bfloat16 v[kStages][D / 64][kBN * 64];
  uint64_t q_full, k_full[kStages], v_full[kStages], empty[kStages];
};

template <int D>
__device__ __forceinline__ void pv_product(float (&o)[D / 2],
                                           const uint32_t (&p)[4],
                                           uint64_t dv) {
  if constexpr (D == 128)
    hopper::wgmma_rs_m64n128k16_tnspb(o, p, dv);
  else
    hopper::wgmma_rs_m64n64k16_tnspb(o, p, dv);
}

// S = Q K^T for warpgroup wg's 64 rows: D / 16 steps of 16 columns
// (32 bytes of each 128-byte row of a column block).
static_assert(kBN == 64, "S is one m64n64 wgmma per k-step");
template <int D>
__device__ __forceinline__ void qk_product(float (&s)[kBN / 2],
                                           const __nv_bfloat16 (*q)[kBQ * 64],
                                           const __nv_bfloat16 (*k)[kBN * 64],
                                           int wg) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    hopper::wgmma_ss_m64n64k16(
        s,
        hopper::desc_sw128(&q[kk / 4][64 * 64 * wg + (kk % 4) * 16], 16,
                           1024),
        hopper::desc_sw128(&k[kk / 4][(kk % 4) * 16], 16, 1024), kk > 0);
}

// What one consumer thread needs to mask a tile: its rows row0 and
// row0 + 8, its column pair 2 t within each n-chunk, the last key every
// row of its warpgroup sees, and the key at or below which the window
// hides some of its rows.
struct Tile {
  const Args& a;
  int row0, t, last, window_edge;
};

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Online softmax of one S tile in place: s becomes exp2(s * scale -
// max) (0 where masked), m the running max (in log2 units), l the
// running sum and alpha the factor that rescales the earlier
// accumulator.  Returns whether a row's max moved (else alpha is 1).
// Only tiles on the edge of the visible band (or of the sequences) are
// masked element by element.  The scale is > 0 (the host routes any
// other to the mma.sync kernel), so the max of the raw scores gives the
// scaled max and each exponent is one FFMA.  With two consumer warps a
// scheduler little latency is hidden, so the row max keeps two partial
// chains a row.
__device__ __forceinline__ bool softmax_tile(const Tile& c,
                                             float (&s)[kBN / 2],
                                             float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], int k0) {
  const float scale = c.a.scale_log2;
  if (k0 + kBN - 1 > c.last || (c.a.window > 0 && k0 <= c.window_edge)) {
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (!visible(c.a, c.row0 + 8 * (e / 2),
                     k0 + 8 * j + 2 * c.t + (e & 1)))
          s[4 * j + e] = -CUDART_INF_F;
  }
  // two partial maxima a row: short dependency chains
  float mx[2][2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int q = 0; q < 2; ++q)
      mx[r][q] = fmaxf(s[4 * q + 2 * r], s[4 * q + 2 * r + 1]);
#pragma unroll
  for (int j = 2; j < kBN / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      mx[r][j & 1] = fmaxf(mx[r][j & 1],
                           fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
  float mu[2];
  bool moved = false;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float x = fmaxf(mx[r][0], mx[r][1]);
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
    const float mn = fmaxf(m[r], x * scale);
    mu[r] = mn == -CUDART_INF_F ? 0.f : mn;  // a row with nothing seen
    alpha[r] = fast_exp2(m[r] - mu[r]);
    moved |= mn != m[r];
    m[r] = mn;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[4 * j + e] = fast_exp2(fmaf(s[4 * j + e], scale, -mu[e / 2]));
      l[e / 2] += s[4 * j + e];
    }
  return moved;
}

template <int D, bool kPair>
__global__ void __launch_bounds__(kThreads, 1)
attn_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv, Args a) {
  constexpr int kCB = D / 64;  // 64-column blocks of a tile
  extern __shared__ unsigned char smem_raw[];
  const uint32_t pad = (1024u - (hopper::smem_addr(smem_raw) & 1023u)) & 1023u;
  Smem<D>& sm = *reinterpret_cast<Smem<D>*>(smem_raw + pad);

  // kPair: the block owns 64 query rows of two query heads that share
  // a KV head (warpgroup wg takes head h0 + wg), so each K/V tile feeds
  // both; else 128 rows of one head (warpgroup wg takes rows 64 wg ..)
  constexpr int kRows = kPair ? 64 : kBQ;
  const int heads = kPair ? a.Hq / 2 : a.Hq;
  const int b = blockIdx.y / heads;
  const int h0 = (blockIdx.y % heads) * (kPair ? 2 : 1);
  const int hk = h0 / (a.Hq / a.Hkv);
  // the longest causal tiles (the last queries) start first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  int k_lo, k_hi;
  key_range(a, q0, min(q0 + kRows, a.Sq) - 1, k_lo, k_hi);
  const int kt0 = k_hi < k_lo ? 0 : k_lo / kBN;
  const int n_tiles = k_hi < k_lo ? 0 : k_hi / kBN - kt0 + 1;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    hopper::mbar_init(&sm.q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&sm.k_full[s], 1);
      hopper::mbar_init(&sm.v_full[s], 1);
      hopper::mbar_init(&sm.empty[s], 8);  // lane 0 of each consumer warp
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 8) {
    // producer: one thread keeps the ring full
    hopper::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 256) {
      hopper::mbar_arrive_expect_tx(&sm.q_full, kBQ * D * 2);
      for (int c = 0; c < kCB; ++c)
        hopper::tma_load_4d(sm.q[c], &tq, &sm.q_full, 64 * c, q0, h0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        const int k0 = (kt0 + i) * kBN;
        hopper::mbar_wait(&sm.empty[s], ((i / kStages) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(&sm.k_full[s], kBN * D * 2);
        for (int c = 0; c < kCB; ++c)
          hopper::tma_load_4d(sm.k[s][c], &tk, &sm.k_full[s], 64 * c, k0, hk,
                              b);
        hopper::mbar_arrive_expect_tx(&sm.v_full[s], kBN * D * 2);
        for (int c = 0; c < kCB; ++c)
          hopper::tma_load_4d(sm.v[s][c], &tv, &sm.v_full[s], 64 * c, k0, hk,
                              b);
      }
    }
  } else {
    // consumers: warpgroup wg owns rows 64 * wg .. 64 * wg + 63 of the
    // Q tile (query rows r0 .. r0 + 63 of head h); this thread holds
    // rows `row0` and `row0 + 8` of the accumulators
    hopper::setmaxnreg_inc<kConsumerRegs>();
    const int wg = warp / 4, w = warp % 4, g = lane / 4, t = lane % 4;
    const int h = h0 + (kPair ? wg : 0);
    const int r0 = q0 + (kPair ? 0 : 64 * wg);
    const int r1 = min(r0 + 63, a.Sq - 1);
    const int row0 = r0 + 16 * w + g;
    const int off = a.Skv - a.Sq;
    int last = a.Skv - 1;  // the last key every row of the warpgroup sees
    if (a.causal) last = min(last, r0 + off);

    float o[D / 2];     // n-chunk j (8 columns): o[4j .. 4j + 3]
    float s[kBN / 2];   // likewise for the 64 keys of a tile
    uint32_t p[kBN / 16][4];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) s[i] = 0.f;
    float m[2] = {-CUDART_INF_F, -CUDART_INF_F};  // rows row0, row0 + 8
    float l[2] = {0.f, 0.f};                      // this thread's share
    float alpha[2];
    const Tile tile{a, row0, t, last, r1 + off - a.window};

    // Software pipeline over the KV tiles: tile i's S = Q K^T and tile
    // i-1's O += P V start together, and tile i's softmax runs
    // while the second product is on the tensor cores.  The first and
    // last tiles are peeled off, so every product starts on a
    // straight path (ptxas serialises wgmma started under branches).
    auto start_pv = [&](int st) {
#pragma unroll
      for (int kc = 0; kc < kBN / 16; ++kc)
        pv_product<D>(o, p[kc],
                      hopper::desc_sw128(&sm.v[st][0][kc * 16 * 64],
                                         kBN * 128, 1024));
    };
    // P in bf16: for keys 16 kc .. 16 kc + 15 the accumulator's n-chunks
    // 2 kc and 2 kc + 1 are exactly the A fragment of one k16 step
    auto pack_p = [&]() {
#pragma unroll
      for (int kc = 0; kc < kBN / 16; ++kc) {
        p[kc][0] = pack_bf16(s[8 * kc], s[8 * kc + 1]);
        p[kc][1] = pack_bf16(s[8 * kc + 2], s[8 * kc + 3]);
        p[kc][2] = pack_bf16(s[8 * kc + 4], s[8 * kc + 5]);
        p[kc][3] = pack_bf16(s[8 * kc + 6], s[8 * kc + 7]);
      }
    };
    hopper::mbar_wait(&sm.q_full, 0);
    if (n_tiles > 0) {
      hopper::mbar_wait(&sm.k_full[0], 0);
      hopper::fence_operand(s);
      hopper::wgmma_fence();
      qk_product<D>(s, sm.q, sm.k[0], wg);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_operand(s);
      softmax_tile(tile, s, m, l, alpha, kt0 * kBN);
      pack_p();
      for (int i = 1; i < n_tiles; ++i) {
        const int st = i % kStages, pst = (i - 1) % kStages;
        hopper::mbar_wait(&sm.k_full[st], (i / kStages) & 1);
        hopper::mbar_wait(&sm.v_full[pst], ((i - 1) / kStages) & 1);
        hopper::fence_operand(s);
        hopper::fence_operand(o);
        hopper::wgmma_fence();
        qk_product<D>(s, sm.q, sm.k[st], wg);
        hopper::wgmma_commit();
        start_pv(pst);
        hopper::wgmma_commit();
        hopper::wgmma_wait<1>();
        hopper::fence_operand(s);
        const bool moved = softmax_tile(tile, s, m, l, alpha, (kt0 + i) * kBN);
        hopper::wgmma_wait<0>();
        hopper::fence_operand(o);
        __syncwarp();
        if (lane == 0) hopper::mbar_arrive(&sm.empty[pst]);
        if (__any_sync(0xffffffffu, moved)) {  // else every alpha is 1
#pragma unroll
          for (int j = 0; j < D / 8; ++j) {
            o[4 * j] *= alpha[0];
            o[4 * j + 1] *= alpha[0];
            o[4 * j + 2] *= alpha[1];
            o[4 * j + 3] *= alpha[1];
          }
        }
        pack_p();
      }
      const int lst = (n_tiles - 1) % kStages;
      hopper::mbar_wait(&sm.v_full[lst], ((n_tiles - 1) / kStages) & 1);
      hopper::fence_operand(o);
      hopper::wgmma_fence();
      start_pv(lst);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_operand(o);
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&sm.empty[lst]);
    }

    // finish the row sums across the four threads of each row
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      l[r] = l[r] > 0.f ? 1.f / l[r] : 0.f;
    }
    // stage O in this warpgroup's own rows of the Q tile (its products
    // are done), with the swizzle, then store whole 16-byte chunks
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = 64 * wg + 16 * w + g + 8 * r;
        __nv_bfloat16* dst =
            &sm.q[j / 8][row * 64 + (((j % 8) ^ (row % 8)) * 8) + 2 * t];
        *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(
            o[4 * j + 2 * r] * l[r], o[4 * j + 2 * r + 1] * l[r]);
      }
    hopper::named_sync(1 + wg, 128);
    __nv_bfloat16* op =
        static_cast<__nv_bfloat16*>(a.o) + b * a.osb + h * a.osh;
    for (int idx = threadIdx.x % 128; idx < 64 * (D / 8); idx += 128) {
      const int lr = idx / (D / 8), row = 64 * wg + lr, cj = idx % (D / 8);
      if (r0 + lr >= a.Sq) continue;
      const uint4 val = *reinterpret_cast<const uint4*>(
          &sm.q[cj / 8][row * 64 + (((cj % 8) ^ (row % 8)) * 8)]);
      *reinterpret_cast<uint4*>(op + (long long)(r0 + lr) * a.oss + cj * 8) =
          val;
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime, so the
// library needs no -lcuda
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-D map {D, S, H, B} over bf16 rows with the given element strides,
// boxes of 64 columns x `rows` rows x `heads` heads, 128B swizzle.
bool encode_map(CUtensorMap* map, const void* base, int D, int S, int H,
                int B, long long ss, long long sh, long long sb, int rows,
                int heads) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)ss * 2, (cuuint64_t)sh * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, (cuuint32_t)heads, 1};
  const cuuint32_t one[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, one,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// returned when a tensor map cannot be encoded (no encoder found,
// or strides TMA does not take)
constexpr int kErrTensorMap = 1000;

template <int D>
int launch(const Args& a, int B, cudaStream_t stream) {
  const bool pair = (a.Hq / a.Hkv) % 2 == 0;
  const int rows = pair ? kBQ / 2 : kBQ;
  CUtensorMap tq, tk, tv;
  if (!encode_map(&tq, a.q, D, a.Sq, a.Hq, B, a.qss, a.qsh, a.qsb, rows,
                  pair ? 2 : 1) ||
      !encode_map(&tk, a.k, D, a.Skv, a.Hkv, B, a.kss, a.ksh, a.ksb, kBN, 1) ||
      !encode_map(&tv, a.v, D, a.Skv, a.Hkv, B, a.vss, a.vsh, a.vsb, kBN, 1))
    return kErrTensorMap;
  const int smem = (int)sizeof(Smem<D>) + 1024;  // + alignment slack
  dim3 grid((a.Sq + rows - 1) / rows, B * (pair ? a.Hq / 2 : a.Hq));
  auto kernel = pair ? attn_wgmma_kernel<D, true> : attn_wgmma_kernel<D, false>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  kernel<<<grid, kThreads, smem, stream>>>(tq, tk, tv, a);
  return (int)cudaGetLastError();
}

}  // namespace ws

template <int D>
int launch(const Args& a, int B, int is_bf16, cudaStream_t stream) {
  if constexpr (D == 64 || D == 128) {
    if (is_bf16 && a.Skv > 0 && a.scale_log2 > 0.f)
      return ws::launch<D>(a, B, stream);
  }
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

// q [B, Hq, Sq, D], k/v [B, Hkv, Skv, D] and o [B, Hq, Sq, D] with the
// given element strides (the last dimension contiguous; bf16 rows and
// strides 16-byte aligned).  D is 16, 32, 64 or 128.
extern "C" int rt_flash_attention(const void* q, const void* k, const void* v,
                                  void* o, int B, int Hq, int Hkv, int Sq,
                                  int Skv, int D, long long qsb, long long qsh,
                                  long long qss, long long ksb, long long ksh,
                                  long long kss, long long vsb, long long vsh,
                                  long long vss, long long osb, long long osh,
                                  long long oss, int causal, int window,
                                  float scale, int is_bf16,
                                  cudaStream_t stream) {
  if (B == 0 || Hq == 0 || Sq == 0) return (int)cudaGetLastError();
  Args a{q,   k,   v,   o,   Hq,  Hkv, Sq,  Skv, qsb,    qsh,    qss,
         ksb, ksh, kss, vsb, vsh, vss, osb, osh, oss, causal, window,
         scale * 1.4426950408889634f};
  switch (D) {
    case 16: return launch<16>(a, B, is_bf16, stream);
    case 32: return launch<32>(a, B, is_bf16, stream);
    case 64: return launch<64>(a, B, is_bf16, stream);
    case 128: return launch<128>(a, B, is_bf16, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

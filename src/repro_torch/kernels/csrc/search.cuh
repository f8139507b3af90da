// Searches of an ascending int32 key column shared by join_count.cu,
// fused_join.cu, pair_semijoin.cu and semijoin.cu, and the per-site
// table windows the join kernels of the match loop read.
//
// Staged search: every 2^shift-th key (at most kMaxSamples) is copied
// into shared memory first.  The first sample >= x brackets lo in a
// window of 2^shift keys; where the window's keys are spread (their
// value span at least a quarter of its length, as the subject and
// object ids of a property window are) lo is interpolated from the two
// bracketing samples and found by galloping from the guess: one or two
// L2 sectors instead of the ~6 of a binary search.  A window of long
// runs is binary-searched.
#pragma once

#include "common.cuh"

namespace rt {

constexpr int kMaxSamples = 8192;
constexpr int kMaxSites = 64;
constexpr int kSentinel = 2147483647;   // INT32_SENTINEL, the key pad

// Site j's table is rows [off[j], off[j] + size) of the kernel's key
// (and payload) arrays, of which the first live[j] are stored rows and
// the rest read as pads (key kSentinel, payload the caller's fill):
// the static-size, tail-masked window of the match loop, read in place.
// shift[j] / ns[j] size the staged search over the live rows.
struct Sites {
  long long off[kMaxSites];
  int live[kMaxSites];
  int shift[kMaxSites];
  int ns[kMaxSites];
};

inline int sample_shift(long long T) {
  int shift = 0;
  while ((T + (1LL << shift) - 1) >> shift > kMaxSamples) ++shift;
  return shift;
}

inline int sample_count(long long T, int shift) {
  return (int)((T + (1LL << shift) - 1) >> shift);
}

// Copy ns staged samples from device memory into shared memory,
// 16 bytes a thread (both 16-byte aligned); the caller syncs.
__device__ __forceinline__ void load_samples(int* __restrict__ dst,
                                             const int* __restrict__ src,
                                             int ns) {
  for (int j = 4 * threadIdx.x; j < ns; j += 4 * blockDim.x) {
    if (j + 3 < ns)
      *reinterpret_cast<int4*>(dst + j) =
          *reinterpret_cast<const int4*>(src + j);
    else
      for (int r = j; r < ns; ++r) dst[r] = src[r];
  }
}

// End of x's run that starts at lo (the first index with key > x).
__device__ __forceinline__ int run_end(const int* __restrict__ keys, int T,
                                       int lo, int x) {
  if (lo >= T || keys[lo] != x) return lo;
  int p = lo, step = 1;  // keys[p] == x
  while (p + step < T && keys[p + step] == x) {
    p += step;
    step <<= 1;
  }
  // keys[p] == x, and keys[p + step] > x or p + step >= T
  const int from = p + 1, to = min(p + step, T);
  return from + upper_bound(keys + from, to - from, x);
}

// lo of x in the window [b0, b1] that two staged samples bracket:
// keys[b0 - 1] = lv < x <= hv = keys[b1].
__device__ __forceinline__ int window_lower_bound(const int* __restrict__ keys,
                                                  int b0, int b1, int x,
                                                  int lv, int hv) {
  const float len = (float)(b1 - b0 + 1), span = (float)hv - (float)lv;
  if (4.f * span < len)  // long runs: a guess from the values is poor
    return b0 + lower_bound(keys + b0, b1 - b0, x);
  int g = b0 - 1 + (int)(((float)x - (float)lv) / span * len);
  g = min(max(g, b0), b1);
  if (keys[g] < x) {  // lo in (g, b1]: gallop right
    int p = g, step = 1;
    while (p + step < b1 && keys[p + step] < x) {
      p += step;
      step <<= 1;
    }
    const int to = min(p + step, b1);
    return p + 1 + lower_bound(keys + p + 1, to - p - 1, x);
  }
  int q = g, step = 1;  // lo in [b0, g]: gallop left
  while (q - step >= b0 && keys[q - step] >= x) {
    q -= step;
    step <<= 1;
  }
  const int from = max(q - step + 1, b0);
  return from + lower_bound(keys + from, q - from, x);
}

// lo of x in keys[0, T), samples[j] = keys[j << shift] for the ns =
// ceil(T / 2^shift) samples.  The first sample >= x, js, brackets lo:
// the key at (js - 1) << shift is < x and the key at js << shift is
// >= x, so lo lies in the 2^shift positions after the former.
__device__ __forceinline__ int staged_lower_bound(const int* __restrict__ keys,
                                                  int T, int shift,
                                                  const int* samples, int ns,
                                                  int x) {
  const int js = lower_bound(samples, ns, x);
  if (js == ns && js > 0) {  // past the last sample: the column's tail
    const int base = ((js - 1) << shift) + 1;
    return base + lower_bound(keys + base, T - base, x);
  }
  if (js > 0)
    return window_lower_bound(keys, ((js - 1) << shift) + 1, js << shift, x,
                              samples[js - 1], samples[js]);
  return 0;  // x <= keys[0] (or the column is empty)
}

// x occurs in keys[0, T), with the samples of staged_lower_bound: lo
// and one compare (a sample equal to x answers with no load at all).
__device__ __forceinline__ bool staged_contains(const int* __restrict__ keys,
                                                int T, int shift,
                                                const int* samples, int ns,
                                                int x) {
  const int js = lower_bound(samples, ns, x);
  if (js < ns && samples[js] == x) return true;
  if (js == 0) return false;  // x < keys[0] (or the column is empty)
  int lo;  // as staged_lower_bound, from the same js
  if (js == ns) {
    const int base = ((js - 1) << shift) + 1;
    lo = base + lower_bound(keys + base, T - base, x);
  } else {
    lo = window_lower_bound(keys, ((js - 1) << shift) + 1, js << shift, x,
                            samples[js - 1], samples[js]);
  }
  return lo < T && keys[lo] == x;
}

// End of x's run from its lo, staged: gallop lo+1, lo+2, lo+4: a short
// run ends within the sector; a run past lo + 8 ends at the first key
// > x after the first sample > x, jh (jh >= 1: samples[0] = keys[0]
// <= x).
__device__ __forceinline__ int staged_run_end(const int* __restrict__ keys,
                                              int T, int shift,
                                              const int* samples, int ns,
                                              int lo, int x) {
  if (lo >= T || keys[lo] != x) return lo;
  int p = lo, step = 1;  // keys[p] == x
  while (step <= 4 && p + step < T && keys[p + step] == x) {
    p += step;
    step <<= 1;
  }
  if (p + step < T && keys[p + step] == x) {
    const int jh = upper_bound(samples, ns, x);
    const int base = ((jh - 1) << shift) + 1;
    const int end = jh == ns ? T : (jh << shift);
    return base + upper_bound(keys + base, end - base, x);
  }
  const int to = min(p + step, T);
  return p + 1 + upper_bound(keys + p + 1, to - p - 1, x);
}

// Gather samples[j * kMaxSamples + k] = keys[off[j] + (k << shift[j])]
// for the k < ns[j] samples of each of the m sites' live rows; thread
// t of the launch handles sample t (t < m * kMaxSamples).
__device__ __forceinline__ void gather_site_sample(
    long long t, const int* __restrict__ keys, const Sites& sites, int m,
    int* __restrict__ samples) {
  const int j = (int)(t / kMaxSamples), k = (int)(t % kMaxSamples);
  if (j < m && k < sites.ns[j])
    samples[t] = keys[sites.off[j] + ((long long)k << sites.shift[j])];
}

// Sites from the caller's host arrays of m offsets and live counts,
// with the staged search's sample spacing over each site's live rows.
inline Sites make_sites(const long long* off, const int* live, int m) {
  Sites s{};
  for (int j = 0; j < m; ++j) {
    s.off[j] = off[j];
    s.live[j] = live[j];
    s.shift[j] = sample_shift(live[j]);
    s.ns[j] = sample_count(live[j], s.shift[j]);
  }
  return s;
}

// SMs of the current device, asked once per process (one card).
inline int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

}  // namespace rt

// Shared helpers of the feature kernels (window_agg, fused_window,
// preagg_window, last_join).
//
// Ring layout, as in featurestore/table.py: values (K, C, V) f32,
// ts (K, C) f32, total (K,) i32. Event p of a key sits at slot p mod C and
// the retained events are [max(0, total - C), total). Every kernel runs one
// thread block per request; the block loads its own key, total and request
// time, derives the window's position interval [p0, p1) and reduces only
// the positions inside it.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace rt {

// Sentinels of empty min/max, as in the plain versions (never INFINITY).
constexpr float kNegSentinel = -3.0e38f;
constexpr float kPosSentinel = 3.0e38f;

constexpr int kThreads = 128;   // threads per block (one block per request)
constexpr int kMaxCols = 64;    // value columns one launch may read
constexpr int kMaxSpecs = 16;   // window specs of one fused launch

// Field bits, in the order of FUSED_FIELDS.
enum : int {
  kSum = 1, kSumsq = 2, kCount = 4, kMin = 8, kMax = 16, kFirst = 32,
  kLast = 64,
};

// Column indices read from the V value columns, passed by value.
struct ColMap {
  int n;
  int idx[kMaxCols];
};

// Floor modulo: CUDA's % truncates toward zero, the plain version floors.
__device__ __forceinline__ int floor_mod(int a, int m) {
  int r = a % m;
  return r < 0 ? r + m : r;
}

// Global position held by ring slot s of a key with `tot` events.
__device__ __forceinline__ int slot_position(int s, int tot, int C) {
  return tot - C + floor_mod(s - tot, C);
}

struct SumOp {
  template <typename T>
  __device__ __forceinline__ T operator()(T a, T b) const { return a + b; }
};
struct MinOp {
  __device__ __forceinline__ float operator()(float a, float b) const {
    return fminf(a, b);
  }
  __device__ __forceinline__ int operator()(int a, int b) const {
    return a < b ? a : b;
  }
};
struct MaxOp {
  __device__ __forceinline__ float operator()(float a, float b) const {
    return fmaxf(a, b);
  }
  __device__ __forceinline__ int operator()(int a, int b) const {
    return a > b ? a : b;
  }
};

// Reduce one value per thread over the block; every thread gets the
// result. `scratch` holds one slot per warp. Safe to call back to back.
template <typename T, typename Op>
__device__ T block_reduce(T v, Op op, T* scratch) {
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_down_sync(0xffffffffu, v, o));
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  __syncthreads();              // the previous call's readers are done
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  T r = scratch[0];
  const int nw = (blockDim.x + 31) >> 5;
  for (int w = 1; w < nw; ++w) r = op(r, scratch[w]);
  return r;
}

// Window upper bound p1 and RANGE lower-bound count of one request.
// Counts over the retained slots of the key: after = #{ts > t},
// in_range = #{t - range <= ts <= t}; the caller reduces them.
__device__ __forceinline__ void count_ts(const float* __restrict__ ts_row,
                                         int tot, int C, float t,
                                         float t_lo, bool want_range,
                                         int* after, int* in_range) {
  const int lo = tot - C > 0 ? tot - C : 0;
  int a = 0, r = 0;
  for (int s = threadIdx.x; s < C; s += blockDim.x) {
    const int p = slot_position(s, tot, C);
    if (p >= lo) {
      const float x = ts_row[s];
      a += x > t;
      if (want_range) r += (x >= t_lo) & (x <= t);
    }
  }
  *after = a;
  *in_range = r;
}

// Window bounds of one request: p1 (shared by every frame of a request)
// and p0 for a ROWS frame (rows >= 0) or a RANGE frame (rows < 0).
// Must be called by the whole block with block-uniform arguments.
__device__ __forceinline__ int upper_bound_p1(const float* __restrict__ ts_row,
                                              int tot, int C, float t,
                                              bool assume_latest, int* iscr) {
  if (assume_latest) return tot;
  int after, unused;
  count_ts(ts_row, tot, C, t, 0.f, false, &after, &unused);
  return tot - block_reduce(after, SumOp(), iscr);
}

__device__ __forceinline__ int lower_bound_p0(const float* __restrict__ ts_row,
                                              int tot, int C, float t, int p1,
                                              int rows, float range,
                                              int* iscr) {
  int p0;
  if (rows >= 0) {
    p0 = p1 - rows;
  } else {
    int unused, in_range;
    count_ts(ts_row, tot, C, t, t - range, true, &unused, &in_range);
    p0 = p1 - block_reduce(in_range, SumOp(), iscr);
  }
  p0 = max(p0, 0);
  return max(p0, tot - C);
}

}  // namespace rt

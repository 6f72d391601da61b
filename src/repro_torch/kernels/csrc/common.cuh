// Shared definitions of the feature kernels (window_agg, fused_window,
// preagg_window, last_join).
//
// Ring layout, as in featurestore/table.py: values (K, C, V) f32,
// ts (K, C) f32, total (K,) i32. Event p of a key sits at slot p mod C and
// the retained events are [max(0, total - C), total). Every feature kernel
// answers one request with one warp (warp_window.cuh): the warp loads its
// own key, total and request time, derives the window's position interval
// [p0, p1) and reads only the positions inside it.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace rt {

// Sentinels of empty min/max, as in the plain versions (never INFINITY).
constexpr float kNegSentinel = -3.0e38f;
constexpr float kPosSentinel = 3.0e38f;

// The widths of one launch's static table (warp_window.cuh); a wrapper
// splits a wider call into launches of one slice each.
constexpr int kMaxCols = 64;    // value columns one launch reads
constexpr int kMaxSpecs = 16;   // window specs of one fused launch

// Field bits, in the order of FUSED_FIELDS.
enum : int {
  kSum = 1, kSumsq = 2, kCount = 4, kMin = 8, kMax = 16, kFirst = 32,
  kLast = 64,
};

// Floor modulo: CUDA's % truncates toward zero, the plain version floors.
__device__ __forceinline__ int floor_mod(int a, int m) {
  int r = a % m;
  return r < 0 ? r + m : r;
}

}  // namespace rt

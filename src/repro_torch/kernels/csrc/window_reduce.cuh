// The per-window reduction shared by window_agg and fused_window: one
// thread block reduces the positions [p0, p1) of one request's ring for
// every requested column and field.
#pragma once

#include <limits.h>

#include "common.cuh"

namespace rt {

// Output row of one (request, spec): each pointer is at the row's first
// column, or null where the field is not materialised.
struct WindowOut {
  float* sum;
  float* sumsq;
  float* count;   // one value
  float* min;
  float* max;
  float* first;
  float* last;
};

// `vals` is the key's (C, V) block, `mask_row` its (C,) WHERE mask or null.
// `want` holds the fields this window computes; a field in `present` but
// not in `want` is written as 0 (the fused spec-table contract).
__device__ inline void reduce_window(const float* __restrict__ vals,
                              const uint8_t* __restrict__ mask_row,
                              int C, int V, const ColMap& cols,
                              int p0, int p1, int want, int present,
                              const WindowOut& o, float* fscr, int* iscr) {
  const int n = p1 > p0 ? p1 - p0 : 0;
  // count and the first/last positions inside the window
  int cnt = n, pf = p0, pl = p1 - 1;
  if (mask_row != nullptr) {
    int c = 0, f = INT_MAX, l = -1;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int p = p0 + i;
      if (mask_row[floor_mod(p, C)]) {
        ++c;
        f = min(f, p);
        l = max(l, p);
      }
    }
    cnt = block_reduce(c, SumOp(), iscr);
    if (want & kFirst) pf = block_reduce(f, MinOp(), iscr);
    if (want & kLast) pl = block_reduce(l, MaxOp(), iscr);
  }
  if (threadIdx.x == 0 && (present & kCount))
    o.count[0] = (want & kCount) ? static_cast<float>(cnt) : 0.f;

  const bool moments = (want & (kSum | kSumsq | kMin | kMax)) != 0;
  for (int j = 0; j < cols.n; ++j) {
    const int cj = cols.idx[j];
    float s = 0.f, q = 0.f, mn = kPosSentinel, mx = kNegSentinel;
    if (moments) {
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const int slot = floor_mod(p0 + i, C);
        if (mask_row == nullptr || mask_row[slot]) {
          const float x = vals[static_cast<size_t>(slot) * V + cj];
          s += x;
          q += __fmul_rn(x, x);
          mn = fminf(mn, x);
          mx = fmaxf(mx, x);
        }
      }
      if (want & kSum) s = block_reduce(s, SumOp(), fscr);
      if (want & kSumsq) q = block_reduce(q, SumOp(), fscr);
      if (want & kMin) mn = block_reduce(mn, MinOp(), fscr);
      if (want & kMax) mx = block_reduce(mx, MaxOp(), fscr);
    }
    if (threadIdx.x == 0) {
      if (present & kSum) o.sum[j] = (want & kSum) ? s : 0.f;
      if (present & kSumsq) o.sumsq[j] = (want & kSumsq) ? q : 0.f;
      if (present & kMin) o.min[j] = (want & kMin) ? mn : 0.f;
      if (present & kMax) o.max[j] = (want & kMax) ? mx : 0.f;
      // first/last are exact selects by position, not sums
      if (present & kFirst)
        o.first[j] = ((want & kFirst) && cnt > 0)
            ? vals[static_cast<size_t>(floor_mod(pf, C)) * V + cj] : 0.f;
      if (present & kLast)
        o.last[j] = ((want & kLast) && cnt > 0)
            ? vals[static_cast<size_t>(floor_mod(pl, C)) * V + cj] : 0.f;
    }
  }
}

}  // namespace rt

// preagg_window: the pre-aggregated window of paper Eq. 2. The window
// [p0, p1) splits into a head [p0, b0*BSZ), the full buckets [b0, b1) read
// from the (K, NB, V) partial tiers and the (K, NB) count tier, and a tail
// [b1*BSZ, p1), with b0 = ceil(p0 / BSZ) and b1 = floor(p1 / BSZ); without
// a full bucket the head alone is [p0, p1). Head and tail each span less
// than one bucket. Fields: sum/sumsq/count/min/max.
//
// Replaces the TPU kernel preagg_window_pallas (src/repro/kernels/
// preagg_window.py). The TPU kernel DMAs two bucket-aligned raw slabs into
// VMEM while it reduces the tiers; here one block per request reads the
// buckets and the head/tail positions straight from device memory
// (cp.async or TMA staging is later work).
//
// Bound on an H100 (3.35 TB/s): per request the ts row only for RANGE or
// point-in-time frames, (b1 - b0) bucket entries of each requested tier,
// fewer than 2 BSZ raw rows and the outputs. The main path's call
// (fraud_scored w1, B=500, ROWS 10, one column) moves 30,576 bytes: a
// 0.009 us bound, against 3.22 us measured per launch (H100 SXM, 700 W;
// chip_smoke.py). Latency-bound. Written to be right; making it fast is
// later work.
#include "common.cuh"

namespace rt {

struct Tiers {
  const float* sum;     // (K, NB, V)
  const float* sumsq;
  const float* min;
  const float* max;
  const float* count;   // (K, NB)
};

struct PreaggOut {
  float* sum;
  float* sumsq;
  float* count;
  float* min;
  float* max;
};

__global__ void __launch_bounds__(kThreads) preagg_window_kernel(
    const float* __restrict__ values, const float* __restrict__ ts,
    const int* __restrict__ total, Tiers tiers,
    const int* __restrict__ req_key, const float* __restrict__ req_ts,
    int K, int C, int V, int NB, int BSZ, ColMap cols, int rows,
    float range, int assume_latest, int fields, PreaggOut out) {
  __shared__ float fscr[32];
  __shared__ int iscr[32];
  const int b = blockIdx.x;
  const int key = req_key[b];
  const bool key_ok = key >= 0 && key < K;
  const int tot = key_ok ? total[key] : 0;
  const float t = req_ts[b];
  const size_t kbase = key_ok ? static_cast<size_t>(key) * C : 0;
  const size_t bbase = key_ok ? static_cast<size_t>(key) * NB : 0;
  const float* ts_row = ts + kbase;
  const int p1 = upper_bound_p1(ts_row, tot, C, t, assume_latest != 0, iscr);
  const int p0 = lower_bound_p0(ts_row, tot, C, t, p1, rows, range, iscr);

  const int b0 = (p0 + BSZ - 1) / BSZ;     // p0 >= 0
  const int b1 = p1 / BSZ;
  const bool has_buckets = b0 <= b1;
  const int head_end = has_buckets ? b0 * BSZ : p1;
  const int tail_start = has_buckets ? b1 * BSZ : p1;
  const int n_bk = has_buckets ? b1 - b0 : 0;
  const int n_head = head_end > p0 ? head_end - p0 : 0;
  const int n_tail = p1 > tail_start ? p1 - tail_start : 0;
  const int n_items = n_bk + n_head + n_tail;

  // item i: a full bucket (i < n_bk), else a raw head or tail position
  auto raw_pos = [&](int i) {
    const int r = i - n_bk;
    return r < n_head ? p0 + r : tail_start + (r - n_head);
  };

  if (fields & kCount) {
    float c = 0.f;
    for (int i = threadIdx.x; i < n_bk; i += blockDim.x)
      c += tiers.count[bbase + (b0 + i) % NB];
    c = block_reduce(c, SumOp(), fscr);
    if (threadIdx.x == 0)
      out.count[b] = c + static_cast<float>(n_head + n_tail);
  }
  for (int j = 0; j < cols.n; ++j) {
    const int cj = cols.idx[j];
    float s = 0.f, q = 0.f, mn = kPosSentinel, mx = kNegSentinel;
    for (int i = threadIdx.x; i < n_items; i += blockDim.x) {
      if (i < n_bk) {
        const size_t e = (bbase + (b0 + i) % NB) * V + cj;
        if (fields & kSum) s += tiers.sum[e];
        if (fields & kSumsq) q += tiers.sumsq[e];
        if (fields & kMin) mn = fminf(mn, tiers.min[e]);
        if (fields & kMax) mx = fmaxf(mx, tiers.max[e]);
      } else {
        const int slot = floor_mod(raw_pos(i), C);
        const float x = values[(kbase + slot) * V + cj];
        s += x;
        q += __fmul_rn(x, x);
        mn = fminf(mn, x);
        mx = fmaxf(mx, x);
      }
    }
    const size_t o = static_cast<size_t>(b) * cols.n + j;
    if (fields & kSum) {
      s = block_reduce(s, SumOp(), fscr);
      if (threadIdx.x == 0) out.sum[o] = s;
    }
    if (fields & kSumsq) {
      q = block_reduce(q, SumOp(), fscr);
      if (threadIdx.x == 0) out.sumsq[o] = q;
    }
    if (fields & kMin) {
      mn = block_reduce(mn, MinOp(), fscr);
      if (threadIdx.x == 0) out.min[o] = mn;
    }
    if (fields & kMax) {
      mx = block_reduce(mx, MaxOp(), fscr);
      if (threadIdx.x == 0) out.max[o] = mx;
    }
  }
}

}  // namespace rt

extern "C" int preagg_window_launch(
    const float* values, const float* ts, const int* total,
    const float* pa_sum, const float* pa_sumsq, const float* pa_min,
    const float* pa_max, const float* pa_count, const int* req_key,
    const float* req_ts, int B, int K, int C, int V, int NB, int BSZ,
    const int* cols, int n_cols, int rows, float range, int assume_latest,
    int fields, float* o_sum, float* o_sumsq, float* o_count, float* o_min,
    float* o_max, void* stream) {
  if (B <= 0 || n_cols < 0 || n_cols > rt::kMaxCols || BSZ <= 0 ||
      NB * BSZ != C)
    return static_cast<int>(cudaErrorInvalidValue);
  rt::ColMap cm;
  cm.n = n_cols;
  for (int i = 0; i < n_cols; ++i) cm.idx[i] = cols[i];
  rt::Tiers tiers{pa_sum, pa_sumsq, pa_min, pa_max, pa_count};
  rt::PreaggOut out{o_sum, o_sumsq, o_count, o_min, o_max};
  rt::preagg_window_kernel<<<B, rt::kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      values, ts, total, tiers, req_key, req_ts, K, C, V, NB, BSZ, cm,
      rows, range, assume_latest, fields, out);
  return static_cast<int>(cudaGetLastError());
}

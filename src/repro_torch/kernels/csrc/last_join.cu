// last_join: point-in-time LAST JOIN row lookup. Per request, the latest
// retained right-table row with ts <= req_ts (the newest row under
// assume_latest) and its col_idx columns; unmatched requests get a zero
// row, matched = 0 and a zero selected ts.
//
// Replaces the TPU kernel last_join_pallas (src/repro/kernels/
// last_join.py). Per-key timestamps are non-decreasing, so the qualifying
// positions are [max(0, total - C), p1) and the selected row is p1 - 1:
// one block per request counts the timestamps newer than the request (none
// under assume_latest) and reads one row, where the TPU kernel stages and
// reduces the whole (C, V) block.
//
// Bound on an H100 (3.35 TB/s): per request one row of V_out values, the
// ts row for point-in-time lookups (4 C bytes) and the outputs. The main
// path's call (fraud_scored's merchants join, B=500, two columns, online)
// moves 18,500 bytes: a 0.006 us bound, against 2.37 us measured per
// launch (H100 SXM, 700 W; chip_smoke.py). Latency-bound. Written to be
// right; making it fast is later work.
#include "common.cuh"

namespace rt {

__global__ void __launch_bounds__(kThreads) last_join_kernel(
    const float* __restrict__ values, const float* __restrict__ ts,
    const int* __restrict__ total, const int* __restrict__ req_key,
    const float* __restrict__ req_ts, int K, int C, int V, ColMap cols,
    int assume_latest, float* __restrict__ row,
    uint8_t* __restrict__ matched, float* __restrict__ sel_ts) {
  __shared__ int iscr[32];
  const int b = blockIdx.x;
  const int key = req_key[b];
  const bool key_ok = key >= 0 && key < K;
  const int tot = key_ok ? total[key] : 0;
  const size_t kbase = key_ok ? static_cast<size_t>(key) * C : 0;
  const int p1 = upper_bound_p1(ts + kbase, tot, C, req_ts[b],
                                assume_latest != 0, iscr);
  const int lo = tot - C > 0 ? tot - C : 0;
  const bool ok = p1 > lo;
  const size_t slot = kbase + (ok ? floor_mod(p1 - 1, C) : 0);
  for (int j = threadIdx.x; j < cols.n; j += blockDim.x)
    row[static_cast<size_t>(b) * cols.n + j] =
        ok ? values[slot * V + cols.idx[j]] : 0.f;
  if (threadIdx.x == 0) {
    matched[b] = ok ? 1 : 0;
    if (sel_ts != nullptr) sel_ts[b] = ok ? ts[slot] : 0.f;
  }
}

}  // namespace rt

extern "C" int last_join_launch(
    const float* values, const float* ts, const int* total,
    const int* req_key, const float* req_ts, int B, int K, int C, int V,
    const int* cols, int n_cols, int assume_latest, float* row,
    uint8_t* matched, float* sel_ts, void* stream) {
  if (B <= 0 || n_cols <= 0 || n_cols > rt::kMaxCols)
    return static_cast<int>(cudaErrorInvalidValue);
  rt::ColMap cm;
  cm.n = n_cols;
  for (int i = 0; i < n_cols; ++i) cm.idx[i] = cols[i];
  rt::last_join_kernel<<<B, rt::kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      values, ts, total, req_key, req_ts, K, C, V, cm, assume_latest, row,
      matched, sel_ts);
  return static_cast<int>(cudaGetLastError());
}

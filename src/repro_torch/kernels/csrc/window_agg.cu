// window_agg: one ROWS or RANGE window frame per request, with the
// optional WHERE mask, reduced to sum/sumsq/count/min/max/first/last.
//
// Replaces the TPU kernel window_agg_pallas (src/repro/kernels/
// window_agg.py). The TPU kernel stages the key's whole (C, V) block in
// VMEM; at C = 4096 that is more shared memory than a Hopper block can
// have, so this kernel stages nothing: the block counts timestamps for the
// window bounds (only when the frame needs them) and then walks just the
// positions [p0, p1) the bounds select, with block reductions.
//
// Bound on an H100 (3.35 TB/s): bytes moved = per request the ts row when
// a bound needs it (4 C), the window's values (4 n V_out), the mask bytes
// and the outputs. The main path's call (serve_features w1, B=500, ROWS 10,
// two columns of the batch's rows) moves 57,152 bytes: a 0.017 us bound,
// against 3.95 us measured per launch (H100 SXM, 700 W; chip_smoke.py).
// The launch is latency-bound. This version is written to be right;
// making it fast is later work.
#include "window_reduce.cuh"

namespace rt {

__global__ void __launch_bounds__(kThreads) window_agg_kernel(
    const float* __restrict__ values, const float* __restrict__ ts,
    const int* __restrict__ total, const int* __restrict__ req_key,
    const float* __restrict__ req_ts, const uint8_t* __restrict__ mask,
    int K, int C, int V, ColMap cols, int rows, float range,
    int assume_latest, int fields, WindowOut out) {
  __shared__ float fscr[32];
  __shared__ int iscr[32];
  const int b = blockIdx.x;
  const int key = req_key[b];
  // an index outside the table reads as a key with no events
  const bool key_ok = key >= 0 && key < K;
  const int tot = key_ok ? total[key] : 0;
  const float t = req_ts[b];
  const size_t kbase = key_ok ? static_cast<size_t>(key) * C : 0;
  const float* ts_row = ts + kbase;
  const int p1 = upper_bound_p1(ts_row, tot, C, t, assume_latest != 0, iscr);
  const int p0 = lower_bound_p0(ts_row, tot, C, t, p1, rows, range, iscr);
  const size_t o = static_cast<size_t>(b) * cols.n;
  WindowOut row{out.sum ? out.sum + o : nullptr,
                out.sumsq ? out.sumsq + o : nullptr,
                out.count ? out.count + b : nullptr,
                out.min ? out.min + o : nullptr,
                out.max ? out.max + o : nullptr,
                out.first ? out.first + o : nullptr,
                out.last ? out.last + o : nullptr};
  reduce_window(values + kbase * V, mask ? mask + kbase : nullptr, C, V,
                cols, p0, p1, fields, fields, row, fscr, iscr);
}

}  // namespace rt

extern "C" int window_agg_launch(
    const float* values, const float* ts, const int* total,
    const int* req_key, const float* req_ts, const uint8_t* mask,
    int B, int K, int C, int V, const int* cols, int n_cols, int rows,
    float range, int assume_latest, int fields, float* o_sum,
    float* o_sumsq, float* o_count, float* o_min, float* o_max,
    float* o_first, float* o_last, void* stream) {
  if (B <= 0 || n_cols < 0 || n_cols > rt::kMaxCols)
    return static_cast<int>(cudaErrorInvalidValue);
  rt::ColMap cm;
  cm.n = n_cols;
  for (int i = 0; i < n_cols; ++i) cm.idx[i] = cols[i];
  rt::WindowOut out{o_sum, o_sumsq, o_count, o_min, o_max, o_first, o_last};
  rt::window_agg_kernel<<<B, rt::kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      values, ts, total, req_key, req_ts, mask, K, C, V, cm, rows, range,
      assume_latest, fields, out);
  return static_cast<int>(cudaGetLastError());
}

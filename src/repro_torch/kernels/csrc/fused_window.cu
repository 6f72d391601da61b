// fused_window: S static window frames of one deployment answered in one
// launch. The upper bound p1 depends only on the request time, so it is
// computed once per request; each spec then gets its own p0 and field
// mask. Fields a spec did not request are written as 0.
//
// Replaces the TPU kernel fused_window_pallas (src/repro/kernels/
// fused_window.py). As in window_agg.cu, nothing is staged in shared
// memory: one block per request walks only the positions each frame
// selects.
//
// Bound on an H100 (3.35 TB/s): per request the ts row when a bound needs
// it plus the widest frame's window values and the (S, V_out) outputs. The
// main path's call (serve_features_last, B=500, ROWS 10 and 100 over four
// columns of the batch's rows) moves 764,928 bytes: a 0.23 us bound,
// against 10.6 us measured per launch (H100 SXM, 700 W; chip_smoke.py).
// Latency-bound. Written to be right; making it fast is later work.
#include "window_reduce.cuh"

namespace rt {

struct SpecTable {
  int n;
  int rows[kMaxSpecs];     // ROWS frame length, or -1 for a RANGE frame
  float range[kMaxSpecs];  // RANGE frame span
  int fields[kMaxSpecs];   // field bits the spec requested
};

__global__ void __launch_bounds__(kThreads) fused_window_kernel(
    const float* __restrict__ values, const float* __restrict__ ts,
    const int* __restrict__ total, const int* __restrict__ req_key,
    const float* __restrict__ req_ts, const uint8_t* __restrict__ mask,
    int K, int C, int V, ColMap cols, SpecTable specs, int assume_latest,
    int present, WindowOut out) {
  __shared__ float fscr[32];
  __shared__ int iscr[32];
  const int b = blockIdx.x;
  const int key = req_key[b];
  const bool key_ok = key >= 0 && key < K;
  const int tot = key_ok ? total[key] : 0;
  const float t = req_ts[b];
  const size_t kbase = key_ok ? static_cast<size_t>(key) * C : 0;
  const float* ts_row = ts + kbase;
  const int p1 = upper_bound_p1(ts_row, tot, C, t, assume_latest != 0, iscr);
  const int S = specs.n;
  for (int s = 0; s < S; ++s) {
    const int p0 = lower_bound_p0(ts_row, tot, C, t, p1, specs.rows[s],
                                  specs.range[s], iscr);
    const size_t o = (static_cast<size_t>(b) * S + s) * cols.n;
    const size_t oc = static_cast<size_t>(b) * S + s;
    WindowOut row{out.sum ? out.sum + o : nullptr,
                  out.sumsq ? out.sumsq + o : nullptr,
                  out.count ? out.count + oc : nullptr,
                  out.min ? out.min + o : nullptr,
                  out.max ? out.max + o : nullptr,
                  out.first ? out.first + o : nullptr,
                  out.last ? out.last + o : nullptr};
    reduce_window(values + kbase * V, mask ? mask + kbase : nullptr, C, V,
                  cols, p0, p1, specs.fields[s], present, row, fscr, iscr);
  }
}

}  // namespace rt

extern "C" int fused_window_launch(
    const float* values, const float* ts, const int* total,
    const int* req_key, const float* req_ts, const uint8_t* mask,
    int B, int K, int C, int V, const int* cols, int n_cols, int n_specs,
    const int* spec_rows, const float* spec_range, const int* spec_fields,
    int assume_latest, int present, float* o_sum, float* o_sumsq,
    float* o_count, float* o_min, float* o_max, float* o_first,
    float* o_last, void* stream) {
  if (B <= 0 || n_cols < 0 || n_cols > rt::kMaxCols || n_specs <= 0 ||
      n_specs > rt::kMaxSpecs)
    return static_cast<int>(cudaErrorInvalidValue);
  rt::ColMap cm;
  cm.n = n_cols;
  for (int i = 0; i < n_cols; ++i) cm.idx[i] = cols[i];
  rt::SpecTable st;
  st.n = n_specs;
  for (int s = 0; s < n_specs; ++s) {
    st.rows[s] = spec_rows[s];
    st.range[s] = spec_range[s];
    st.fields[s] = spec_fields[s];
  }
  rt::WindowOut out{o_sum, o_sumsq, o_count, o_min, o_max, o_first, o_last};
  rt::fused_window_kernel<<<B, rt::kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      values, ts, total, req_key, req_ts, mask, K, C, V, cm, st,
      assume_latest, present, out);
  return static_cast<int>(cudaGetLastError());
}

// last_join: point-in-time LAST JOIN row lookup. Per request, the latest
// retained right-table row with ts <= req_ts (the newest row under
// assume_latest) and its col_idx columns; unmatched requests get a zero
// row, matched = 0 and a zero selected ts.
//
// Replaces the TPU kernel last_join_pallas (src/repro/kernels/
// last_join.py), which stages and reduces the key's whole (C, V) block.
// Per-key timestamps are non-decreasing (ingest enforces it), so the
// qualifying positions are [max(0, total - C), p1) and the selected row is
// p1 - 1, with p1 = total - #{retained ts > req_ts}: the count the plain
// version makes.
//
// Design: one warp per request, kWarps requests a block (warp_window.cuh),
// no block barrier, no shared memory. Online (assume_latest) a request is
// one chain of dependent loads: req_key -> total -> (row, ts). Point in
// time adds one coalesced pass over the retained ts slots (16-byte loads,
// count_ts_warp, no per-slot modulo) and one butterfly of five shuffles
// before the row. The lanes stride the columns (lane l reads columns l and
// l + 32 of the launch), and lane 0 loads the selected ts in the same
// round. A launch reads at most kMaxCols columns; the wrapper splits wider
// calls into launches of one column slice each, writing through the row
// stride oC (matched and the ts come with the first slice).
//
// Bound on an H100 (3.35 TB/s): per request one row of V_out values, the
// ts row for point-in-time lookups (4 C bytes) and the outputs. The main
// path's call (fraud_scored's merchants join, B=500, two columns, online)
// moves 18,500 bytes: a 0.006 us bound, against 2.3 us measured per
// launch (2.5 us for the block-per-request kernel this replaced, in the
// same run); the point-in-time call of query_offline's first batch
// (B=1024, merchants ring C=64) takes 3.2 us (3.6 us). Both from
// chip_smoke.py --calls on an NVIDIA H100 80GB HBM3 at 700 W. The chain
// of three dependent loads is the floor.
#include "warp_window.cuh"

namespace rt {

__global__ void __launch_bounds__(32 * kWarps) last_join_kernel(
    const float* __restrict__ values, const float* __restrict__ ts,
    const int* __restrict__ total, const int* __restrict__ req_key,
    const float* __restrict__ req_ts, const int* __restrict__ tab, int B,
    int K, int C, int V, int ncols, int oC, int assume_latest, int vec_ts,
    float* __restrict__ row, uint8_t* __restrict__ matched,
    float* __restrict__ sel_ts) {
  const int b = warp_request();
  if (b >= B) return;                 // the whole warp: no request here
  const int lane = threadIdx.x & 31;
  const LaneCols lc = lane_cols(tab);   // the columns, two a lane
  const int key = req_key[b];
  const bool key_ok = key >= 0 && key < K;
  const int tot = key_ok ? total[key] : 0;
  const float t = req_ts[b];
  const size_t kbase = key_ok ? static_cast<size_t>(key) * C : 0;

  int p1 = tot;
  if (!assume_latest) {
    const float t_lo[1] = {0.f};
    const bool on[1] = {false};
    int unused[1] = {0}, after = 0;
    count_ts_warp(ts + kbase, min(tot, C), vec_ts != 0, t, t_lo, on, after,
                  unused);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      after += __shfl_xor_sync(kFullMask, after, o);
    p1 = tot - after;
  }
  const bool ok = p1 > max(tot - C, 0);
  const size_t slot = kbase + (ok ? floor_mod(p1 - 1, C) : 0);
  const float* vrow = values + slot * V;

  // one round: the row's columns and the selected ts
  const float v_lo = (ok && lane < ncols) ? __ldg(vrow + lc.lo) : 0.f;
  const float v_hi = (ok && lane + 32 < ncols) ? __ldg(vrow + lc.hi) : 0.f;
  const float s_ts = (ok && lane == 0 && sel_ts != nullptr)
                         ? __ldg(ts + slot) : 0.f;
  float* const orow = row + static_cast<size_t>(b) * oC;
  if (lane < ncols) orow[lane] = v_lo;
  if (lane + 32 < ncols) orow[lane + 32] = v_hi;
  if (lane == 0) {
    if (matched != nullptr) matched[b] = ok ? 1 : 0;
    if (sel_ts != nullptr) sel_ts[b] = s_ts;
  }
}

}  // namespace rt

extern "C" int last_join_launch(
    const float* values, const float* ts, const int* total,
    const int* req_key, const float* req_ts, const int* table, int B, int K,
    int C, int V, int n_cols, int out_cols, int assume_latest, float* row,
    uint8_t* matched, float* sel_ts, void* stream) {
  if (B <= 0 || n_cols <= 0 || n_cols > rt::kMaxCols || out_cols < n_cols)
    return static_cast<int>(cudaErrorInvalidValue);
  const int vec_ts = C % 4 == 0 && rt::aligned16(ts);
  const int blocks = (B + rt::kWarps - 1) / rt::kWarps;
  rt::last_join_kernel<<<blocks, 32 * rt::kWarps, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      values, ts, total, req_key, req_ts, table, B, K, C, V, n_cols,
      out_cols, assume_latest, vec_ts, row, matched, sel_ts);
  return static_cast<int>(cudaGetLastError());
}

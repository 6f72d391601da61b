// window_agg: one ROWS or RANGE window frame per request, with the
// optional WHERE mask, reduced to sum/sumsq/count/min/max/first/last.
//
// Replaces the TPU kernel window_agg_pallas (src/repro/kernels/
// window_agg.py). The TPU kernel stages the key's whole (C, V) block in
// VMEM; here a request reads only the ts slots its bounds need and the
// rows of its window, straight from device memory.
//
// Design: one warp per request, kWarps requests a block (warp_window.cuh
// says why), no block barrier, no shared memory; fused_window's design for
// a single spec:
//   1. Bounds once per request. With assume_latest and a ROWS frame (the
//      main path) no ts is read. Otherwise one coalesced pass over the
//      retained ts slots (16-byte loads, count_ts_warp) counts ts > t for
//      p1 and t - range <= ts <= t for a RANGE frame's p0, and one
//      butterfly reduces both counts. No per-slot modulo.
//   2. One walk over [p0, p1) per chunk of kChunkCols = 4 columns (a
//      chunk of 8 took 156 registers and was slower at every main-path
//      call: PERF.md, PR 16): lane l takes positions p1 - 1 - l - 32k, in
//      groups of up to kGroup steps, every row of a group loaded before any
//      is used. A chunk's columns come from one 16-byte load per row where
//      they lie in one aligned group of four (load_row), else one load per
//      column (the main path's (B, C, 2) rows). ptxas for sm_90a: 95
//      registers a thread, no spills.
//   3. count is p1 - p0, or with a WHERE mask the popcount of a ballot per
//      step. first/last: without a mask the rows at p0 and p1 - 1, loaded
//      before the walk; with a mask the rows at the warp min/max of the
//      kept positions, loaded before the moments' butterfly, which hides
//      the load.
//   4. One reduce-scatter butterfly per chunk (warp_window.cuh): 16
//      shuffles for the 16 moments (sum, sumsq, min, max of four columns),
//      none under a branch; lanes 2i and 2i + 1 end with moment i, the
//      even lane writes it, and the odd lanes 1-7 and 9-15 write first and
//      last.
// Kept from the plain version: the +-3.0e38 sentinels of empty min/max,
// __fmul_rn for sumsq (no contraction into an FMA), floor-mod slots,
// 64-bit offsets, out-of-range keys read as empty rings, unrequested
// fields not materialised. A launch reads at most kMaxCols columns; the
// wrapper splits wider calls into launches of one column slice each, and
// a launch writes its slice through the outputs' row stride oC.
//
// Bound on an H100 (3.35 TB/s): bytes moved = per request the ts row when
// a bound needs it (4 C), the window's values (4 n V_out), the mask bytes
// and the outputs. The main path's call (serve_features w1, B=500, ROWS 10,
// two columns of the batch's rows, online) moves 57,152 bytes: a
// 0.017 us bound, against 3.0 us measured per launch (4.0 us for the
// block-per-request kernel this replaced, in the same run); the
// point-in-time call of query_offline's first batch (B=1024, full rings
// of 1024 ts slots) takes 4.1 us (7.2 us). Both from chip_smoke.py
// --calls on an NVIDIA H100 80GB HBM3 at 700 W. The request's chain of
// dependent loads (req_key, total, then the window) is the real floor.
#include <limits.h>

#include "warp_window.cuh"

namespace rt {

// Output base pointers, each (B, oC) at the launch's first column, count
// (B,); null where the field is not materialised.
struct WindowOut {
  float* sum;
  float* sumsq;
  float* count;
  float* min;
  float* max;
  float* first;
  float* last;
};

// Walk steps whose rows are loaded together. At the main path's calls 2
// measured level with 4 online and faster point in time, with 95 registers
// against 112 (PERF.md, PR 16).
constexpr int kGroup = 2;

__global__ void __launch_bounds__(32 * kWarps) window_agg_kernel(
    const float* __restrict__ values, const float* __restrict__ ts,
    const int* __restrict__ total, const int* __restrict__ req_key,
    const float* __restrict__ req_ts, const uint8_t* __restrict__ mask,
    const int* __restrict__ tab, int B, int K, int C, int V, int ncols,
    int oC, int rows, float range, int assume_latest, int fields, int vec,
    int vec_ts, WindowOut out) {
  const int b = warp_request();
  if (b >= B) return;                 // the whole warp: no request here
  const int lane = threadIdx.x & 31;
  const LaneCols lc = lane_cols(tab);   // the columns, two a lane
  const int key = req_key[b];
  const bool key_ok = key >= 0 && key < K;
  const int tot = key_ok ? total[key] : 0;
  const float t = req_ts[b];
  const size_t kbase = key_ok ? static_cast<size_t>(key) * C : 0;

  // ---- 1. bounds ---------------------------------------------------------
  int p1 = tot, in_range = 0;
  if (!assume_latest || rows < 0) {
    const float t_lo[1] = {t - range};
    const bool on[1] = {rows < 0};
    int cnt[1] = {0}, after = 0;
    count_ts_warp(ts + kbase, min(tot, C), vec_ts != 0, t, t_lo, on, after,
                  cnt);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      after += __shfl_xor_sync(kFullMask, after, o);
      cnt[0] += __shfl_xor_sync(kFullMask, cnt[0], o);
    }
    if (!assume_latest) p1 = tot - after;
    in_range = cnt[0];
  }
  const int p0 = max(max(rows >= 0 ? p1 - rows : p1 - in_range, 0), tot - C);
  const int n = p1 - p0;                // 0 <= n <= C
  // slot of p1 - 1; position p1 - 1 - d (0 <= d < n) is at top - d, wrapped
  const int top = floor_mod(p1 - 1, C);

  // ---- 2-4. one walk per chunk of columns --------------------------------
  const bool moments = (fields & (kSum | kSumsq | kMin | kMax)) != 0;
  const float* vrow0 = values + kbase * V;
  const uint8_t* mrow = mask != nullptr ? mask + kbase : nullptr;
  const int steps = (moments || mrow != nullptr) ? (n + 31) >> 5 : 0;
  // lane l: moment l / 2 = field l / 8 of column ce (even lanes write it);
  // odd lanes below 16 write first (lanes 1-7) or last (9-15) of column ce
  const int ce = (lane >> 1) & (kChunkCols - 1);
  const int fe = lane >> 3;
  const int fbit = fe == 0 ? kSum : fe == 1 ? kSumsq : fe == 2 ? kMin : kMax;
  float* const fout = fe == 0 ? out.sum : fe == 1 ? out.sumsq
                      : fe == 2 ? out.min : out.max;
  const bool odd = (lane & 1) != 0;
  const bool is_last = fe == 1;
  const int lbit = is_last ? kLast : kFirst;
  float* const lout = is_last ? out.last : out.first;
  const bool fl_lane = odd && lane < 16 && (fields & lbit);

  const int nch = n_col_chunks(ncols);
  for (int ch = 0; ch < nch; ++ch) {
    const Chunk chunk = chunk_of(lc, ncols, ch, vec != 0);
    const bool mine = ce < chunk.nc;
    const int col_e = select(chunk.ci, ce);

    // without a mask first/last sit at p0 and p1 - 1: load them now,
    // under the walk
    float fl_v = 0.f;
    if (mrow == nullptr && fl_lane && mine && n > 0)
      fl_v = __ldg(vrow0 + static_cast<size_t>(
                               wrap_slot(top - (is_last ? 0 : n - 1), C)) * V
                   + col_e);

    float acc[4 * kChunkCols];        // [field][column]
#pragma unroll
    for (int c = 0; c < kChunkCols; ++c) {
      acc[c] = 0.f;
      acc[kChunkCols + c] = 0.f;
      acc[2 * kChunkCols + c] = kPosSentinel;
      acc[3 * kChunkCols + c] = kNegSentinel;
    }
    int cnt = 0, fp = INT_MAX, lp = -1;

    in_groups<kGroup>(steps, [&](auto group, int k) {
      constexpr int U = decltype(group)::value;
      float4 row[U];
      uint8_t m[U];
      bool live[U];
      int pos[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {            // every load first
        const int d = lane + 32 * (k + u);
        pos[u] = p1 - 1 - d;
        live[u] = d < n;
        const size_t slot =
            live[u] ? static_cast<size_t>(wrap_slot(top - d, C)) : 0;
        row[u] = load_row(vrow0 + slot * V, chunk, live[u] && moments);
        m[u] = (live[u] && mrow != nullptr) ? mrow[slot] : 1;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const bool keep = live[u] && m[u] != 0;
#pragma unroll
        for (int c = 0; c < kChunkCols; ++c) {
          const float v = pick(row[u], chunk.k[c]);
          float& mn = acc[2 * kChunkCols + c];
          float& mx = acc[3 * kChunkCols + c];
          acc[c] += keep ? v : 0.f;
          acc[kChunkCols + c] += keep ? __fmul_rn(v, v) : 0.f;
          mn = keep ? fminf(mn, v) : mn;
          mx = keep ? fmaxf(mx, v) : mx;
        }
        if (mrow != nullptr) {
          cnt += __popc(__ballot_sync(kFullMask, keep));
          fp = keep ? pos[u] : fp;             // positions fall: the min
          lp = keep ? max(lp, pos[u]) : lp;
        }
      }
    });

    if (mrow == nullptr) {
      cnt = n;
    } else {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        fp = min(fp, __shfl_xor_sync(kFullMask, fp, o));
        lp = max(lp, __shfl_xor_sync(kFullMask, lp, o));
      }
      if (fl_lane && mine && cnt > 0)
        fl_v = __ldg(vrow0 + static_cast<size_t>(wrap_slot(
                                 top - (p1 - 1 - (is_last ? lp : fp)), C)) * V
                     + col_e);
    }
    // lanes 2i and 2i + 1 end with value i: field i / 4 of column i % 4
    const float red = moments ? reduce_scatter<kChunkCols>(acc) : 0.f;

    if (mine) {
      const size_t o = static_cast<size_t>(b) * oC + ch * kChunkCols + ce;
      if (!odd && (fields & fbit)) fout[o] = red;
      if (fl_lane) lout[o] = cnt > 0 ? fl_v : 0.f;
    }
    if (ch == 0 && lane == 0 && (fields & kCount))
      out.count[b] = static_cast<float>(cnt);
  }
}

}  // namespace rt

extern "C" int window_agg_launch(
    const float* values, const float* ts, const int* total,
    const int* req_key, const float* req_ts, const uint8_t* mask,
    const int* table, int B, int K, int C, int V, int n_cols, int out_cols,
    int rows, float range, int assume_latest, int fields, float* o_sum,
    float* o_sumsq, float* o_count, float* o_min, float* o_max,
    float* o_first, float* o_last, void* stream) {
  if (B <= 0 || n_cols < 0 || n_cols > rt::kMaxCols || out_cols < n_cols)
    return static_cast<int>(cudaErrorInvalidValue);
  const int vec = V % 4 == 0 && rt::aligned16(values);
  const int vec_ts = C % 4 == 0 && rt::aligned16(ts);
  rt::WindowOut out{o_sum, o_sumsq, o_count, o_min, o_max, o_first, o_last};
  const int blocks = (B + rt::kWarps - 1) / rt::kWarps;
  rt::window_agg_kernel<<<blocks, 32 * rt::kWarps, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      values, ts, total, req_key, req_ts, mask, table, B, K, C, V, n_cols,
      out_cols, rows, range, assume_latest, fields, vec, vec_ts, out);
  return static_cast<int>(cudaGetLastError());
}

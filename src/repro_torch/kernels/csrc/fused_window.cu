// fused_window: S static window frames of one deployment answered in one
// launch. Every frame of a request ends at the same p1 (it depends only on
// the request time); spec s starts at its own p0_s and asks for its own
// fields. Fields a spec did not request are written as 0.
//
// Replaces the TPU kernel fused_window_pallas (src/repro/kernels/
// fused_window.py).
//
// Design: one warp per request, kWarps = 2 requests a block
// (warp_window.cuh says why), no block barrier, no shared memory.
//   1. Bounds once per request. With assume_latest and ROWS frames only
//      (the main path) no ts is read. Otherwise one coalesced pass over the
//      retained slots of the ts row (16-byte loads) counts ts > t for p1
//      and t - range <= ts <= t for every RANGE spec at once, and one
//      interleaved butterfly reduces all the counts. Lane s keeps spec s's
//      p0.
//   2. One walk over the widest frame [min p0_s, p1) of a chunk of
//      kChunkSpecs specs x kChunkCols columns: lane l takes positions
//      p1 - 1 - l - 32k, two steps' rows loaded before any is used (a load
//      consumed at once would cost each row a full round trip); a position
//      counts for spec s iff p >= p0_s (every frame ends at p1). A chunk's
//      columns come from one 16-byte load per row where they lie in one
//      aligned group of four (the main path's (B, C, 4) rows), and every
//      (spec, column, moment) accumulator stays in registers. Larger
//      tables loop over chunks of 2 specs x 4 columns (32 moments; ptxas
//      for sm_90a: 128 registers a thread, no spills, as chip_smoke.py
//      prints them).
//   3. count is p1 - p0_s, or with a WHERE mask the popcount of a ballot
//      per step; first/last are the rows at p0_s and p1 - 1, loaded before
//      the walk, or with a mask at the warp min/max of the kept positions.
//   4. One reduce-scatter butterfly per chunk (warp_window.cuh): 31
//      shuffles for the 32 moments, none under a branch, and lane l ends
//      with moment l / 8 of element l % 8, which it writes; lanes 0-15
//      write first and last.
// Kept from the plain version: the +-3.0e38 sentinels of empty min/max,
// __fmul_rn for sumsq (no contraction into an FMA), floor-mod slots,
// 64-bit offsets (K*C*V = 2^32 at the smoke's shape), out-of-range keys
// read as empty rings. A launch takes at most kMaxSpecs specs and kMaxCols
// columns; the wrapper splits a wider table into launches of one slice
// each, and a launch writes its slice through the outputs' strides (oS
// specs, oC columns).
//
// Bound on an H100 (3.35 TB/s): per request the ts row when a bound needs
// it plus the widest frame's window values and the (S, V_out) outputs. The
// main path's call (serve_features_last, B=500, ROWS 10 and 100 over four
// columns of the batch's rows) moves 764,928 bytes, a 0.23 us bound,
// against 4.5 us measured per launch (10.6 us for the block-per-request
// kernel this replaced, in the same run; chip_smoke.py on an NVIDIA H100
// 80GB HBM3 at 700 W). The request's chain of dependent loads (req_key,
// total, then the window) is the real floor: last_join, the same chain,
// takes 2.5 us there.
#include <limits.h>

#include "warp_window.cuh"

namespace rt {

// Output base pointers, each (B, S, n_cols) or count (B, S); null where
// the field is not materialised.
struct FusedOut {
  float* sum;
  float* sumsq;
  float* count;
  float* min;
  float* max;
  float* first;
  float* last;
};

constexpr int kChunkSpecs = 2;                      // specs a walk covers
constexpr int kElems = kChunkSpecs * kChunkCols;    // (spec, column) pairs

__global__ void __launch_bounds__(32 * kWarps) fused_window_kernel(
    const float* __restrict__ values, const float* __restrict__ ts,
    const int* __restrict__ total, const int* __restrict__ req_key,
    const float* __restrict__ req_ts, const uint8_t* __restrict__ mask,
    const int* __restrict__ tab, int B, int K, int C, int V, int ncols,
    int S, int oS, int oC, int any_range, int assume_latest, int present,
    int vec, int vec_ts, FusedOut out) {
  const int b = warp_request();
  if (b >= B) return;                 // the whole warp: no request here
  const int lane = threadIdx.x & 31;
  // the table, one word a lane: spec lane % 16, columns lane and lane + 32
  const int l16 = lane & (kMaxSpecs - 1);
  const int my_rows = __ldg(tab + kTabRows + l16);
  const int my_fields = __ldg(tab + kTabFields + l16);
  const float my_range = __int_as_float(__ldg(tab + kTabRange + l16));
  const LaneCols lc = lane_cols(tab);
  const int key = req_key[b];
  const bool key_ok = key >= 0 && key < K;
  const int tot = key_ok ? total[key] : 0;
  const float t = req_ts[b];
  const size_t kbase = key_ok ? static_cast<size_t>(key) * C : 0;

  // ---- 1. bounds: p1, and p0 of spec `lane` in lane `lane` -------------
  int p1 = tot, my_in_range = 0;
  if (!assume_latest || any_range) {
    float t_lo[kMaxSpecs];
    bool on[kMaxSpecs];
    int in_range[kMaxSpecs];
#pragma unroll
    for (int s = 0; s < kMaxSpecs; ++s) {
      on[s] = s < S && __shfl_sync(kFullMask, my_rows, s) < 0;
      t_lo[s] = t - __shfl_sync(kFullMask, my_range, s);
      in_range[s] = 0;
    }
    int after = 0;
    count_ts_warp(ts + kbase, min(tot, C), vec_ts != 0, t, t_lo, on, after,
                  in_range);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {       // no shuffle under a branch
      after += __shfl_xor_sync(kFullMask, after, o);
#pragma unroll
      for (int s = 0; s < kMaxSpecs; ++s)
        in_range[s] += __shfl_xor_sync(kFullMask, in_range[s], o);
    }
    if (!assume_latest) p1 = tot - after;
    my_in_range = select(in_range, lane);
  }
  int my_p0 = p1;
  if (lane < S)
    my_p0 = max(max(my_rows >= 0 ? p1 - my_rows : p1 - my_in_range, 0),
                tot - C);
  // slot of p1 - 1; position p1 - 1 - d (0 <= d < C) is at top - d, wrapped
  const int top = floor_mod(p1 - 1, C);

  // ---- 2-4. one walk per chunk of specs and columns --------------------
  // Lane l writes element e = l & 7 (spec j = e / 4 of the chunk, column
  // c = e % 4): moment field l / 8 (sum, sumsq, min, max), which the
  // reduce-scatter leaves in lane l, and for l < 16 first (l < 8) or last.
  const float* vrow0 = values + kbase * V;
  const uint8_t* mrow = mask != nullptr ? mask + kbase : nullptr;
  const int nch = n_col_chunks(ncols);
  const int e = lane & (kElems - 1);
  const int je = e / kChunkCols, ce = e % kChunkCols;
  const int fe = lane / kElems;                    // this lane's field
  const int fbit = fe == 0 ? kSum : fe == 1 ? kSumsq : fe == 2 ? kMin : kMax;
  float* const fout = fe == 0 ? out.sum : fe == 1 ? out.sumsq
                      : fe == 2 ? out.min : out.max;
  const bool is_last = fe == 1;                    // lanes 8..15
  const int lbit = is_last ? kLast : kFirst;
  float* const lout = is_last ? out.last : out.first;
  for (int sc0 = 0; sc0 < S; sc0 += kChunkSpecs) {
    int p0[kChunkSpecs], want[kChunkSpecs];
    int lo = p1;
#pragma unroll
    for (int j = 0; j < kChunkSpecs; ++j) {
      const bool on = sc0 + j < S;
      const int p = __shfl_sync(kFullMask, my_p0, on ? sc0 + j : 0);
      const int w = __shfl_sync(kFullMask, my_fields, on ? sc0 + j : 0);
      p0[j] = on ? p : p1;             // an absent spec: an empty frame
      want[j] = on ? w : 0;
      lo = min(lo, p0[j]);
    }
    const int steps = (p1 - lo + 31) >> 5;            // warp-uniform
    const int p0e = select(p0, je);
    const int want_e = select(want, je);

    for (int ch = 0; ch < nch; ++ch) {
      const Chunk chunk = chunk_of(lc, ncols, ch, vec != 0);
      const bool mine = sc0 + je < S && ce < chunk.nc;   // a real element
      const int col_e = select(chunk.ci, ce);
      const bool fl_lane = lane < 2 * kElems && mine && (want_e & lbit);

      // without a mask first/last sit at p0_s and p1 - 1: load them now,
      // under the walk
      float fl_v = 0.f;
      if (mrow == nullptr && fl_lane && p1 > p0e)
        fl_v = __ldg(vrow0 + static_cast<size_t>(wrap_slot(
                                 top - (is_last ? 0 : p1 - 1 - p0e), C)) * V
                     + col_e);

      float acc[4 * kElems];           // [field][element]
#pragma unroll
      for (int i = 0; i < kElems; ++i) {
        acc[i] = 0.f;
        acc[kElems + i] = 0.f;
        acc[2 * kElems + i] = kPosSentinel;
        acc[3 * kElems + i] = kNegSentinel;
      }
      int cnt[kChunkSpecs], fp[kChunkSpecs];
#pragma unroll
      for (int j = 0; j < kChunkSpecs; ++j) {
        cnt[j] = 0;
        fp[j] = INT_MAX;
      }
      int lp = -1;

      in_groups<2>(steps, [&](auto group, int k) {
        constexpr int U = decltype(group)::value;
        float4 row[U];
        uint8_t m[U];
        bool live[U];
        int pos[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {            // every load first
          const int d = lane + 32 * (k + u);
          pos[u] = p1 - 1 - d;
          live[u] = pos[u] >= lo;
          const size_t slot =
              live[u] ? static_cast<size_t>(wrap_slot(top - d, C)) : 0;
          row[u] = load_row(vrow0 + slot * V, chunk, live[u]);
          m[u] = (live[u] && mrow != nullptr) ? mrow[slot] : 1;
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const bool keep = live[u] && m[u] != 0;
#pragma unroll
          for (int j = 0; j < kChunkSpecs; ++j) {
            const bool in = keep && pos[u] >= p0[j];
#pragma unroll
            for (int c = 0; c < kChunkCols; ++c) {
              const int i = j * kChunkCols + c;
              const float v = pick(row[u], chunk.k[c]);
              acc[i] += in ? v : 0.f;
              acc[kElems + i] += in ? __fmul_rn(v, v) : 0.f;
              acc[2 * kElems + i] = in ? fminf(acc[2 * kElems + i], v)
                                       : acc[2 * kElems + i];
              acc[3 * kElems + i] = in ? fmaxf(acc[3 * kElems + i], v)
                                       : acc[3 * kElems + i];
            }
            if (mrow != nullptr) {
              cnt[j] += __popc(__ballot_sync(kFullMask, in));
              fp[j] = in ? pos[u] : fp[j];   // positions fall: the min
            }
          }
          if (mrow != nullptr && keep) lp = max(lp, pos[u]);
        }
      });

      const float red = reduce_scatter<kElems>(acc);
      if (mrow == nullptr) {
#pragma unroll
        for (int j = 0; j < kChunkSpecs; ++j) cnt[j] = p1 - p0[j];
      } else {
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
          for (int j = 0; j < kChunkSpecs; ++j)
            fp[j] = min(fp[j], __shfl_xor_sync(kFullMask, fp[j], o));
          lp = max(lp, __shfl_xor_sync(kFullMask, lp, o));
        }
      }
      const int cnt_e = select(cnt, je);
      // with a mask: the last kept position of the widest frame is every
      // spec's last (a spec that starts past it keeps nothing)
      if (mrow != nullptr && fl_lane && cnt_e > 0)
        fl_v = __ldg(vrow0 + static_cast<size_t>(wrap_slot(
                                 top - (p1 - 1 - (is_last ? lp
                                                          : select(fp, je))),
                                 C)) * V + col_e);

      if (mine) {
        const size_t o = (static_cast<size_t>(b) * oS + sc0 + je) * oC
                         + ch * kChunkCols + ce;
        if (present & fbit) fout[o] = (want_e & fbit) ? red : 0.f;
        if (lane < 2 * kElems && (present & lbit))
          lout[o] = ((want_e & lbit) && cnt_e > 0) ? fl_v : 0.f;
      }
      if (ch == 0 && (present & kCount) && lane < kChunkSpecs &&
          sc0 + lane < S) {
        const int w = select(want, lane);
        out.count[static_cast<size_t>(b) * oS + sc0 + lane] =
            (w & kCount) ? static_cast<float>(select(cnt, lane)) : 0.f;
      }
    }
  }
}

}  // namespace rt

extern "C" int fused_window_launch(
    const float* values, const float* ts, const int* total,
    const int* req_key, const float* req_ts, const uint8_t* mask,
    const int* table, int B, int K, int C, int V, int n_cols, int n_specs,
    int out_specs, int out_cols, int any_range, int assume_latest,
    int present, float* o_sum,
    float* o_sumsq, float* o_count, float* o_min, float* o_max,
    float* o_first, float* o_last, void* stream) {
  if (B <= 0 || n_cols < 0 || n_cols > rt::kMaxCols || n_specs <= 0 ||
      n_specs > rt::kMaxSpecs || out_specs < n_specs || out_cols < n_cols)
    return static_cast<int>(cudaErrorInvalidValue);
  const int vec = V % 4 == 0 && rt::aligned16(values);
  const int vec_ts = C % 4 == 0 && rt::aligned16(ts);
  rt::FusedOut out{o_sum, o_sumsq, o_count, o_min, o_max, o_first, o_last};
  const int blocks = (B + rt::kWarps - 1) / rt::kWarps;
  rt::fused_window_kernel<<<blocks, 32 * rt::kWarps, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      values, ts, total, req_key, req_ts, mask, table, B, K, C, V, n_cols,
      n_specs, out_specs, out_cols, any_range, assume_latest, present, vec,
      vec_ts, out);
  return static_cast<int>(cudaGetLastError());
}

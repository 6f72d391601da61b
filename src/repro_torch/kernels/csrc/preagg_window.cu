// preagg_window: the pre-aggregated window of paper Eq. 2. The window
// [p0, p1) splits into a head [p0, b0*BSZ), the full buckets [b0, b1) read
// from the (K, NB, V) partial tiers and the (K, NB) count tier, and a tail
// [b1*BSZ, p1), with b0 = ceil(p0 / BSZ) and b1 = floor(p1 / BSZ); without
// a full bucket the head alone is [p0, p1). Head and tail each span less
// than one bucket. Fields: sum/sumsq/count/min/max.
//
// Replaces the TPU kernel preagg_window_pallas (src/repro/kernels/
// preagg_window.py). The TPU kernel DMAs two bucket-aligned raw slabs into
// VMEM while it reduces the tiers; here the request's items are read
// straight from device memory.
//
// Design: one warp per request, kWarps = 2 requests a block
// (warp_window.cuh), no block barrier, no shared memory. The bounds
// need the ts row only for RANGE or point-in-time frames: then one
// coalesced pass counts ts > t and t - range <= ts <= t together. The
// request's items are its full buckets and its head and tail positions:
// lane l loads bucket l's requested tier rows and count, then walks raw
// positions l, l + 32, ... in groups of up to four steps, every row of a
// group loaded before any is used, and adds its bucket last, so buckets
// and raw rows share one round trip. A ROWS 100 window over buckets of 64
// has no full bucket in 28 of 64 alignments, and then 100 raw positions:
// four steps, one group. A chunk of up to four columns comes from one
// 16-byte load per row where the columns lie in one aligned group of four
// (every column set of the smoke's V = 4 tables). count is the bucket
// counts plus the raw positions; one reduce-scatter butterfly
// (warp_window.cuh) reduces the chunk's 16 moments, leaving moment i in
// lanes 2i and 2i + 1. ptxas for sm_90a: 128 registers a thread, no spills.
// A launch reads at most kMaxCols columns; the wrapper splits wider calls
// into launches of one column slice each, writing through the row stride
// oC (the counts come with the first slice).
//
// Bound on an H100 (3.35 TB/s): per request the ts row only for RANGE or
// point-in-time frames, (b1 - b0) bucket entries of each requested tier,
// fewer than 2 BSZ raw rows and the outputs: 30,576 bytes (a 0.009 us
// bound) at fraud_scored w1 (B=500, ROWS 10, one column). Measured per
// launch at the main path's three calls (chip_smoke.py on an NVIDIA H100
// 80GB HBM3 at 700 W): 3.4 us at fraud_scored w1, 3.5 us at fraud_scored
// w2 and 3.6 us at serve_features w2 (ROWS 100), against 3.4, 3.7 and
// 6.3 us for the block-per-request kernel this replaced, in the same run.
// The request's chain of dependent loads (req_key, total, then the items)
// is the real floor.
#include "warp_window.cuh"

namespace rt {

struct Tiers {
  const float* sum;     // (K, NB, V)
  const float* sumsq;
  const float* min;
  const float* max;
  const float* count;   // (K, NB)
};

struct PreaggOut {
  float* sum;           // (B, oC), at the launch's first column
  float* sumsq;
  float* count;         // (B,)
  float* min;
  float* max;
};

__global__ void __launch_bounds__(32 * kWarps) preagg_window_kernel(
    const float* __restrict__ values, const float* __restrict__ ts,
    const int* __restrict__ total, Tiers tiers,
    const int* __restrict__ req_key, const float* __restrict__ req_ts,
    const int* __restrict__ tab, int B, int K, int C, int V, int NB,
    int BSZ, int ncols, int oC, int rows, float range, int assume_latest,
    int fields, int vec, int vec_ts, PreaggOut out) {
  const int b = warp_request();
  if (b >= B) return;                 // the whole warp: no request here
  const int lane = threadIdx.x & 31;
  const LaneCols lc = lane_cols(tab);   // the columns, two a lane
  const int key = req_key[b];
  const bool key_ok = key >= 0 && key < K;
  const int tot = key_ok ? total[key] : 0;
  const float t = req_ts[b];
  const size_t kbase = key_ok ? static_cast<size_t>(key) * C : 0;
  const size_t bbase = key_ok ? static_cast<size_t>(key) * NB : 0;

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

  const int b0 = (p0 + BSZ - 1) / BSZ;     // p0 >= 0
  const int b1 = p1 / BSZ;
  const bool has_buckets = b0 <= b1;
  const int head_end = has_buckets ? b0 * BSZ : p1;
  const int tail_start = has_buckets ? b1 * BSZ : p1;
  const int n_bk = has_buckets ? b1 - b0 : 0;
  const int n_head = head_end > p0 ? head_end - p0 : 0;
  const int n_tail = p1 > tail_start ? p1 - tail_start : 0;
  const int n_raw = n_head + n_tail;
  const int raw_steps = (n_raw + 31) >> 5;            // warp-uniform
  const bool want_raw = (fields & (kSum | kSumsq | kMin | kMax)) != 0;
  // one division each; items step from these by less than NB (buckets)
  // or C (raw positions)
  const int bslot0 = b0 % NB;
  const int head_slot = floor_mod(p0, C), tail_slot = floor_mod(tail_start, C);

  const int nch = n_col_chunks(ncols);
  for (int ch = 0; ch < nch; ++ch) {
    const Chunk chunk = chunk_of(lc, ncols, ch, vec != 0);
    const bool count_here = ch == 0 && (fields & kCount);

    float acc[4 * kChunkCols];        // [field][column]
#pragma unroll
    for (int c = 0; c < kChunkCols; ++c) {
      acc[c] = 0.f;
      acc[kChunkCols + c] = 0.f;
      acc[2 * kChunkCols + c] = kPosSentinel;
      acc[3 * kChunkCols + c] = kNegSentinel;
    }
    float cnt = 0.f;

    // A bucket's tier rows and count: loaded before the raw walk so the
    // two share one round trip, added after it.
    struct Bucket {
      float4 x, q, n, m;
      float c;
      bool live;
    };
    auto load_bucket = [&](int i) {
      Bucket bk;
      bk.live = i < n_bk;
      const size_t row = bbase + (bk.live ? wrap_slot(bslot0 + i, NB) : 0);
      bk.x = load_row(tiers.sum + row * V, chunk, bk.live && (fields & kSum));
      bk.q = load_row(tiers.sumsq + row * V, chunk,
                      bk.live && (fields & kSumsq));
      bk.n = load_row(tiers.min + row * V, chunk, bk.live && (fields & kMin));
      bk.m = load_row(tiers.max + row * V, chunk, bk.live && (fields & kMax));
      bk.c = (bk.live && count_here) ? __ldg(tiers.count + row) : 0.f;
      return bk;
    };
    auto add_bucket = [&](const Bucket& bk) {
#pragma unroll
      for (int c = 0; c < kChunkCols; ++c) {
        const int kc = chunk.k[c];
        float& mn = acc[2 * kChunkCols + c];
        float& mx = acc[3 * kChunkCols + c];
        acc[c] += pick(bk.x, kc);                   // 0 where not live
        acc[kChunkCols + c] += pick(bk.q, kc);
        mn = bk.live ? fminf(mn, pick(bk.n, kc)) : mn;
        mx = bk.live ? fmaxf(mx, pick(bk.m, kc)) : mx;
      }
      cnt += bk.c;
    };
    const Bucket first = load_bucket(lane);

    // the raw head and tail positions, lane-strided, groups of up to 4
    // steps: a window without a full bucket is up to 2 BSZ - 2 positions
    in_groups<4>(raw_steps, [&](auto group, int k) {
      constexpr int U = decltype(group)::value;
      float4 xs[U];
      bool live[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int r = lane + 32 * (k + u);
        live[u] = r < n_raw;
        const int rs = r < n_head ? head_slot + r : tail_slot + (r - n_head);
        const size_t slot = kbase + (live[u] ? wrap_slot(rs, C) : 0);
        xs[u] = load_row(values + slot * V, chunk, live[u] && want_raw);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int c = 0; c < kChunkCols; ++c) {
          const float x = pick(xs[u], chunk.k[c]);  // 0 where not live
          float& mn = acc[2 * kChunkCols + c];
          float& mx = acc[3 * kChunkCols + c];
          acc[c] += x;
          acc[kChunkCols + c] += __fmul_rn(x, x);
          mn = live[u] ? fminf(mn, x) : mn;
          mx = live[u] ? fmaxf(mx, x) : mx;
        }
        cnt += live[u] ? 1.f : 0.f;
      }
    });
    add_bucket(first);
    for (int k = 32; k < n_bk; k += 32) add_bucket(load_bucket(lane + k));

    // lanes 2i and 2i + 1 end with value i: field i / 4 of column i % 4
    const float red = reduce_scatter<kChunkCols>(acc);
    if (count_here) {
      cnt = warp_sum_f(cnt);
      if (lane == 0) out.count[b] = cnt;
    }
    const int fe = lane >> 3, ce = (lane >> 1) & (kChunkCols - 1);
    const int fbit = fe == 0 ? kSum : fe == 1 ? kSumsq : fe == 2 ? kMin : kMax;
    if ((lane & 1) == 0 && ce < chunk.nc && (fields & fbit)) {
      float* const o = fe == 0 ? out.sum : fe == 1 ? out.sumsq
                       : fe == 2 ? out.min : out.max;
      o[static_cast<size_t>(b) * oC + ch * kChunkCols + ce] = red;
    }
  }
}

}  // namespace rt

extern "C" int preagg_window_launch(
    const float* values, const float* ts, const int* total,
    const float* pa_sum, const float* pa_sumsq, const float* pa_min,
    const float* pa_max, const float* pa_count, const int* req_key,
    const float* req_ts, const int* table, int B, int K, int C, int V,
    int NB, int BSZ, int n_cols, int out_cols, int rows, float range,
    int assume_latest, int fields, float* o_sum, float* o_sumsq,
    float* o_count, float* o_min, float* o_max, void* stream) {
  if (B <= 0 || n_cols < 0 || n_cols > rt::kMaxCols || out_cols < n_cols ||
      BSZ <= 0 || NB * BSZ != C)
    return static_cast<int>(cudaErrorInvalidValue);
  const int vec = V % 4 == 0 && rt::aligned16(values) &&
                  rt::aligned16(pa_sum) && rt::aligned16(pa_sumsq) &&
                  rt::aligned16(pa_min) && rt::aligned16(pa_max);
  const int vec_ts = C % 4 == 0 && rt::aligned16(ts);
  rt::Tiers tiers{pa_sum, pa_sumsq, pa_min, pa_max, pa_count};
  rt::PreaggOut out{o_sum, o_sumsq, o_count, o_min, o_max};
  const int blocks = (B + rt::kWarps - 1) / rt::kWarps;
  rt::preagg_window_kernel<<<blocks, 32 * rt::kWarps, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      values, ts, total, tiers, req_key, req_ts, table, B, K, C, V, NB, BSZ,
      n_cols, out_cols, rows, range, assume_latest, fields, vec, vec_ts, out);
  return static_cast<int>(cudaGetLastError());
}

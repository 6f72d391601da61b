// Helpers of the warp-per-request feature kernels (window_agg,
// fused_window, preagg_window, last_join): one warp answers one request,
// with no block barrier and no shared memory. Each lane reads every 32nd
// position (or bucket) of the request's window, keeps its partial
// aggregates in registers, and the warp combines them with
// __shfl_xor_sync butterflies. One warp runs alone
// on its scheduler here (about four warps an SM at B=500), so nothing
// hides a stall: every load of a step is issued before any is used, and
// no shuffle sits under a branch.
//
// A block holds kWarps requests; a ragged last block leaves whole warps
// idle, so no collective ever runs with a lane missing.
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace rt {

constexpr unsigned kFullMask = 0xffffffffu;
// Requests (warps) a block. At the main path's B=500 calls 1, 2 and 4
// measured within their run-to-run spread and 8 slower (PERF.md, §6);
// 2 keeps 250 blocks over the 132 SMs there. At B=100 (50 blocks) every
// kernel measured at or below its B=500 time per launch (PR 16).
constexpr int kWarps = 2;
constexpr int kChunkCols = 4;    // columns one walk accumulates
constexpr int kUnroll = 4;       // ts slots a lane loads at once (bounds)

// A launch's static table, int32 words in device memory, built once per
// table by the wrapper (_build.device_table): the column indices, then per
// spec the ROWS length (-1 for RANGE), the field bits and the RANGE span's
// float bits.
// In the kernel's parameters a table this size was read through the
// constant cache, whose first reads miss one after another mid-kernel;
// from device memory every lane loads its words at the start, beside the
// request's own loads.
constexpr int kTabCols = 0;
constexpr int kTabRows = kMaxCols;
constexpr int kTabFields = kTabRows + kMaxSpecs;
constexpr int kTabRange = kTabFields + kMaxSpecs;

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// Number of column chunks a request walks: at least one, so a launch with
// no value column still writes its counts.
__host__ __device__ __forceinline__ int n_col_chunks(int n) {
  return n > 0 ? (n + kChunkCols - 1) / kChunkCols : 1;
}

__device__ __forceinline__ float pick(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// One chunk of columns as a walk reads it: `ci` the column indices, `nc`
// how many are real, `quad` the aligned group of four floats that holds
// all of them (read with one 16-byte load per row) or -1 (one load per
// column), and `k[c]` the component of a loaded row (load_row) that holds
// column c.
struct Chunk {
  int ci[kChunkCols];
  int k[kChunkCols];
  int nc;
  int quad;
};

// The columns of a launch, one pair a lane: lane l holds columns l and
// l + 32 of the table.
struct LaneCols {
  int lo, hi;
};

__device__ __forceinline__ LaneCols lane_cols(const int* __restrict__ tab) {
  const int lane = threadIdx.x & 31;
  return {__ldg(tab + kTabCols + lane), __ldg(tab + kTabCols + 32 + lane)};
}

// Chunk ch of n columns; `vec` says the rows are 16-byte aligned with a
// multiple of four floats each, so a group of four can be one load.
__device__ __forceinline__ Chunk chunk_of(const LaneCols& lc, int n, int ch,
                                          bool vec) {
  Chunk c;
  const int c0 = ch * kChunkCols;
  c.nc = min(kChunkCols, n - c0);
#pragma unroll
  for (int j = 0; j < kChunkCols; ++j) {
    const int src = c0 + j;
    const int lo = __shfl_sync(kFullMask, lc.lo, src & 31);
    const int hi = __shfl_sync(kFullMask, lc.hi, src & 31);
    c.ci[j] = src < 32 ? lo : hi;
  }
  const int q = c.ci[0] >> 2;
  bool one = vec && c.nc > 0;
#pragma unroll
  for (int j = 1; j < kChunkCols; ++j)
    one = one && (j >= c.nc || c.ci[j] >> 2 == q);
  c.quad = one ? q : -1;
#pragma unroll
  for (int j = 0; j < kChunkCols; ++j)
    c.k[j] = one ? c.ci[j] - 4 * q : j;
  return c;
}

// s mod C for s in (-C, 2C): the ring slot of a position a known slot plus
// an offset of less than C away, without an integer division.
__device__ __forceinline__ int wrap_slot(int s, int C) {
  return s < 0 ? s + C : (s >= C ? s - C : s);
}

// A compile-time step count for the walks' groups of steps.
template <int N>
struct Steps {
  static constexpr int value = N;
};

// Run body(Steps<U>{}, k) over a walk's steps [0, n) in groups of U = G
// steps, then at most one group of each smaller power of two: a group
// loads all its rows before it uses any, and holds no step past the end.
// On the H100 an unrolled step with nothing to load cost about a round
// trip, and a large group body costs time of its own, so each walk takes
// the G that measured fastest at its main-path calls.
template <int G, typename Body>
__device__ __forceinline__ void in_groups(int n, Body&& body, int k = 0) {
  for (; k + G <= n; k += G) body(Steps<G>{}, k);
  if constexpr (G > 1) {
    if (k < n) in_groups<G / 2>(n, body, k);
  }
}

// The chunk's columns of one row (`row` is the row's column 0), or zeros
// where `live` is false: one 16-byte load where the chunk lies in one
// aligned group of four, else one load per column. Nothing here waits for
// the data, so a caller issues several rows' loads before it uses any;
// pick(v, chunk.k[c]) then gives column c.
__device__ __forceinline__ float4 load_row(const float* __restrict__ row,
                                           const Chunk& ch, bool live) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (ch.quad >= 0) {
    if (live) v = __ldg(reinterpret_cast<const float4*>(row) + ch.quad);
  } else {
    if (live && ch.nc > 0) v.x = __ldg(row + ch.ci[0]);
    if (live && ch.nc > 1) v.y = __ldg(row + ch.ci[1]);
    if (live && ch.nc > 2) v.z = __ldg(row + ch.ci[2]);
    if (live && ch.nc > 3) v.w = __ldg(row + ch.ci[3]);
  }
  return v;
}

// Field f of the moments a walk accumulates: 0 sum, 1 sum of squares,
// 2 min, 3 max.
__device__ __forceinline__ float combine(float a, float b, int f) {
  const float sum = a + b, lo = fminf(a, b), hi = fmaxf(a, b);
  return f < 2 ? sum : (f == 2 ? lo : hi);
}

// Reduce-scatter butterfly: each lane holds N = 2^m values (m <= 5), field
// by field in blocks of PF (value i belongs to field i / PF); afterwards
// lane l holds the warp's reduction of value l >> (5 - m) in v[0]. A step
// at offset O halves the live values: a lane keeps the upper half where
// bit O of its lane is set, sends the other half to its partner and
// combines what it gets back; once one value is left, the remaining steps
// reduce it over the lanes that share it. N - 1 + 5 - m shuffles in all,
// and no shuffle sits under a branch, so a step's shuffles issue back to
// back (a shuffle under a data-dependent branch costs a full round trip).
template <int O, int W, int PF, int N>
__device__ __forceinline__ void reduce_scatter_step(float (&v)[N], int lane,
                                                    int base) {
  if constexpr (O > 0) {
    if constexpr (W > 1) {
      constexpr int H = W / 2;
      const bool upper = (lane & O) != 0;
      const int kept = base + (upper ? H : 0);
#pragma unroll
      for (int i = 0; i < H; ++i) {
        const float keep = upper ? v[i + H] : v[i];
        const float send = upper ? v[i] : v[i + H];
        v[i] = combine(keep, __shfl_xor_sync(kFullMask, send, O),
                       (kept + i) / PF);
      }
      reduce_scatter_step<O / 2, H, PF, N>(v, lane, kept);
    } else {
      v[0] = combine(v[0], __shfl_xor_sync(kFullMask, v[0], O), base / PF);
      reduce_scatter_step<O / 2, 1, PF, N>(v, lane, base);
    }
  }
}

template <int PF, int N>
__device__ __forceinline__ float reduce_scatter(float (&v)[N]) {
  static_assert(N >= 1 && N <= 32 && (N & (N - 1)) == 0, "N = 2^m <= 32");
  reduce_scatter_step<16, N, PF, N>(v, threadIdx.x & 31, 0);
  return v[0];
}

// Sum of a float over the warp, in every lane.
__device__ __forceinline__ float warp_sum_f(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
  return v;
}

// v[k] for a lane-dependent k, without indexing a register array
// dynamically (which would put it in local memory).
template <int N, typename T>
__device__ __forceinline__ T select(const T (&v)[N], int k) {
  T r = v[0];
#pragma unroll
  for (int i = 1; i < N; ++i) r = k == i ? v[i] : r;
  return r;
}

// The bounds pass of one request, for NS window frames at once: each lane
// counts, over the retained slots [0, n_ret) of the key's ts row,
// after = #{ts > t} (for p1) and, for each frame s with on[s],
// in_range[s] = #{t_lo[s] <= ts <= t} (a RANGE frame's p0). With `vec`
// the row is read with 16-byte loads, kUnroll of them in flight a lane.
// The counts are partial; the caller reduces them.
template <int NS>
__device__ __forceinline__ void count_ts_warp(const float* __restrict__ row,
                                              int n_ret, bool vec, float t,
                                              const float (&t_lo)[NS],
                                              const bool (&on)[NS],
                                              int& after, int (&in_range)[NS]) {
  const int lane = threadIdx.x & 31;
  auto count = [&](float x, bool valid) {
    after += valid && x > t;
#pragma unroll
    for (int s = 0; s < NS; ++s)
      if (on[s]) in_range[s] += valid && x >= t_lo[s] && x <= t;
  };
  if (vec) {
    const float4* row4 = reinterpret_cast<const float4*>(row);
    const int n4 = (n_ret + 3) / 4;
    for (int i0 = 0; i0 < n4; i0 += 32 * kUnroll) {
      float4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = i0 + lane + 32 * u;
        v[u] = i < n4 ? __ldg(row4 + i) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int s0 = 4 * (i0 + lane + 32 * u);
        count(v[u].x, s0 < n_ret);
        count(v[u].y, s0 + 1 < n_ret);
        count(v[u].z, s0 + 2 < n_ret);
        count(v[u].w, s0 + 3 < n_ret);
      }
    }
  } else {
    for (int i0 = 0; i0 < n_ret; i0 += 32 * kUnroll) {
      float v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = i0 + lane + 32 * u;
        v[u] = i < n_ret ? __ldg(row + i) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        count(v[u], i0 + lane + 32 * u < n_ret);
    }
  }
}

// A request's place in the launch: warp w of block blockIdx.x answers
// request blockIdx.x * kWarps + w, or none past B.
__device__ __forceinline__ int warp_request() {
  return blockIdx.x * kWarps + (threadIdx.x >> 5);
}

}  // namespace rt

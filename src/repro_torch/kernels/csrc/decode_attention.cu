// decode_attention: one query token per sequence against its KV cache,
// GQA, prefix or ring layout. q (B, Hq, D), caches (B, S, Hkv, D) of one
// element type (bf16 or f32), lengths (B,) int32 read on the device,
// out (B, Hq, D); f32 accumulation and softmax.
//
// Replaces the TPU kernel decode_attention_pallas (src/repro/kernels/
// decode_attention.py). Same function: the rep = Hq / Hkv query heads of
// one KV head share every K/V load; prefix mode keeps kpos < length
// (a length above S counts as S) and, with a window, kpos >= length -
// window; ring mode reads `lengths` as the absolute position pos, slot s
// holding position pos - ((pos - s + S (pos / S + 1)) mod S), kept iff
// >= 0 and > pos - window. Running max from -1e30, masked probabilities
// exactly 0, a head with nothing kept writes 0. The Pallas kernel walks a
// sequential grid over cache blocks with VMEM scratch; on the H100 the
// cache is split over blocks instead (split-KV), and a second pass merges
// the splits.
//
// Bound on an H100: bytes. Each live cache row is read once (2 Hkv D
// elements per slot per sequence) against 4 rep D flops per row per KV
// head; at the main path's decode (qwen2-1.5b, 16 slots of a 1024-long
// cache at lengths 512 and 672, 12 query heads over 2 KV heads, D 128,
// bf16) that is 9,797,696 bytes against 58 MFLOP, 2.9 us at 3.35 TB/s.
// What the design does about the bytes:
//
// * Split pass, grid (Hkv, B, n_split) with n_split = ceil(S / 64) from
//   the cache's shape, never from the lengths: the launch is the same
//   every step, needs no host sync and can be captured in a CUDA graph.
//   Split i covers the live slots [64 i, 64 (i + 1)) intersected with
//   [lo, hi); a split with nothing live writes l = 0, m = -1e30 and
//   returns without reading the cache. At the main path's shape that is
//   2 x 16 x 16 = 512 blocks, about 300 of them live, where one block per
//   (b, KV head) gave 32 blocks on 132 SMs. Why 64 slots: at that shape
//   64 gives each SM two to three live blocks, so one block's copy
//   latency hides behind another's work, where 128 gives about one; 32
//   would double the partials the combine reads.
// * Each live split copies its K and V rows into shared memory in the
//   cache's own type (bf16 stays bf16: half the bytes of f32 staging) by
//   16-byte cp.async, K and V in two groups, all rows in flight at once,
//   while the block loads q; the scores wait for K only. Rows are padded
//   by 16 bytes, so 8 rows read at one column fall on 8 bank groups.
// * bf16 (decode_split_mma_kernel): the rep query heads, zero-padded to
//   16 rows, are the M of two tensor-core products: S = q K^T and
//   acc = P V by mma.sync m16n8k16 (bf16 in, f32 accumulate), K and V
//   read by ldmatrix; scores scaled and softmax taken in f32, P rounded to
//   bf16 before PV as the plain version rounds it. On the FMA units these
//   two loops cost more than the copies at the main path's call.
//   f32 (decode_split_f32_kernel) keeps both products on the FMA units in
//   full f32 (the f32 checks hold to 2e-5).
// * Each split writes its unnormalised (m, l, acc) to f32 scratch that
//   the wrapper allocates.
// * Combine pass (decode_combine_kernel), one block per (b, KV head):
//   m* = max m_i, l = sum l_i 2^(m_i - m*), o = sum acc_i 2^(m_i - m*) / l
//   over the live splits, l = 0 writing 0. A thread loads the partials of
//   16 splits at once (one round trip to L2, not one per split) and
//   merges batch by batch.
#include <type_traits>

#include "attention.cuh"

namespace attn {

constexpr int kDecThreads = 256;
constexpr int kDecWarps = kDecThreads / 32;
constexpr int kChunk = 64;       // cache slots per split
constexpr int kMaxAcc4 = 2;      // float4 accumulators per thread: rep D <= 2048
constexpr int kHeadGroup = 8;    // query heads scored per pass over a K row
constexpr int kCombineBatch = 16;

// Live slots [lo, hi) of one sequence.
__device__ __forceinline__ void live_range(int length, int S, int window,
                                           int ring, int& lo, int& hi) {
  lo = 0;
  if (ring) {
    hi = min(S, length + 1);   // slots past pos are unwritten while pos < S
  } else {
    hi = min(S, length);
    if (window > 0) lo = max(0, length - window);
  }
}

// Whether ring slot `slot` holds a position the query at `pos` keeps.
__device__ __forceinline__ bool ring_keep(int pos, int slot, int S,
                                          int window) {
  const int ap = pos - (pos - slot + S * (pos / S + 1)) % S;
  return ap >= 0 && (window <= 0 || ap > pos - window);
}

// Where split `split` of (b, KV head) keeps its partials, head r: m and l
// at part rep + r, acc at (part rep + r) D.
__device__ __forceinline__ size_t part_index(int b, int kvh, int Hkv,
                                             int split, int n_split) {
  return (static_cast<size_t>(b) * Hkv + kvh) * n_split + split;
}

// Copies rows [0, n) of a 64-slot split (row stride ld elements) into a
// shared tile with row stride RS; with zero_fill, rows n..63 become 0.
template <typename T, int D, int RS>
__device__ __forceinline__ void load_rows(T* dst, const T* src, size_t ld,
                                          int n, bool zero_fill) {
  constexpr int E = 16 / static_cast<int>(sizeof(T));
  constexpr int CH = D / E;   // 16-byte copies per row
  const int rows = zero_fill ? kChunk : n;
  for (int i = threadIdx.x; i < rows * CH; i += kDecThreads) {
    const int j = i / CH;
    const int c = i % CH;
    const bool ok = j < n;
    cp_async16(smem_u32(dst + j * RS + c * E),
               src + (ok ? j : 0) * ld + c * E, ok);
  }
}

// ---------------------------------------------------------------------------
// bf16 split pass: tensor cores
// ---------------------------------------------------------------------------

template <int D>
__host__ __device__ constexpr int mma_row_stride() { return D + 8; }
constexpr int kPStride = kChunk + 8;   // bf16 P rows, padded like K/V

// K, V, q (rep padded to 16-row m-tiles), P (bf16), scores (f32).
template <int D>
__host__ __device__ constexpr size_t split_mma_smem_bytes(int rep) {
  const size_t rows = static_cast<size_t>((rep + 15) / 16) * 16;
  return 2 * (2 * kChunk + rows) * mma_row_stride<D>()
         + 2 * rows * kPStride + 4 * rows * kChunk;
}

template <int D>
__global__ void __launch_bounds__(kDecThreads) decode_split_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ kc,
    const __nv_bfloat16* __restrict__ vc, const int* __restrict__ lengths,
    float* __restrict__ part_acc, float* __restrict__ part_m,
    float* __restrict__ part_l, int S, int Hkv, int rep, int window,
    int ring, float scale_log2) {
  constexpr int SD = mma_row_stride<D>();
  constexpr int CH = D / 8;
  const int mrows = (rep + 15) / 16 * 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [64][SD]
  __nv_bfloat16* vs = ks + kChunk * SD;                            // [64][SD]
  __nv_bfloat16* qs = vs + kChunk * SD;                       // [mrows][SD]
  __nv_bfloat16* pb = qs + mrows * SD;                  // [mrows][kPStride]
  float* ps = reinterpret_cast<float*>(pb + mrows * kPStride);  // [mrows][64]

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int length = lengths[b];
  int lo, hi;
  live_range(length, S, window, ring, lo, hi);
  const int s0 = max(lo, split * kChunk);
  const int s1 = min(hi, split * kChunk + kChunk);
  const size_t part = part_index(b, kvh, Hkv, split, gridDim.z);
  if (s0 >= s1) {   // nothing live in this split
    for (int r = threadIdx.x; r < rep; r += kDecThreads) {
      part_m[part * rep + r] = kNegInit;
      part_l[part * rep + r] = 0.f;
    }
    return;
  }
  const int n = s1 - s0;

  // K, then V (zero past n: P there is 0, and 0 times stale data could be
  // NaN), in two copy groups.
  const size_t ld = static_cast<size_t>(Hkv) * D;
  const size_t row0 = (static_cast<size_t>(b) * S + s0) * Hkv + kvh;
  load_rows<__nv_bfloat16, D, SD>(ks, kc + row0 * D, ld, n, false);
  cp_async_commit();
  load_rows<__nv_bfloat16, D, SD>(vs, vc + row0 * D, ld, n, true);
  cp_async_commit();
  const __nv_bfloat16* qb =
      q + (static_cast<size_t>(b) * Hkv + kvh) * rep * D;
  for (int i = threadIdx.x; i < mrows * CH; i += kDecThreads) {
    const int r = i / CH;
    const int c = i % CH;
    *reinterpret_cast<uint4*>(qs + r * SD + c * 8) =
        r < rep ? *reinterpret_cast<const uint4*>(qb + r * D + c * 8)
                : make_uint4(0u, 0u, 0u, 0u);
  }
  cp_async_wait<1>();
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int tq = lane & 3;

  // S = q K^T: warp w takes the slots 8w..8w+7 of every m-tile; scaled
  // into the log2 domain, -inf where masked.
  {
    bool keep[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int j = warp * 8 + tq * 2 + e;
      keep[e] = j < n && (!ring || ring_keep(length, s0 + j, S, window));
    }
    for (int mt = 0; mt < mrows / 16; ++mt) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t a[4], bk[2];
        ldsm_x4(smem_u32(qs + (mt * 16 + (lane & 15)) * SD + kk * 16 +
                         (lane >> 4) * 8), a);
        ldsm_x2(smem_u32(ks + (warp * 8 + (lane & 7)) * SD + kk * 16 +
                         ((lane >> 3) & 1) * 8), bk);
        mma_bf16(acc, a, bk[0], bk[1]);
      }
#pragma unroll
      for (int c = 0; c < 4; ++c)
        ps[(mt * 16 + g + (c >> 1) * 8) * kChunk + warp * 8 + tq * 2 +
           (c & 1)] = keep[c & 1] ? acc[c] * scale_log2 : -INFINITY;
    }
  }
  __syncthreads();

  // softmax of the split per head (warp w takes heads w, w + 8, ...); P
  // to bf16, 0 past n and where masked.
  for (int r = warp; r < rep; r += kDecWarps) {
    const float* pr = ps + r * kChunk;
    const float x0 = pr[lane];
    const float x1 = pr[lane + 32];
    float mt = fmaxf(kNegInit, fmaxf(x0, x1));
    for (int o = 16; o > 0; o >>= 1)
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
    const float p0 = exp2f(x0 - mt);
    const float p1 = exp2f(x1 - mt);
    pb[r * kPStride + lane] = __float2bfloat16_rn(p0);
    pb[r * kPStride + lane + 32] = __float2bfloat16_rn(p1);
    float sum = p0 + p1;
    for (int o = 16; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (lane == 0) {
      part_m[part * rep + r] = mt;
      part_l[part * rep + r] = sum;
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // V landed; P written

  // acc = P V: warp w takes the (m-tile, 8-column) items w, w + 8, ...
  for (int it = warp; it < (mrows / 16) * (D / 8); it += kDecWarps) {
    const int mt = it / (D / 8);
    const int nt = it % (D / 8);
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < kChunk / 16; ++kk) {
      uint32_t a[4], bv[2];
      ldsm_x4(smem_u32(pb + (mt * 16 + (lane & 15)) * kPStride + kk * 16 +
                       (lane >> 4) * 8), a);
      ldsm_x2_trans(smem_u32(vs + (kk * 16 + (lane & 7) +
                                   ((lane >> 3) & 1) * 8) * SD + nt * 8),
                    bv);
      mma_bf16(acc, a, bv[0], bv[1]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = mt * 16 + g + h * 8;
      if (r < rep)
        *reinterpret_cast<float2*>(part_acc + (part * rep + r) * D +
                                   nt * 8 + tq * 2) =
            make_float2(acc[2 * h], acc[2 * h + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// f32 split pass: FMA units
// ---------------------------------------------------------------------------

template <int D>
__host__ __device__ constexpr int f32_row_stride() { return D + 4; }

// K, V, q (scaled), scores.
template <int D>
__host__ __device__ constexpr size_t split_f32_smem_bytes(int rep) {
  return 4 * (2 * static_cast<size_t>(kChunk) * f32_row_stride<D>()
              + static_cast<size_t>(rep) * D
              + static_cast<size_t>(rep) * kChunk);
}

template <int D>
__global__ void __launch_bounds__(kDecThreads) decode_split_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ kc,
    const float* __restrict__ vc, const int* __restrict__ lengths,
    float* __restrict__ part_acc, float* __restrict__ part_m,
    float* __restrict__ part_l, int S, int Hkv, int rep, int window,
    int ring, float scale_log2) {
  constexpr int RS = f32_row_stride<D>();
  constexpr int C4 = D / 4;   // float4 pieces of a row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ks = reinterpret_cast<float*>(smem_raw);    // [64][RS]
  float* vs = ks + kChunk * RS;                      // [64][RS]
  float* qs = vs + kChunk * RS;                      // [rep][D]
  float* ps = qs + rep * D;                          // [rep][64]

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int length = lengths[b];
  int lo, hi;
  live_range(length, S, window, ring, lo, hi);
  const int s0 = max(lo, split * kChunk);
  const int s1 = min(hi, split * kChunk + kChunk);
  const size_t part = part_index(b, kvh, Hkv, split, gridDim.z);
  if (s0 >= s1) {   // nothing live in this split
    for (int r = threadIdx.x; r < rep; r += kDecThreads) {
      part_m[part * rep + r] = kNegInit;
      part_l[part * rep + r] = 0.f;
    }
    return;
  }
  const int n = s1 - s0;

  const size_t ld = static_cast<size_t>(Hkv) * D;
  const size_t row0 = (static_cast<size_t>(b) * S + s0) * Hkv + kvh;
  load_rows<float, D, RS>(ks, kc + row0 * D, ld, n, false);
  cp_async_commit();
  load_rows<float, D, RS>(vs, vc + row0 * D, ld, n, false);
  cp_async_commit();
  const float* qb = q + (static_cast<size_t>(b) * Hkv + kvh) * rep * D;
  for (int i = threadIdx.x; i < rep * C4; i += kDecThreads)
    reinterpret_cast<float4*>(qs)[i] =
        scale4(reinterpret_cast<const float4*>(qb)[i], scale_log2);
  cp_async_wait<1>();
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  // scores of (head r, slot j), log2 domain; -inf where masked. Lane
  // (p, jj) of warp w takes slot j = 8 w + jj and the float4 pieces
  // p, p + 4, ... of its K row, holds them in registers and dots them
  // with every head's q; the 4 parts of a slot sit 8 lanes apart and are
  // summed by shuffles. The 8 lanes of a quarter warp read 8 rows at one
  // column (distinct bank groups) and one q address.
  {
    constexpr int PP = C4 / 4;   // pieces per part
    const int p = lane / 8;
    const int j = warp * 8 + lane % 8;
    bool keep = j < n;
    if (keep && ring) keep = ring_keep(length, s0 + j, S, window);
    float4 kx[PP];
#pragma unroll
    for (int u = 0; u < PP; ++u)
      kx[u] = keep ? reinterpret_cast<const float4*>(ks + j * RS)[p + 4 * u]
                   : make_float4(0.f, 0.f, 0.f, 0.f);
    for (int r0 = 0; r0 < rep; r0 += kHeadGroup) {
      float dot[kHeadGroup];
#pragma unroll
      for (int rr = 0; rr < kHeadGroup; ++rr) {
        dot[rr] = 0.f;
        if (r0 + rr < rep) {
          const float4* qr =
              reinterpret_cast<const float4*>(qs + (r0 + rr) * D);
#pragma unroll
          for (int u = 0; u < PP; ++u)
            dot[rr] = dot4(qr[p + 4 * u], kx[u], dot[rr]);
        }
        dot[rr] += __shfl_xor_sync(0xffffffffu, dot[rr], 8);
        dot[rr] += __shfl_xor_sync(0xffffffffu, dot[rr], 16);
      }
      if (p == 0) {
#pragma unroll
        for (int rr = 0; rr < kHeadGroup; ++rr)
          if (r0 + rr < rep)
            ps[(r0 + rr) * kChunk + j] = keep ? dot[rr] : -INFINITY;
      }
    }
  }
  __syncthreads();

  // softmax of the split per head: warp w takes heads w, w + 8, ...
  for (int r = warp; r < rep; r += kDecWarps) {
    float* pr = ps + r * kChunk;
    const float x0 = pr[lane];
    const float x1 = pr[lane + 32];
    float mt = fmaxf(kNegInit, fmaxf(x0, x1));
    for (int o = 16; o > 0; o >>= 1)
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
    const float p0 = exp2f(x0 - mt);   // exactly 0 where masked
    const float p1 = exp2f(x1 - mt);
    pr[lane] = p0;
    pr[lane + 32] = p1;
    float sum = p0 + p1;
    for (int o = 16; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (lane == 0) {
      part_m[part * rep + r] = mt;
      part_l[part * rep + r] = sum;
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // V landed; P written

  // acc[r][piece c] = sum_j p[r][j] v[j][c]
#pragma unroll
  for (int e = 0; e < kMaxAcc4; ++e) {
    const int u = threadIdx.x + e * kDecThreads;
    if (u < rep * C4) {
      const int r = u / C4;
      const int c = u % C4;
      const float* pr = ps + r * kChunk;
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int j = 0; j < n; ++j)
        a = fma4(pr[j], reinterpret_cast<const float4*>(vs + j * RS)[c], a);
      reinterpret_cast<float4*>(part_acc)[(part * rep + r) * C4 + c] = a;
    }
  }
}

// ---------------------------------------------------------------------------
// combine pass
// ---------------------------------------------------------------------------

// Merges the live splits of one (b, KV head) into out.
template <typename T, int D>
__global__ void __launch_bounds__(kDecThreads) decode_combine_kernel(
    const float* __restrict__ part_acc, const float* __restrict__ part_m,
    const float* __restrict__ part_l, const int* __restrict__ lengths,
    T* __restrict__ out, int S, int Hkv, int rep, int n_split, int window,
    int ring) {
  constexpr int C4 = D / 4;
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  int lo, hi;
  live_range(lengths[b], S, window, ring, lo, hi);
  const int i_lo = lo / kChunk;
  const int i_hi = hi > lo ? (hi - 1) / kChunk + 1 : i_lo;
  const size_t base = part_index(b, kvh, Hkv, 0, n_split);
  const size_t o_base = (static_cast<size_t>(b) * Hkv + kvh) * rep * D;
#pragma unroll
  for (int e = 0; e < kMaxAcc4; ++e) {
    const int u = threadIdx.x + e * kDecThreads;
    if (u < rep * C4) {
      const int r = u / C4;
      const int c = u % C4;
      float mx = kNegInit;
      float l = 0.f;
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int i0 = i_lo; i0 < i_hi; i0 += kCombineBatch) {
        float mb[kCombineBatch], lb[kCombineBatch];
        float4 ab[kCombineBatch];
#pragma unroll
        for (int k = 0; k < kCombineBatch; ++k) {
          mb[k] = kNegInit;
          lb[k] = 0.f;
          ab[k] = make_float4(0.f, 0.f, 0.f, 0.f);
          if (i0 + k < i_hi) {
            const size_t p = (base + i0 + k) * rep + r;
            mb[k] = part_m[p];
            lb[k] = part_l[p];
            ab[k] = reinterpret_cast<const float4*>(part_acc)[p * C4 + c];
          }
        }
        float m_new = mx;
#pragma unroll
        for (int k = 0; k < kCombineBatch; ++k) m_new = fmaxf(m_new, mb[k]);
        const float alpha = exp2f(mx - m_new);
        l *= alpha;
        a = scale4(a, alpha);
#pragma unroll
        for (int k = 0; k < kCombineBatch; ++k) {
          const float w = exp2f(mb[k] - m_new);
          l = fmaf(lb[k], w, l);
          a = fma4(w, ab[k], a);
        }
        mx = m_new;
      }
      Vec4<T>::store(out + o_base + u * 4,
                     scale4(a, 1.f / (l > 0.f ? l : 1.f)));
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

struct DecodeLaunch {
  const void* q;
  const void* kc;
  const void* vc;
  const int* lengths;
  void* out;
  float* scratch;
  int B, S, Hkv, rep, window, ring;
  float scale_log2;
  cudaStream_t stream;

  template <typename T, int D>
  int operator()() const {
    if (rep * D > kMaxAcc4 * kDecThreads * 4)
      return static_cast<int>(cudaErrorInvalidValue);
    const int n_split = (S + kChunk - 1) / kChunk;
    if (n_split > 65535) return static_cast<int>(cudaErrorInvalidValue);
    // scratch: acc (B, Hkv, n_split, rep, D), then m and l
    // (B, Hkv, n_split, rep), all f32
    const size_t n_part = static_cast<size_t>(B) * Hkv * n_split * rep;
    float* part_acc = scratch;
    float* part_m = part_acc + n_part * D;
    float* part_l = part_m + n_part;
    const dim3 grid(Hkv, B, n_split);
    static int granted[kMaxDevices] = {};
    int err;
    if constexpr (std::is_same_v<T, __nv_bfloat16>) {
      const int smem = static_cast<int>(split_mma_smem_bytes<D>(rep));
      err = allow_smem((const void*)decode_split_mma_kernel<D>, smem,
                       granted);
      if (err) return err;
      decode_split_mma_kernel<D><<<grid, kDecThreads, smem, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(kc),
          static_cast<const T*>(vc), lengths, part_acc, part_m, part_l, S,
          Hkv, rep, window, ring, scale_log2);
    } else {
      const int smem = static_cast<int>(split_f32_smem_bytes<D>(rep));
      err = allow_smem((const void*)decode_split_f32_kernel<D>, smem,
                       granted);
      if (err) return err;
      decode_split_f32_kernel<D><<<grid, kDecThreads, smem, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(kc),
          static_cast<const T*>(vc), lengths, part_acc, part_m, part_l, S,
          Hkv, rep, window, ring, scale_log2);
    }
    err = static_cast<int>(cudaGetLastError());
    if (err) return err;
    decode_combine_kernel<T, D><<<dim3(Hkv, B), kDecThreads, 0, stream>>>(
        part_acc, part_m, part_l, lengths, static_cast<T*>(out), S, Hkv,
        rep, n_split, window, ring);
    return static_cast<int>(cudaGetLastError());
  }
};

}  // namespace attn

// dtype: 0 = f32, 1 = bf16. window <= 0 means no window; ring != 0 reads
// lengths as absolute positions of a rolling ring. scratch holds
// B Hkv ceil(S / chunk) rep (D + 2) floats; chunk must be the kernels'
// split size (64).
extern "C" int decode_attention_launch(
    const void* q, const void* kc, const void* vc, const int* lengths,
    void* out, void* scratch, int B, int S, int Hq, int Hkv, int D,
    int dtype, int window, int ring, int chunk, float scale, void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || Hq % Hkv != 0 || B > 65535 ||
      chunk != attn::kChunk)
    return static_cast<int>(cudaErrorInvalidValue);
  const attn::DecodeLaunch f{q, kc, vc, lengths, out,
                             static_cast<float*>(scratch), B, S, Hkv,
                             Hq / Hkv, window, ring, scale * attn::kLog2e,
                             static_cast<cudaStream_t>(stream)};
  return attn::dispatch(dtype, D, f);
}

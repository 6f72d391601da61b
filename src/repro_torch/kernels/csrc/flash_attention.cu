// flash_attention: causal / sliding-window / full GQA attention with an
// online softmax, the (Sq, Sk) score matrix never leaving the block.
// q (B, Sq, Hq, D), k and v (B, Sk, Hkv, D), out (B, Sq, Hq, D), all of
// one element type (bf16 or f32); f32 accumulation and softmax.
//
// Replaces the TPU kernel flash_attention_pallas (src/repro/kernels/
// flash_attention.py). Same function: query i sits at position
// i + q_offset (the wrapper's default Sk - Sq right-aligns the queries, the
// Pallas kernel's only layout; a context-parallel rank passes its first
// row's global position), KV head h / rep, keep a key iff
// kpos <= qpos (causal) and kpos > qpos - window, running max from -1e30,
// masked probabilities exactly 0, a row with nothing kept writes 0. The
// Pallas kernel walks a sequential grid over K blocks with VMEM scratch and
// needs Sq and Sk to divide its blocks; here one thread block owns a tile
// of query rows of one (b, head) and loops over K/V tiles itself, masking
// the ragged edges, so prompts of any length run. Tiles wholly outside the
// causal/window band are never loaded.
//
// Bound on an H100: bytes. At the prefill call of the main path
// (qwen2-1.5b: 8 prompts of 512, 12 query heads of 128 over 2 KV heads,
// bf16, causal) the call must move 29,360,128 bytes of q/k/v/out, 8.8 us
// at 3.35 TB/s, against 6.455 GFLOP of kept (query, key) pairs in QK^T and
// PV, 6.5 us at the 989 TFLOP/s bf16 tensor-core peak. The two are close,
// so the kernel has to keep the tensor cores and the copies busy at once.
//
// bf16, head dims 64 and 128 (flash_attention_wg_kernel, the main path):
// one warpgroup (4 warps) owns 64 query rows of one head, and a block
// holds G = 3, 2 or 1 warpgroups (the largest that divides rep), the heads
// of one KV group at the same rows, so each K/V tile is copied once for G
// heads (the main path's rep 6 gives G = 3). Q, K and V tiles of 64 rows
// stay bf16 in shared memory in the 128-byte swizzled layout of
// wgmma.cuh (conflict-free for the copies and the tensor cores) and
// arrive by 16-byte cp.async. S = QK^T is a wgmma with both operands in
// shared memory; O += PV a wgmma with P in registers and V read
// MN-major; both accumulate in f32 registers. S is scaled by
// scale * log2(e) in f32 after the product (q is not rounded again), and
// the online softmax works on the accumulator fragments (row max and sum
// across the 4 lanes of a quad, exp2f). Two stages: tile t + 1 is
// copied while tile t is computed, one barrier a tile. P is rounded to
// bf16 in registers before PV: a rounding the plain version also makes
// (probabilities cast to the input dtype); the Pallas kernel keeps P in
// f32. Tiles wholly inside the band take no per-element mask; only the
// diagonal, window-edge and ragged tiles do. The output is staged in the
// Q tile and leaves by 16-byte stores.
//
// bf16, head dims 16, 32, 80 and 96 (flash_attention_mma_kernel): the same
// schedule on mma.sync m16n8k16 (rows of those widths are not whole
// 128-byte swizzle rows): each warp owns 16 of the block's 64 rows, Q as
// A fragments in registers (ldmatrix), K and V in padded row-major tiles
// (16-byte pad: conflict-free ldmatrix), V by ldmatrix.trans, tile t + 1
// copied while tile t is computed, a warp skipping the tiles none of its
// rows keeps.
//
// Given an lse pointer (the training forward, flash_attention_bwd.cu's
// input), every kernel also writes each row's log-sum-exp of its kept
// scaled scores, in natural-log units: the running max and sum it already
// holds in the log2 domain, (m + log2 l) ln 2, and kNegInit for a row that
// keeps no key.
//
// f32 (flash_attention_kernel) keeps the products on the FMA units in
// full f32, so the f32 card-vs-CPU model check and the 2e-5 kernel tests
// hold (TF32 would not): 4 threads per query row, each owning D/4
// columns; K/V tiles of 32 keys staged in shared memory; scores of a tile
// kept in registers, one online-softmax update per tile.
#include <type_traits>

#include "attention.cuh"
#include "wgmma.cuh"


namespace attn {

constexpr int kFlashThreads = 128;
constexpr int kRowsPerBlock = 32;
constexpr int kThreadsPerRow = kFlashThreads / kRowsPerBlock;   // 4
constexpr int kKeysPerTile = 32;

template <typename T, int D>
__global__ void __launch_bounds__(kFlashThreads) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ out, float* __restrict__ lse,
    int Sq, int Sk, int Hq, int Hkv, int causal, int window, int q_offset,
    float scale_log2) {
  constexpr int C4 = D / 4;                  // float4 chunks of a row
  constexpr int CPT = C4 / kThreadsPerRow;   // chunks per thread
  static_assert(C4 % kThreadsPerRow == 0, "D must be a multiple of 16");
  __shared__ float4 ks[kKeysPerTile][C4];
  __shared__ float4 vs[kKeysPerTile][C4];

  // Last query tiles first: under a causal mask they carry the most keys.
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (Hq / Hkv);
  const int row = threadIdx.x / kThreadsPerRow;
  const int g = threadIdx.x % kThreadsPerRow;   // owns chunks g, g+4, ...
  const int q0 = qt * kRowsPerBlock;
  const int qi = q0 + row;
  const bool row_ok = qi < Sq;
  const int qpos = qi + q_offset;

  float4 qr[CPT], acc[CPT];
  const size_t q_row = ((static_cast<size_t>(b) * Sq + (row_ok ? qi : 0))
                        * Hq + h) * D;
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int col = (g + c * kThreadsPerRow) * 4;
    qr[c] = row_ok ? scale4(Vec4<T>::load(q + q_row + col), scale_log2)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
    acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m = kNegInit;   // running max, log2 domain
  float l = 0.f;

  // Keys any row of this tile can keep.
  const int qpos_lo = q0 + q_offset;
  const int qpos_hi = min(q0 + kRowsPerBlock, Sq) - 1 + q_offset;
  int k_begin = 0;
  int k_end = Sk;
  if (causal) k_end = min(Sk, qpos_hi + 1);
  if (window > 0) k_begin = max(0, qpos_lo - window + 1);
  k_begin -= k_begin % kKeysPerTile;

  const size_t key_stride = static_cast<size_t>(Hkv) * D;
  const T* kb = k + (static_cast<size_t>(b) * Sk * Hkv + kvh) * D;
  const T* vb = v + (static_cast<size_t>(b) * Sk * Hkv + kvh) * D;

  for (int k0 = k_begin; k0 < k_end; k0 += kKeysPerTile) {
    __syncthreads();   // the previous tile is consumed
    for (int i = threadIdx.x; i < kKeysPerTile * C4; i += kFlashThreads) {
      const int j = i / C4;
      const int c = i % C4;
      float4 kk = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 vv = kk;
      if (k0 + j < Sk) {
        const size_t off = (k0 + j) * key_stride + c * 4;
        kk = Vec4<T>::load(kb + off);
        vv = Vec4<T>::load(vb + off);
      }
      ks[j][c] = kk;
      vs[j][c] = vv;
    }
    __syncthreads();

    float s[kKeysPerTile];
    float m_tile = kNegInit;
#pragma unroll
    for (int j = 0; j < kKeysPerTile; ++j) {
      float part = 0.f;
#pragma unroll
      for (int c = 0; c < CPT; ++c)
        part = dot4(qr[c], ks[j][g + c * kThreadsPerRow], part);
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      const int kpos = k0 + j;
      bool keep = kpos < Sk;
      if (causal) keep = keep && kpos <= qpos;
      if (window > 0) keep = keep && kpos > qpos - window;
      s[j] = keep ? part : -INFINITY;
      m_tile = fmaxf(m_tile, s[j]);
    }
    const float m_new = fmaxf(m, m_tile);
    const float alpha = exp2f(m - m_new);
    float l_tile = 0.f;
#pragma unroll
    for (int j = 0; j < kKeysPerTile; ++j) {
      s[j] = exp2f(s[j] - m_new);   // exactly 0 where masked
      l_tile += s[j];
    }
    l = l * alpha + l_tile;
    m = m_new;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[c] = scale4(acc[c], alpha);
#pragma unroll
    for (int j = 0; j < kKeysPerTile; ++j) {
#pragma unroll
      for (int c = 0; c < CPT; ++c)
        acc[c] = fma4(s[j], vs[j][g + c * kThreadsPerRow], acc[c]);
    }
  }

  if (!row_ok) return;
  if (lse != nullptr && g == 0)
    lse[(static_cast<size_t>(b) * Hq + h) * Sq + qi] = row_lse(m, l);
  const float inv = 1.f / (l > 0.f ? l : 1.f);
  const size_t o_row = ((static_cast<size_t>(b) * Sq + qi) * Hq + h) * D;
#pragma unroll
  for (int c = 0; c < CPT; ++c)
    Vec4<T>::store(out + o_row + (g + c * kThreadsPerRow) * 4,
                   scale4(acc[c], inv));
}

// ---------------------------------------------------------------------------
// bf16, head dims 16, 32, 80 and 96: tensor cores (mma.sync), cp.async
// double buffering
// ---------------------------------------------------------------------------

constexpr int kMmaThreads = 128;   // 4 warps
constexpr int kMmaRows = 64;       // query rows per block, 16 per warp
constexpr int kMmaKeys = 64;       // keys per K/V tile

// Row stride of every shared tile in bf16 elements: one 16-byte pad makes
// the stride an odd number of 16-byte units for every head dim here, so
// the 8 rows of an ldmatrix fall on 8 distinct bank groups.
template <int D>
__host__ __device__ constexpr int mma_stride() { return D + 8; }

// Q, then two stages of K, then two of V.
template <int D>
__host__ __device__ constexpr int flash_mma_smem_bytes() {
  return 5 * kMmaRows * mma_stride<D>() * 2;
}

// Copy `rows` rows of D bf16 (row stride `ld` elements in global memory)
// into a 64-row shared tile; rows at or past `valid` are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          size_t ld, int valid) {
  constexpr int CH = D / 8;   // 16-byte chunks of a row
  static_assert(kMmaRows * CH % kMmaThreads == 0, "whole rounds");
#pragma unroll
  for (int it = 0; it < kMmaRows * CH / kMmaThreads; ++it) {
    const int i = threadIdx.x + it * kMmaThreads;
    const int r = i / CH;
    const int c = i % CH;
    const bool ok = r < valid;
    cp_async16(smem_u32(dst + r * mma_stride<D>() + c * 8),
               src + (ok ? r : 0) * ld + c * 8, ok);
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads) flash_attention_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
    float* __restrict__ lse, int Sq, int Sk, int Hq, int Hkv, int causal,
    int window, int q_offset, float scale_log2) {
  constexpr int SD = mma_stride<D>();
  constexpr int KSTEPS = D / 16;        // k-steps of QK^T
  constexpr int DT = D / 8;             // 8-column tiles of O
  constexpr int NT = kMmaKeys / 8;      // 8-key tiles of S
  static_assert(D % 16 == 0, "D must be a multiple of 16");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + kMmaRows * SD;        // [2][64][SD]
  __nv_bfloat16* vs = ks + 2 * kMmaKeys * SD;    // [2][64][SD]

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  // Last query tiles first (slowest grid axis): under a causal mask they
  // carry the most keys.
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kMmaRows;
  const int kvh = h / (Hq / Hkv);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;      // row of the quad in the fragment
  const int tq = lane & 3;      // lane within the quad
  const size_t q_ld = static_cast<size_t>(Hq) * D;
  __nv_bfloat16* ob = out + ((static_cast<size_t>(b) * Sq + q0) * Hq + h) * D;

  // Keys any row of this block can keep.
  const int qpos_lo = q0 + q_offset;
  const int qpos_hi = min(q0 + kMmaRows, Sq) - 1 + q_offset;
  int k_begin = 0;
  int k_end = Sk;
  if (causal) k_end = min(Sk, qpos_hi + 1);
  if (window > 0) k_begin = max(0, qpos_lo - window + 1);
  k_begin -= k_begin % kMmaKeys;
  const int n_tiles =
      k_end > k_begin ? (k_end - k_begin + kMmaKeys - 1) / kMmaKeys : 0;
  if (n_tiles == 0) {   // no row keeps a key: write 0
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    for (int i = threadIdx.x; i < kMmaRows * (D / 8); i += kMmaThreads) {
      const int r = i / (D / 8);
      if (q0 + r < Sq)
        *reinterpret_cast<uint4*>(ob + r * q_ld + (i % (D / 8)) * 8) = zero;
    }
    const int r = threadIdx.x;
    if (lse != nullptr && r < kMmaRows && q0 + r < Sq)
      lse[(static_cast<size_t>(b) * Hq + h) * Sq + q0 + r] = kNegInit;
    return;
  }

  const size_t kv_ld = static_cast<size_t>(Hkv) * D;
  const __nv_bfloat16* kb = k + (static_cast<size_t>(b) * Sk * Hkv + kvh) * D;
  const __nv_bfloat16* vb = v + (static_cast<size_t>(b) * Sk * Hkv + kvh) * D;
  load_tile<D>(qs, q + ((static_cast<size_t>(b) * Sq + q0) * Hq + h) * D,
               q_ld, Sq - q0);
  load_tile<D>(ks, kb + k_begin * kv_ld, kv_ld, Sk - k_begin);
  load_tile<D>(vs, vb + k_begin * kv_ld, kv_ld, Sk - k_begin);
  cp_async_commit();

  // This warp's rows: positions [wq_lo, wq_hi]; this lane holds rows
  // g and g + 8 of them.
  const int row0 = warp * 16;
  const int wq_lo = q0 + row0 + q_offset;
  const int wq_hi = wq_lo + 15;
  const int qpos_g = wq_lo + g;

  uint32_t qf[KSTEPS][4];
  float o[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
    o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  float m[2] = {kNegInit, kNegInit};   // running max, log2 domain
  float l[2] = {0.f, 0.f};             // this lane's part of the row sums

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = k_begin + t * kMmaKeys;
    cp_async_wait<0>();
    __syncthreads();   // tile t landed; every warp is done with tile t - 1
    if (t + 1 < n_tiles) {   // tile t + 1 into the stage tile t - 1 used
      const int st = (t + 1) & 1;
      const int k1 = k0 + kMmaKeys;
      load_tile<D>(ks + st * kMmaKeys * SD, kb + k1 * kv_ld, kv_ld, Sk - k1);
      load_tile<D>(vs + st * kMmaKeys * SD, vb + k1 * kv_ld, kv_ld, Sk - k1);
      cp_async_commit();
    }
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk)
        ldsm_x4(smem_u32(qs + (row0 + (lane & 15)) * SD + kk * 16 +
                         (lane >> 4) * 8),
                qf[kk]);
    }
    // A tile no row of this warp keeps.
    if (causal && k0 > wq_hi) continue;
    if (window > 0 && k0 + kMmaKeys - 1 <= wq_lo - window) continue;

    const __nv_bfloat16* kt = ks + (t & 1) * kMmaKeys * SD;
    const __nv_bfloat16* vt = vs + (t & 1) * kMmaKeys * SD;

    // S = Q K^T (16 rows x 64 keys of this warp)
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bk[4];
        ldsm_x4(smem_u32(kt + (np * 16 + (lane & 7) + (lane >> 4) * 8) * SD +
                         kk * 16 + ((lane >> 3) & 1) * 8),
                bk);
        mma_bf16(s[2 * np], qf[kk], bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], qf[kk], bk[2], bk[3]);
      }
    }

    // Scale into the log2 domain; mask only tiles that cross the band.
    const bool full = k0 + kMmaKeys <= Sk &&
                      (!causal || k0 + kMmaKeys - 1 <= wq_lo) &&
                      (window <= 0 || k0 > wq_hi - window);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float x = s[n][c] * scale_log2;
        if (!full) {
          const int kpos = k0 + n * 8 + tq * 2 + (c & 1);
          const int qpos = qpos_g + (c >> 1) * 8;
          bool keep = kpos < Sk;
          if (causal) keep = keep && kpos <= qpos;
          if (window > 0) keep = keep && kpos > qpos - window;
          x = keep ? x : -INFINITY;
        }
        s[n][c] = x;
        mx[c >> 1] = fmaxf(mx[c >> 1], x);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float alpha = exp2f(m[i] - mx[i]);
      m[i] = mx[i];
      l[i] *= alpha;
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        o[d][2 * i] *= alpha;
        o[d][2 * i + 1] *= alpha;
      }
    }

    // P = exp2(S - m), exactly 0 where masked; as bf16 A fragments.
    uint32_t pf[NT / 2][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float p0 = exp2f(s[n][0] - m[0]);
      const float p1 = exp2f(s[n][1] - m[0]);
      const float p2 = exp2f(s[n][2] - m[1]);
      const float p3 = exp2f(s[n][3] - m[1]);
      l[0] += p0 + p1;
      l[1] += p2 + p3;
      pf[n / 2][(n & 1) * 2] = pack_bf16(p0, p1);
      pf[n / 2][(n & 1) * 2 + 1] = pack_bf16(p2, p3);
    }

    // O += P V
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        uint32_t bv[4];
        ldsm_x4_trans(smem_u32(vt + (kk * 16 + (lane & 7) +
                                     ((lane >> 3) & 1) * 8) * SD +
                               dp * 16 + (lane >> 4) * 8),
                      bv);
        mma_bf16(o[2 * dp], pf[kk], bv[0], bv[1]);
        mma_bf16(o[2 * dp + 1], pf[kk], bv[2], bv[3]);
      }
    }
  }

  // Normalise; stage the warp's 16 rows in its own Q rows, then store 16
  // bytes a lane. Only this warp ever read those rows.
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    inv[i] = 1.f / (l[i] > 0.f ? l[i] : 1.f);
    const int r = q0 + row0 + g + 8 * i;
    if (lse != nullptr && tq == 0 && r < Sq)
      lse[(static_cast<size_t>(b) * Hq + h) * Sq + r] = row_lse(m[i], l[i]);
  }
  __nv_bfloat16* os = qs + row0 * SD;
#pragma unroll
  for (int d = 0; d < DT; ++d) {
    const int col = d * 8 + tq * 2;
    *reinterpret_cast<uint32_t*>(os + g * SD + col) =
        pack_bf16(o[d][0] * inv[0], o[d][1] * inv[0]);
    *reinterpret_cast<uint32_t*>(os + (g + 8) * SD + col) =
        pack_bf16(o[d][2] * inv[1], o[d][3] * inv[1]);
  }
  __syncwarp();
#pragma unroll
  for (int it = 0; it < D / 16; ++it) {   // 16 rows of D / 8 chunks
    const int i = lane + it * 32;
    const int r = i / (D / 8);
    const int c = i % (D / 8);
    if (q0 + row0 + r < Sq)
      *reinterpret_cast<uint4*>(ob + (row0 + r) * q_ld + c * 8) =
          *reinterpret_cast<const uint4*>(os + r * SD + c * 8);
  }
}

// ---------------------------------------------------------------------------
// bf16, head dims 64 and 128: warpgroup MMA (wgmma), cp.async double
// buffering
// ---------------------------------------------------------------------------

// The Q tiles of the block's G query heads, then two stages of K, then
// two of V: 64-row swizzled tiles (wgmma.cuh), each 1024-byte aligned.
template <int D, int G>
__host__ __device__ constexpr int flash_wg_smem_bytes() {
  return (G + 4) * 64 * D * 2;
}

// Copy 64 rows of D bf16 (row stride `ld` elements in global memory) into
// a swizzled tile; rows at or past `valid` are zero-filled. Consecutive
// lanes take consecutive 16-byte pieces of a row; NTH threads share it.
template <int D, int NTH>
__device__ __forceinline__ void load_sw_tile(__nv_bfloat16* dst,
                                             const __nv_bfloat16* src,
                                             size_t ld, int valid) {
  constexpr int CH = D / 8;
#pragma unroll
  for (int i = threadIdx.x; i < 64 * CH; i += NTH) {
    const int r = i / CH;
    const int c = (i % CH) * 8;
    const bool ok = r < valid;
    cp_async16(smem_u32(dst + sw128_offset(r, c, 64)),
               src + (ok ? r : 0) * ld + c, ok);
  }
}

// A block of G warpgroups owns 64 query rows of G query heads of one KV
// group: they share every K/V tile, so a tile is copied once for G heads.
template <int D, int G>
__global__ void __launch_bounds__(128 * G) flash_attention_wg_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
    float* __restrict__ lse, int Sq, int Sk, int Hq, int Hkv, int causal,
    int window, int q_offset, float scale_log2) {
  constexpr int ROWS = 64;              // query rows of a warpgroup
  constexpr int NTH = 128 * G;          // threads of the block
  constexpr int NT = kMmaKeys / 8;      // 8-key tiles of S
  constexpr int DT = D / 8;             // 8-column tiles of O
  constexpr int TILE = 64 * D;          // elements of one tile
  constexpr uint32_t BLOCK = 64 * 128;  // bytes of a 64-column block
  static_assert(D % 64 == 0, "swizzled tiles need D a multiple of 64");
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __nv_bfloat16* qall = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qall + G * TILE;  // [2] tiles
  __nv_bfloat16* vs = ks + 2 * TILE;    // [2] tiles

  const int h0 = blockIdx.x * G;        // first query head of the block
  const int b = blockIdx.y;
  // Last query tiles first (slowest grid axis): under a causal mask they
  // carry the most keys.
  const int q0 = (gridDim.z - 1 - blockIdx.z) * ROWS;
  const int kvh = h0 / (Hq / Hkv);
  const int wg = threadIdx.x / 128;     // this warpgroup's head: h0 + wg
  const int warp = threadIdx.x / 32 % 4;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const size_t q_ld = static_cast<size_t>(Hq) * D;
  __nv_bfloat16* ob =
      out + ((static_cast<size_t>(b) * Sq + q0) * Hq + h0 + wg) * D;

  // Keys any row of this block can keep.
  const int qpos_lo = q0 + q_offset;
  const int qpos_hi = min(q0 + ROWS, Sq) - 1 + q_offset;
  int k_begin = 0;
  int k_end = Sk;
  if (causal) k_end = min(Sk, qpos_hi + 1);
  if (window > 0) k_begin = max(0, qpos_lo - window + 1);
  k_begin -= k_begin % kMmaKeys;
  const int n_tiles =
      k_end > k_begin ? (k_end - k_begin + kMmaKeys - 1) / kMmaKeys : 0;
  if (n_tiles == 0) {   // no row keeps a key: write 0
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    for (int i = threadIdx.x % 128; i < ROWS * DT; i += 128) {
      const int r = i / DT;
      if (q0 + r < Sq)
        *reinterpret_cast<uint4*>(ob + r * q_ld + (i % DT) * 8) = zero;
    }
    const int r = threadIdx.x % 128;
    if (lse != nullptr && r < ROWS && q0 + r < Sq)
      lse[(static_cast<size_t>(b) * Hq + h0 + wg) * Sq + q0 + r] = kNegInit;
    return;
  }

  const size_t kv_ld = static_cast<size_t>(Hkv) * D;
  const __nv_bfloat16* kb = k + (static_cast<size_t>(b) * Sk * Hkv + kvh) * D;
  const __nv_bfloat16* vb = v + (static_cast<size_t>(b) * Sk * Hkv + kvh) * D;
  for (int j = 0; j < G; ++j)
    load_sw_tile<D, NTH>(
        qall + j * TILE,
        q + ((static_cast<size_t>(b) * Sq + q0) * Hq + h0 + j) * D, q_ld,
        Sq - q0);
  load_sw_tile<D, NTH>(ks, kb + k_begin * kv_ld, kv_ld, Sk - k_begin);
  load_sw_tile<D, NTH>(vs, vb + k_begin * kv_ld, kv_ld, Sk - k_begin);
  cp_async_commit();

  // This warp's rows of the warpgroup's 64: positions [wq_lo, wq_hi];
  // this lane holds rows g and g + 8 of them.
  const int wq_lo = q0 + warp * 16 + q_offset;
  const int wq_hi = wq_lo + 15;
  const int qpos_g = wq_lo + g;
  __nv_bfloat16* qs = qall + wg * TILE;   // this warpgroup's Q tile
  const uint32_t q_addr = smem_u32(qs);

  float o[D / 2];   // O fragments: 8-column tile d holds o[4d .. 4d+3]
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInit, kNegInit};   // running max, log2 domain
  float l[2] = {0.f, 0.f};             // this lane's part of the row sums

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = k_begin + t * kMmaKeys;
    cp_async_wait<0>();
    fence_proxy_async();   // the copies are visible to the tensor cores
    __syncthreads();   // tile t landed; every warpgroup is done with t - 1
    if (t + 1 < n_tiles) {   // tile t + 1 into the stage tile t - 1 used
      const int st = (t + 1) & 1;
      const int k1 = k0 + kMmaKeys;
      load_sw_tile<D, NTH>(ks + st * TILE, kb + k1 * kv_ld, kv_ld, Sk - k1);
      load_sw_tile<D, NTH>(vs + st * TILE, vb + k1 * kv_ld, kv_ld, Sk - k1);
      cp_async_commit();
    }
    const uint32_t k_addr = smem_u32(ks + (t & 1) * TILE);
    const uint32_t v_addr = smem_u32(vs + (t & 1) * TILE);

    // S = Q K^T, 64 rows x 64 keys, both operands K-major in shared
    // memory; k-step kk is 32 bytes into the rows of column block kk / 4.
    float s[NT * 4];
#pragma unroll
    for (int i = 0; i < NT * 4; ++i) s[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk >> 2) * BLOCK + (kk & 3) * 32;
      wgmma_ss_n64(s, wgmma_desc(q_addr + off, BLOCK, 1024),
                   wgmma_desc(k_addr + off, BLOCK, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();

    // Online softmax in the log2 domain; mask only tiles that cross the
    // band. P = exp2(S scale_log2 - m) in one FMA and exp2, exactly 0
    // where masked, goes to bf16 A fragments. scale_log2 > 0, so the
    // scaled row max is the raw row max scaled.
    const bool full = k0 + kMmaKeys <= Sk &&
                      (!causal || k0 + kMmaKeys - 1 <= wq_lo) &&
                      (window <= 0 || k0 > wq_hi - window);
    float mx[2] = {-INFINITY, -INFINITY};   // raw row max of the tile
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float x = s[4 * n + c];
        if (!full) {
          const int kpos = k0 + n * 8 + tq * 2 + (c & 1);
          const int qpos = qpos_g + (c >> 1) * 8;
          bool keep = kpos < Sk;
          if (causal) keep = keep && kpos <= qpos;
          if (window > 0) keep = keep && kpos > qpos - window;
          x = keep ? x : -INFINITY;
        }
        s[4 * n + c] = x;
        mx[c >> 1] = fmaxf(mx[c >> 1], x);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i] * scale_log2);
      const float alpha = exp2f(m[i] - m_new);
      m[i] = m_new;
      l[i] *= alpha;
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        o[4 * d + 2 * i] *= alpha;
        o[4 * d + 2 * i + 1] *= alpha;
      }
    }
    uint32_t pf[NT / 2][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float p0 = exp2f(fmaf(s[4 * n], scale_log2, -m[0]));
      const float p1 = exp2f(fmaf(s[4 * n + 1], scale_log2, -m[0]));
      const float p2 = exp2f(fmaf(s[4 * n + 2], scale_log2, -m[1]));
      const float p3 = exp2f(fmaf(s[4 * n + 3], scale_log2, -m[1]));
      l[0] += p0 + p1;
      l[1] += p2 + p3;
      pf[n / 2][(n & 1) * 2] = pack_bf16(p0, p1);
      pf[n / 2][(n & 1) * 2 + 1] = pack_bf16(p2, p3);
    }

    // O += P V: P from registers, V MN-major in shared memory; k-step kk
    // is 16 rows (2048 bytes) down the tile.
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk)
      WgmmaRS<D>::run(o, pf[kk], wgmma_desc(v_addr + kk * 2048, BLOCK, 1024),
                      1);
    wgmma_commit();
    wgmma_wait<0>();
  }

  // Normalise; stage the 64 rows in the swizzled Q tile (the lanes of a
  // warp write 32 distinct banks), then store 16 bytes a lane.
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    inv[i] = 1.f / (l[i] > 0.f ? l[i] : 1.f);
    const int r = q0 + warp * 16 + g + 8 * i;
    if (lse != nullptr && tq == 0 && r < Sq)
      lse[(static_cast<size_t>(b) * Hq + h0 + wg) * Sq + r] =
          row_lse(m[i], l[i]);
  }
  __syncthreads();   // every wgmma read of the Q tile is done
#pragma unroll
  for (int d = 0; d < DT; ++d) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<uint32_t*>(
          qs + sw128_offset(warp * 16 + g + i * 8, d * 8 + tq * 2, 64)) =
          pack_bf16(o[4 * d + 2 * i] * inv[i], o[4 * d + 2 * i + 1] * inv[i]);
  }
  __syncwarp();
#pragma unroll
  for (int it = 0; it < 16 * DT / 32; ++it) {   // this warp's 16 rows
    const int i = lane + it * 32;
    const int r = warp * 16 + i / DT;
    const int c = (i % DT) * 8;
    if (q0 + r < Sq)
      *reinterpret_cast<uint4*>(ob + r * q_ld + c) =
          *reinterpret_cast<const uint4*>(qs + sw128_offset(r, c, 64));
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

struct FlashLaunch {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* lse;
  int B, Sq, Sk, Hq, Hkv, causal, window, q_offset;
  float scale_log2;
  cudaStream_t stream;

  template <int D, int G>
  int wg_launch() const {
    const int n_q = (Sq + 63) / 64;
    if (n_q > 65535) return static_cast<int>(cudaErrorInvalidValue);
    constexpr int smem = flash_wg_smem_bytes<D, G>();
    static int granted[kMaxDevices] = {};
    const int err = allow_smem((const void*)flash_attention_wg_kernel<D, G>,
                               smem, granted);
    if (err) return err;
    flash_attention_wg_kernel<D, G><<<dim3(Hq / G, B, n_q), 128 * G, smem,
                                      stream>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v),
        static_cast<__nv_bfloat16*>(out), lse, Sq, Sk, Hq, Hkv, causal,
        window, q_offset, scale_log2);
    return static_cast<int>(cudaGetLastError());
  }

  template <typename T, int D>
  int operator()() const {
    if constexpr (std::is_same_v<T, __nv_bfloat16> && D % 64 == 0) {
      // As many query heads of a KV group per block as divide rep, up to 3.
      const int rep = Hq / Hkv;
      if (rep % 3 == 0) return wg_launch<D, 3>();
      if (rep % 2 == 0) return wg_launch<D, 2>();
      return wg_launch<D, 1>();
    } else if constexpr (std::is_same_v<T, __nv_bfloat16>) {
      const int n_q = (Sq + kMmaRows - 1) / kMmaRows;
      if (n_q > 65535) return static_cast<int>(cudaErrorInvalidValue);
      constexpr int smem = flash_mma_smem_bytes<D>();
      static int granted[kMaxDevices] = {};
      const int err = allow_smem(
          (const void*)flash_attention_mma_kernel<D>, smem, granted);
      if (err) return err;
      flash_attention_mma_kernel<D><<<dim3(Hq, B, n_q), kMmaThreads, smem,
                                      stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<T*>(out), lse, Sq, Sk, Hq,
          Hkv, causal, window, q_offset, scale_log2);
    } else {
      const dim3 grid((Sq + kRowsPerBlock - 1) / kRowsPerBlock, Hq, B);
      flash_attention_kernel<T, D><<<grid, kFlashThreads, 0, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<T*>(out), lse, Sq, Sk, Hq,
          Hkv, causal, window, q_offset, scale_log2);
    }
    return static_cast<int>(cudaGetLastError());
  }
};

}  // namespace attn

// dtype: 0 = f32, 1 = bf16. window <= 0 means no window. Query row i sits
// at position i + q_offset. lse (B, Hq, Sq) f32, or null: each row's
// log-sum-exp of its kept scaled scores in natural-log units, kNegInit for
// a row that keeps no key (what the backward pass recomputes P from).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, float* lse,
    int B, int Sq, int Sk, int Hq, int Hkv, int D, int dtype, int causal,
    int window, int q_offset, float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Hkv <= 0 || Hq % Hkv != 0 ||
      Hq > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const attn::FlashLaunch f{q, k, v, out, lse, B, Sq, Sk, Hq, Hkv, causal,
                            window, q_offset, scale * attn::kLog2e,
                            static_cast<cudaStream_t>(stream)};
  return attn::dispatch(dtype, D, f);
}

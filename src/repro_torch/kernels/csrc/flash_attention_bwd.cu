// flash_attention_bwd: dq, dk and dv of flash_attention.cu's function,
// the FlashAttention-2 backward. q, dq (B, Sq, Hq, D); k, v, dk, dv
// (B, Sk, Hkv, D); out, dout (B, Sq, Hq, D) the forward's output and its
// gradient; lse (B, Hq, Sq) f32, each row's log-sum-exp of its kept scaled
// scores in natural-log units as the forward wrote it (kNegInit for a row
// that keeps no key); all tensors of one element type (bf16 or f32) but
// lse. Same mask as the forward: query i at position i + q_offset, KV head
// h / rep, keep key j iff j <= pos (causal) and j > pos - window.
//
// Replaces no TPU kernel: the JAX package has no backward Pallas kernel
// and gets the same gradient by autodiff of flash_attention_ref /
// flash_attention_xla (src/repro/kernels/ref.py). It replaces the port's
// earlier backward, which recomputed the dense attention through the plain
// version in f32 under autograd: several f32 (B, Hq, Sq, Sk) score tensors
// a layer.
//
// Three launches on the caller's stream, all deterministic (no atomics):
//   1. Di = rowsum(dO * O) in f32, into a (B, Hq, Sq) scratch;
//   2. dK and dV: a block owns a tile of keys of one KV head and walks the
//      rep query heads of its group, and for each the query tiles whose
//      rows see any of its keys (the inverse of the forward's band); it
//      recomputes S^T = K Q^T and P^T = exp(S^T scale - lse), then
//      dV += P^T dO, dP^T = V dO^T, dS^T = P^T (dP^T - Di),
//      dK += dS^T Q, summing the group's heads in registers;
//   3. dQ: a block owns a tile of query rows of one head and walks the key
//      tiles of the forward's band: S, P, dP = dO V^T, dS, dQ += dS K.
// dQ and dK take the scale at the end. A masked pair, a query row past Sq
// and a key past Sk give P = dS = 0, so a row that keeps no key (out = 0)
// has zero gradient and adds nothing to dK and dV.
//
// Bound on an H100: bytes. At the training call of the main path
// (qwen2-1.5b: B 4, S 512, 12 query heads of 128 over 2 KV heads, bf16,
// causal) the call must move 29,556,736 bytes (q, k, v, out, dO, lse, Di,
// dq, dk, dv once each), 8.8 us at 3.35 TB/s, against 8.07 GFLOP of the
// five products over the kept pairs, 8.2 us at 989 TFLOP/s. The kernels
// recompute S in both passes and dP in the dQ pass (seven products, 14
// FLOPs per pair and head dim), and reread Q, dO, K and V once per tile.
//
// bf16 (the mma kernels, every head dim): four warps, each owning 16 rows
// of the block's 64 (keys in pass 2, queries in pass 3), mma.sync
// m16n8k16 with f32 accumulators; the owned K/V (or Q/dO) tile and two
// stages of the streamed 32-row tiles sit in padded row-major shared
// tiles, copied by cp.async (tile t + 1 while tile t is computed);
// fragments come by ldmatrix (.trans for the B operand of dV, dK and dQ).
// P and dS are rounded to bf16 only as operands of the tensor-core
// products; P is the rounding the forward and the plain version make.
// The accumulators (dK and dV: 2 x 16 x D f32 a warp) stay in registers;
// the A fragments of the owned tile are reread from shared memory every
// tile, which keeps a thread under 255 registers at D = 128. A warp skips
// the tiles none of its rows sees, and only the tiles that cross the band
// or a ragged edge take a per-element mask.
//
// f32 (the FMA kernels): products in full f32 on the FMA units, as the
// forward's f32 kernel (TF32 would not hold the 2e-5 checks): 4 threads a
// row, each owning D/4 columns of it; the streamed tile of 32 rows staged
// in shared memory; one (row, streamed row) pair at a time.
//
// This is the first, simple design: one warp per 16 rows of a 64-row tile
// leaves dK/dV's grid at B x Hkv x Sk/64 blocks. wgmma, TMA and warp
// specialisation are later work.
#include <type_traits>

#include "attention.cuh"

namespace attn {

constexpr int kBwdThreads = 128;   // 4 warps
constexpr int kBwdOwn = 64;        // rows a bf16 block owns, 16 a warp
constexpr int kBwdStep = 32;       // rows of a streamed tile
constexpr int kBwdF32Rows = 32;    // rows an f32 block owns, 4 threads each

// ---------------------------------------------------------------------------
// 1. Di = rowsum(dO * O)
// ---------------------------------------------------------------------------

// Four threads a (b, i, h) row, rows in memory order; Di in (B, Hq, Sq).
template <typename T, int D>
__global__ void __launch_bounds__(kBwdThreads) flash_bwd_dot_kernel(
    const T* __restrict__ dout, const T* __restrict__ out,
    float* __restrict__ di, long long n_rows, int Sq, int Hq) {
  constexpr int C4 = D / 4;
  const long long row =
      (static_cast<long long>(blockIdx.x) * kBwdThreads + threadIdx.x) / 4;
  const int g = threadIdx.x % 4;
  float acc = 0.f;
  if (row < n_rows) {
    const T* a = dout + row * D;
    const T* o = out + row * D;
    for (int c = g; c < C4; c += 4)
      acc = dot4(Vec4<T>::load(a + c * 4), Vec4<T>::load(o + c * 4), acc);
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  if (row < n_rows && g == 0) {
    const int h = static_cast<int>(row % Hq);
    const long long bi = row / Hq;
    const long long b = bi / Sq;
    di[(b * Hq + h) * Sq + bi % Sq] = acc;
  }
}

// The query rows [lo, hi) whose positions see any key of [k0, k_hi]:
// pos >= k0 (causal) and pos - window < k_hi (window); lo rounded down to
// a streamed tile.
struct QueryBand {
  long long lo, hi;
  __device__ QueryBand(int k0, int k_hi, int Sq, int causal, int window,
                       int q_offset) {
    lo = 0;
    hi = Sq;
    if (causal) {
      const long long first = static_cast<long long>(k0) - q_offset;
      lo = first > 0 ? first : 0;
    }
    if (window > 0) {
      const long long last = static_cast<long long>(k_hi) + window - q_offset;
      hi = last < hi ? last : hi;
    }
    lo -= lo % kBwdStep;
  }
  __device__ int tiles() const {
    return hi > lo ? static_cast<int>((hi - lo + kBwdStep - 1) / kBwdStep)
                   : 0;
  }
};

__device__ __forceinline__ bool kept(int key, long long qpos, int causal,
                                     int window) {
  bool keep = true;
  if (causal) keep = key <= qpos;
  if (window > 0) keep = keep && key > qpos - window;
  return keep;
}

// ---------------------------------------------------------------------------
// f32: FMA units
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kBwdThreads) flash_bwd_dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ di,
    T* __restrict__ dk, T* __restrict__ dv, int Sq, int Sk, int Hq, int Hkv,
    int causal, int window, int q_offset, float scale, float scale_log2) {
  constexpr int C4 = D / 4;
  constexpr int CPT = C4 / 4;
  static_assert(C4 % 4 == 0, "D must be a multiple of 16");
  __shared__ float4 qs[kBwdStep][C4];
  __shared__ float4 os[kBwdStep][C4];   // dO
  __shared__ float ls[kBwdStep];        // lse, log2 domain
  __shared__ float ds[kBwdStep];        // Di

  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int rep = Hq / Hkv;
  const int row = threadIdx.x / 4;
  const int g = threadIdx.x % 4;          // owns chunks g, g+4, ...
  const int k0 = blockIdx.x * kBwdF32Rows;
  const int kj = k0 + row;
  const bool key_ok = kj < Sk;
  const size_t kv_row =
      ((static_cast<size_t>(b) * Sk + (key_ok ? kj : 0)) * Hkv + kvh) * D;

  float4 kr[CPT], vr[CPT], dka[CPT], dva[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int col = (g + c * 4) * 4;
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    kr[c] = key_ok ? Vec4<T>::load(k + kv_row + col) : z;
    vr[c] = key_ok ? Vec4<T>::load(v + kv_row + col) : z;
    dka[c] = dva[c] = z;
  }

  const QueryBand band(k0, min(k0 + kBwdF32Rows, Sk) - 1, Sq, causal,
                       window, q_offset);
  const size_t q_ld = static_cast<size_t>(Hq) * D;
  for (int hh = 0; hh < rep; ++hh) {
    const int h = kvh * rep + hh;
    const T* qb = q + (static_cast<size_t>(b) * Sq * Hq + h) * D;
    const T* ob = dout + (static_cast<size_t>(b) * Sq * Hq + h) * D;
    const size_t lrow = (static_cast<size_t>(b) * Hq + h) * Sq;
    for (long long i0 = band.lo; i0 < band.hi; i0 += kBwdStep) {
      __syncthreads();   // the previous tile is consumed
      for (int x = threadIdx.x; x < kBwdStep * C4; x += kBwdThreads) {
        const int j = x / C4;
        const int c = x % C4;
        float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
        float4 o = a;
        if (i0 + j < Sq) {
          const size_t off = (i0 + j) * q_ld + c * 4;
          a = Vec4<T>::load(qb + off);
          o = Vec4<T>::load(ob + off);
        }
        qs[j][c] = a;
        os[j][c] = o;
      }
      if (threadIdx.x < kBwdStep) {
        const long long i = i0 + threadIdx.x;
        ls[threadIdx.x] = i < Sq ? lse[lrow + i] * kLog2e : 0.f;
        ds[threadIdx.x] = i < Sq ? di[lrow + i] : 0.f;
      }
      __syncthreads();
      for (int j = 0; j < kBwdStep; ++j) {
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          s = dot4(kr[c], qs[j][g + c * 4], s);
          dp = dot4(vr[c], os[j][g + c * 4], dp);
        }
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        s += __shfl_xor_sync(0xffffffffu, s, 2);
        dp += __shfl_xor_sync(0xffffffffu, dp, 1);
        dp += __shfl_xor_sync(0xffffffffu, dp, 2);
        const long long qi = i0 + j;
        const bool keep = key_ok && qi < Sq &&
                          kept(kj, qi + q_offset, causal, window);
        const float p = keep ? exp2f(fmaf(s, scale_log2, -ls[j])) : 0.f;
        const float dsv = keep ? p * (dp - ds[j]) : 0.f;
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          dva[c] = fma4(p, os[j][g + c * 4], dva[c]);
          dka[c] = fma4(dsv, qs[j][g + c * 4], dka[c]);
        }
      }
    }
  }
  if (!key_ok) return;
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int col = (g + c * 4) * 4;
    Vec4<T>::store(dk + kv_row + col, scale4(dka[c], scale));
    Vec4<T>::store(dv + kv_row + col, dva[c]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kBwdThreads) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ di,
    T* __restrict__ dq, int Sq, int Sk, int Hq, int Hkv, int causal,
    int window, int q_offset, float scale, float scale_log2) {
  constexpr int C4 = D / 4;
  constexpr int CPT = C4 / 4;
  static_assert(C4 % 4 == 0, "D must be a multiple of 16");
  __shared__ float4 ks[kBwdStep][C4];
  __shared__ float4 vs[kBwdStep][C4];

  // Last query tiles first: under a causal mask they carry the most keys.
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBwdF32Rows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (Hq / Hkv);
  const int row = threadIdx.x / 4;
  const int g = threadIdx.x % 4;
  const int qi = q0 + row;
  const bool row_ok = qi < Sq;
  const int qpos = qi + q_offset;
  const size_t q_row =
      ((static_cast<size_t>(b) * Sq + (row_ok ? qi : 0)) * Hq + h) * D;
  const size_t lrow = (static_cast<size_t>(b) * Hq + h) * Sq + qi;
  const float l2 = row_ok ? lse[lrow] * kLog2e : 0.f;
  const float dii = row_ok ? di[lrow] : 0.f;

  float4 qr[CPT], orow[CPT], dqa[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int col = (g + c * 4) * 4;
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    qr[c] = row_ok ? Vec4<T>::load(q + q_row + col) : z;
    orow[c] = row_ok ? Vec4<T>::load(dout + q_row + col) : z;
    dqa[c] = z;
  }

  // Keys any row of this tile can keep (the forward's band).
  const int qpos_lo = q0 + q_offset;
  const int qpos_hi = min(q0 + kBwdF32Rows, Sq) - 1 + q_offset;
  int k_begin = 0;
  int k_end = Sk;
  if (causal) k_end = min(Sk, qpos_hi + 1);
  if (window > 0) k_begin = max(0, qpos_lo - window + 1);
  k_begin -= k_begin % kBwdStep;

  const size_t key_stride = static_cast<size_t>(Hkv) * D;
  const T* kb = k + (static_cast<size_t>(b) * Sk * Hkv + kvh) * D;
  const T* vb = v + (static_cast<size_t>(b) * Sk * Hkv + kvh) * D;
  for (int k0 = k_begin; k0 < k_end; k0 += kBwdStep) {
    __syncthreads();   // the previous tile is consumed
    for (int x = threadIdx.x; x < kBwdStep * C4; x += kBwdThreads) {
      const int j = x / C4;
      const int c = x % C4;
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
    for (int j = 0; j < kBwdStep; ++j) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        s = dot4(qr[c], ks[j][g + c * 4], s);
        dp = dot4(orow[c], vs[j][g + c * 4], dp);
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      dp += __shfl_xor_sync(0xffffffffu, dp, 1);
      dp += __shfl_xor_sync(0xffffffffu, dp, 2);
      const int kpos = k0 + j;
      const bool keep = row_ok && kpos < Sk &&
                        kept(kpos, qpos, causal, window);
      const float p = keep ? exp2f(fmaf(s, scale_log2, -l2)) : 0.f;
      const float dsv = keep ? p * (dp - dii) : 0.f;
#pragma unroll
      for (int c = 0; c < CPT; ++c)
        dqa[c] = fma4(dsv, ks[j][g + c * 4], dqa[c]);
    }
  }
  if (!row_ok) return;
#pragma unroll
  for (int c = 0; c < CPT; ++c)
    Vec4<T>::store(dq + q_row + (g + c * 4) * 4, scale4(dqa[c], scale));
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync), cp.async double buffering
// ---------------------------------------------------------------------------

// Row stride of every shared tile in bf16 elements: a 16-byte pad makes it
// an odd number of 16-byte units for every head dim, so the 8 rows of an
// ldmatrix fall on 8 distinct bank groups.
template <int D>
__host__ __device__ constexpr int bwd_stride() { return D + 8; }

// The owned 64-row tiles (two), two stages of the two streamed 32-row
// tiles, and (pass 2) two stages of the streamed rows' lse and Di.
template <int D>
__host__ __device__ constexpr int bwd_smem_bytes() {
  return (2 * kBwdOwn + 4 * kBwdStep) * bwd_stride<D>() * 2 +
         4 * kBwdStep * 4;
}

// Copy `ROWS` rows of D bf16 (row stride `ld` elements in global memory)
// into a padded shared tile; rows at or past `valid` are zero-filled.
template <int D, int ROWS>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          size_t ld, int valid) {
  constexpr int CH = D / 8;   // 16-byte chunks of a row
  for (int i = threadIdx.x; i < ROWS * CH; i += kBwdThreads) {
    const int r = i / CH;
    const int c = i % CH;
    const bool ok = r < valid;
    cp_async16(smem_u32(dst + r * bwd_stride<D>() + c * 8),
               src + (ok ? r : 0) * ld + c * 8, ok);
  }
}

// A fragments of rows [row0, row0 + 16) of a padded tile, k-step kk.
template <int D>
__device__ __forceinline__ void a_frag(const __nv_bfloat16* tile, int row0,
                                       int kk, int lane, uint32_t (&a)[4]) {
  ldsm_x4(smem_u32(tile + (row0 + (lane & 15)) * bwd_stride<D>() + kk * 16 +
                   (lane >> 4) * 8),
          a);
}

// B fragments of X Y^T for Y's rows [n0, n0 + 16) (two 8-row n-tiles),
// k-step kk: b[0], b[1] for rows n0..n0+7, b[2], b[3] for n0+8..n0+15.
template <int D>
__device__ __forceinline__ void bt_frag(const __nv_bfloat16* tile, int n0,
                                        int kk, int lane, uint32_t (&b)[4]) {
  ldsm_x4(smem_u32(tile + (n0 + (lane & 7) + (lane >> 4) * 8) *
                              bwd_stride<D>() +
                   kk * 16 + ((lane >> 3) & 1) * 8),
          b);
}

// B fragments of X Y for Y's rows [k0, k0 + 16) (the k-step) and columns
// [c0, c0 + 16) (two 8-column n-tiles), transposed by ldmatrix.
template <int D>
__device__ __forceinline__ void b_frag(const __nv_bfloat16* tile, int k0,
                                       int c0, int lane, uint32_t (&b)[4]) {
  ldsm_x4_trans(smem_u32(tile + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                    bwd_stride<D>() +
                         c0 + (lane >> 4) * 8),
                b);
}

// Store a warp's 16 x D f32 accumulator fragments times `mul` as bf16
// rows g and g + 8 of dst (those below `valid`), row stride `ld`.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, size_t ld,
                                           const float (&acc)[D / 8][4],
                                           float mul, int g, int tq,
                                           int valid) {
#pragma unroll
  for (int d = 0; d < D / 8; ++d) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = g + 8 * i;
      if (r < valid)
        *reinterpret_cast<uint32_t*>(dst + r * ld + d * 8 + tq * 2) =
            pack_bf16(acc[d][2 * i] * mul, acc[d][2 * i + 1] * mul);
    }
  }
}

// Pass 2: dK and dV of 64 keys of one KV head, over its group's heads.
template <int D>
__global__ void __launch_bounds__(kBwdThreads) flash_bwd_dkdv_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v,
    const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ di, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, int Sq, int Sk, int Hq, int Hkv,
    int causal, int window, int q_offset, float scale, float scale_log2) {
  constexpr int SD = bwd_stride<D>();
  constexpr int KSTEPS = D / 16;          // k-steps of S^T and dP^T
  constexpr int DT = D / 8;               // 8-column tiles of dK, dV
  constexpr int NT = kBwdStep / 8;        // 8-query tiles of S^T
  static_assert(D % 16 == 0, "D must be a multiple of 16");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* vs = ks + kBwdOwn * SD;
  __nv_bfloat16* qs = vs + kBwdOwn * SD;       // [2][32][SD]
  __nv_bfloat16* os = qs + 2 * kBwdStep * SD;  // [2][32][SD], dO
  float* ls = reinterpret_cast<float*>(os + 2 * kBwdStep * SD);  // [2][32]
  float* dis = ls + 2 * kBwdStep;                                // [2][32]

  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int k0 = blockIdx.x * kBwdOwn;
  const int rep = Hq / Hkv;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const size_t q_ld = static_cast<size_t>(Hq) * D;
  const size_t kv_ld = static_cast<size_t>(Hkv) * D;
  const size_t kv_off = (static_cast<size_t>(b) * Sk + k0) * kv_ld +
                        static_cast<size_t>(kvh) * D;

  const QueryBand band(k0, min(k0 + kBwdOwn, Sk) - 1, Sq, causal, window,
                       q_offset);
  const int n_qt = band.tiles();
  const int n_steps = rep * n_qt;   // (head, query tile) pairs, head outer

  // Step t's Q and dO tiles (cp.async) and its rows' lse and Di (plain
  // loads, read after the next barrier) into stage t & 1.
  auto issue = [&](int t) {
    const int h = kvh * rep + t / n_qt;
    const int i0 = static_cast<int>(band.lo) + (t % n_qt) * kBwdStep;
    const int st = t & 1;
    const size_t off = (static_cast<size_t>(b) * Sq + i0) * q_ld +
                       static_cast<size_t>(h) * D;
    load_rows<D, kBwdStep>(qs + st * kBwdStep * SD, q + off, q_ld, Sq - i0);
    load_rows<D, kBwdStep>(os + st * kBwdStep * SD, dout + off, q_ld,
                           Sq - i0);
    if (threadIdx.x < kBwdStep) {
      const int i = i0 + threadIdx.x;
      const size_t r = (static_cast<size_t>(b) * Hq + h) * Sq + i;
      ls[st * kBwdStep + threadIdx.x] = i < Sq ? lse[r] * kLog2e : 0.f;
      dis[st * kBwdStep + threadIdx.x] = i < Sq ? di[r] : 0.f;
    }
  };

  load_rows<D, kBwdOwn>(ks, k + kv_off, kv_ld, Sk - k0);
  load_rows<D, kBwdOwn>(vs, v + kv_off, kv_ld, Sk - k0);
  if (n_steps > 0) issue(0);
  cp_async_commit();

  const int row0 = warp * 16;        // this warp's keys: k0 + row0 + [0, 16)
  const int wk_lo = k0 + row0;
  const int wk_hi = wk_lo + 15;
  float dka[DT][4], dva[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int c = 0; c < 4; ++c) dka[d][c] = dva[d][c] = 0.f;

  for (int t = 0; t < n_steps; ++t) {
    cp_async_wait<0>();
    __syncthreads();   // step t landed; every warp is done with step t - 1
    if (t + 1 < n_steps) {
      issue(t + 1);
      cp_async_commit();
    }
    const int i0 = static_cast<int>(band.lo) + (t % n_qt) * kBwdStep;
    const long long qp_lo = static_cast<long long>(i0) + q_offset;
    const long long qp_hi = qp_lo + kBwdStep - 1;
    // A tile none of this warp's keys is seen by.
    if (wk_lo >= Sk) continue;
    if (causal && wk_lo > qp_hi) continue;
    if (window > 0 && wk_hi <= qp_lo - window) continue;
    const int st = t & 1;
    const __nv_bfloat16* qt = qs + st * kBwdStep * SD;
    const __nv_bfloat16* ot = os + st * kBwdStep * SD;
    const float* lt = ls + st * kBwdStep;
    const float* dt = dis + st * kBwdStep;

    // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys x 32 queries.
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[n][c] = dp[n][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      uint32_t ka[4], va[4];
      a_frag<D>(ks, row0, kk, lane, ka);
      a_frag<D>(vs, row0, kk, lane, va);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bq[4], bo[4];
        bt_frag<D>(qt, np * 16, kk, lane, bq);
        bt_frag<D>(ot, np * 16, kk, lane, bo);
        mma_bf16(s[2 * np], ka, bq[0], bq[1]);
        mma_bf16(s[2 * np + 1], ka, bq[2], bq[3]);
        mma_bf16(dp[2 * np], va, bo[0], bo[1]);
        mma_bf16(dp[2 * np + 1], va, bo[2], bo[3]);
      }
    }

    // P^T = exp2(S^T scale_log2 - lse), dS^T = P^T (dP^T - Di), as bf16 A
    // fragments (k = the tile's queries); mask only tiles that cross the
    // band or an edge.
    const bool full = wk_hi < Sk && i0 + kBwdStep <= Sq &&
                      (!causal || wk_hi <= qp_lo) &&
                      (window <= 0 || wk_lo > qp_hi - window);
    uint32_t pa[NT / 2][4], da[NT / 2][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = n * 8 + tq * 2 + (c & 1);   // query in the tile
        float p = exp2f(fmaf(s[n][c], scale_log2, -lt[col]));
        if (!full) {
          const int key = wk_lo + g + (c >> 1) * 8;
          const bool keep = key < Sk && i0 + col < Sq &&
                            kept(key, qp_lo + col, causal, window);
          p = keep ? p : 0.f;
        }
        s[n][c] = p;
        dp[n][c] = p * (dp[n][c] - dt[col]);
      }
      pa[n / 2][(n & 1) * 2] = pack_bf16(s[n][0], s[n][1]);
      pa[n / 2][(n & 1) * 2 + 1] = pack_bf16(s[n][2], s[n][3]);
      da[n / 2][(n & 1) * 2] = pack_bf16(dp[n][0], dp[n][1]);
      da[n / 2][(n & 1) * 2 + 1] = pack_bf16(dp[n][2], dp[n][3]);
    }

    // dV += P^T dO and dK += dS^T Q over the tile's 32 queries.
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
#pragma unroll
      for (int dp2 = 0; dp2 < DT / 2; ++dp2) {
        uint32_t bo[4], bq[4];
        b_frag<D>(ot, kk * 16, dp2 * 16, lane, bo);
        b_frag<D>(qt, kk * 16, dp2 * 16, lane, bq);
        mma_bf16(dva[2 * dp2], pa[kk], bo[0], bo[1]);
        mma_bf16(dva[2 * dp2 + 1], pa[kk], bo[2], bo[3]);
        mma_bf16(dka[2 * dp2], da[kk], bq[0], bq[1]);
        mma_bf16(dka[2 * dp2 + 1], da[kk], bq[2], bq[3]);
      }
    }
  }

  cp_async_wait<0>();   // no copy outlives the block (n_steps may be 0)
  const size_t w_off = kv_off + static_cast<size_t>(row0) * kv_ld;
  store_rows<D>(dk + w_off, kv_ld, dka, scale, g, tq, Sk - wk_lo);
  store_rows<D>(dv + w_off, kv_ld, dva, 1.f, g, tq, Sk - wk_lo);
}

// Pass 3: dQ of 64 query rows of one head, over the forward's key band.
template <int D>
__global__ void __launch_bounds__(kBwdThreads) flash_bwd_dq_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v,
    const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ di, __nv_bfloat16* __restrict__ dq, int Sq,
    int Sk, int Hq, int Hkv, int causal, int window, int q_offset,
    float scale, float scale_log2) {
  constexpr int SD = bwd_stride<D>();
  constexpr int KSTEPS = D / 16;
  constexpr int DT = D / 8;
  constexpr int NT = kBwdStep / 8;        // 8-key tiles of S
  static_assert(D % 16 == 0, "D must be a multiple of 16");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* os = qs + kBwdOwn * SD;       // dO
  __nv_bfloat16* ks = os + kBwdOwn * SD;       // [2][32][SD]
  __nv_bfloat16* vs = ks + 2 * kBwdStep * SD;  // [2][32][SD]

  // Last query tiles first: under a causal mask they carry the most keys.
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBwdOwn;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (Hq / Hkv);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const size_t q_ld = static_cast<size_t>(Hq) * D;
  const size_t kv_ld = static_cast<size_t>(Hkv) * D;
  const size_t q_off = (static_cast<size_t>(b) * Sq + q0) * q_ld +
                       static_cast<size_t>(h) * D;
  const int row0 = warp * 16;

  // Keys any row of this block can keep (the forward's band).
  const int qpos_lo = q0 + q_offset;
  const int qpos_hi = min(q0 + kBwdOwn, Sq) - 1 + q_offset;
  int k_begin = 0;
  int k_end = Sk;
  if (causal) k_end = min(Sk, qpos_hi + 1);
  if (window > 0) k_begin = max(0, qpos_lo - window + 1);
  k_begin -= k_begin % kBwdStep;
  const int n_tiles =
      k_end > k_begin ? (k_end - k_begin + kBwdStep - 1) / kBwdStep : 0;
  if (n_tiles == 0) {   // no row keeps a key: dq is 0
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    for (int i = threadIdx.x; i < kBwdOwn * DT; i += kBwdThreads) {
      const int r = i / DT;
      if (q0 + r < Sq)
        *reinterpret_cast<uint4*>(dq + q_off + r * q_ld + (i % DT) * 8) =
            zero;
    }
    return;
  }

  const __nv_bfloat16* kb =
      k + static_cast<size_t>(b) * Sk * kv_ld + static_cast<size_t>(kvh) * D;
  const __nv_bfloat16* vb =
      v + static_cast<size_t>(b) * Sk * kv_ld + static_cast<size_t>(kvh) * D;
  load_rows<D, kBwdOwn>(qs, q + q_off, q_ld, Sq - q0);
  load_rows<D, kBwdOwn>(os, dout + q_off, q_ld, Sq - q0);
  load_rows<D, kBwdStep>(ks, kb + k_begin * kv_ld, kv_ld, Sk - k_begin);
  load_rows<D, kBwdStep>(vs, vb + k_begin * kv_ld, kv_ld, Sk - k_begin);
  cp_async_commit();

  // This warp's rows: positions [wq_lo, wq_hi]; this lane holds rows g
  // and g + 8 of them, and their lse (log2 domain) and Di.
  const int wq_lo = q0 + row0 + q_offset;
  const int wq_hi = wq_lo + 15;
  float l2[2], dr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = q0 + row0 + g + 8 * i;
    const size_t at = (static_cast<size_t>(b) * Hq + h) * Sq + r;
    l2[i] = r < Sq ? lse[at] * kLog2e : 0.f;
    dr[i] = r < Sq ? di[at] : 0.f;
  }
  float dqa[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
    dqa[d][0] = dqa[d][1] = dqa[d][2] = dqa[d][3] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = k_begin + t * kBwdStep;
    cp_async_wait<0>();
    __syncthreads();   // tile t landed; every warp is done with tile t - 1
    if (t + 1 < n_tiles) {   // tile t + 1 into the stage tile t - 1 used
      const int st = (t + 1) & 1;
      const int k1 = k0 + kBwdStep;
      load_rows<D, kBwdStep>(ks + st * kBwdStep * SD, kb + k1 * kv_ld, kv_ld,
                             Sk - k1);
      load_rows<D, kBwdStep>(vs + st * kBwdStep * SD, vb + k1 * kv_ld, kv_ld,
                             Sk - k1);
      cp_async_commit();
    }
    // A tile no row of this warp keeps.
    if (causal && k0 > wq_hi) continue;
    if (window > 0 && k0 + kBwdStep - 1 <= wq_lo - window) continue;
    const __nv_bfloat16* kt = ks + (t & 1) * kBwdStep * SD;
    const __nv_bfloat16* vt = vs + (t & 1) * kBwdStep * SD;

    // S = Q K^T and dP = dO V^T: this warp's 16 rows x 32 keys.
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[n][c] = dp[n][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      uint32_t qa[4], oa[4];
      a_frag<D>(qs, row0, kk, lane, qa);
      a_frag<D>(os, row0, kk, lane, oa);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bk[4], bv[4];
        bt_frag<D>(kt, np * 16, kk, lane, bk);
        bt_frag<D>(vt, np * 16, kk, lane, bv);
        mma_bf16(s[2 * np], qa, bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], qa, bk[2], bk[3]);
        mma_bf16(dp[2 * np], oa, bv[0], bv[1]);
        mma_bf16(dp[2 * np + 1], oa, bv[2], bv[3]);
      }
    }

    // dS = P (dP - Di), P = exp2(S scale_log2 - lse), as bf16 A fragments
    // (k = the tile's keys).
    const bool full = k0 + kBwdStep <= Sk &&
                      (!causal || k0 + kBwdStep - 1 <= wq_lo) &&
                      (window <= 0 || k0 > wq_hi - window);
    uint32_t da[NT / 2][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = c >> 1;
        float p = exp2f(fmaf(s[n][c], scale_log2, -l2[i]));
        if (!full) {
          const int kpos = k0 + n * 8 + tq * 2 + (c & 1);
          const bool keep = kpos < Sk &&
                            kept(kpos, wq_lo + g + 8 * i, causal, window);
          p = keep ? p : 0.f;
        }
        dp[n][c] = p * (dp[n][c] - dr[i]);
      }
      da[n / 2][(n & 1) * 2] = pack_bf16(dp[n][0], dp[n][1]);
      da[n / 2][(n & 1) * 2 + 1] = pack_bf16(dp[n][2], dp[n][3]);
    }

    // dQ += dS K over the tile's 32 keys.
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
#pragma unroll
      for (int dp2 = 0; dp2 < DT / 2; ++dp2) {
        uint32_t bk[4];
        b_frag<D>(kt, kk * 16, dp2 * 16, lane, bk);
        mma_bf16(dqa[2 * dp2], da[kk], bk[0], bk[1]);
        mma_bf16(dqa[2 * dp2 + 1], da[kk], bk[2], bk[3]);
      }
    }
  }

  store_rows<D>(dq + q_off + static_cast<size_t>(row0) * q_ld, q_ld, dqa,
                scale, g, tq, Sq - q0 - row0);
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

struct FlashBwdLaunch {
  const void* q;
  const void* k;
  const void* v;
  const void* out;
  const void* dout;
  const float* lse;
  float* di;
  void* dq;
  void* dk;
  void* dv;
  int B, Sq, Sk, Hq, Hkv, causal, window, q_offset;
  float scale;
  cudaStream_t stream;

  template <typename T, int D>
  int operator()() const {
    const float scale_log2 = scale * kLog2e;
    const long long n_rows = static_cast<long long>(B) * Sq * Hq;
    const long long n_dot = (n_rows * 4 + kBwdThreads - 1) / kBwdThreads;
    if (n_dot > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    flash_bwd_dot_kernel<T, D><<<static_cast<unsigned>(n_dot), kBwdThreads, 0,
                                 stream>>>(
        static_cast<const T*>(dout), static_cast<const T*>(out), di, n_rows,
        Sq, Hq);
    int err = static_cast<int>(cudaGetLastError());
    if (err) return err;
    if constexpr (std::is_same_v<T, __nv_bfloat16>) {
      constexpr int smem = bwd_smem_bytes<D>();
      static int granted_kv[kMaxDevices] = {};
      static int granted_q[kMaxDevices] = {};
      err = allow_smem((const void*)flash_bwd_dkdv_mma_kernel<D>, smem,
                       granted_kv);
      if (err) return err;
      err = allow_smem((const void*)flash_bwd_dq_mma_kernel<D>, smem,
                       granted_q);
      if (err) return err;
      flash_bwd_dkdv_mma_kernel<D><<<dim3((Sk + kBwdOwn - 1) / kBwdOwn, Hkv,
                                          B),
                                     kBwdThreads, smem, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const T*>(dout), lse, di,
          static_cast<T*>(dk), static_cast<T*>(dv), Sq, Sk, Hq, Hkv, causal,
          window, q_offset, scale, scale_log2);
      err = static_cast<int>(cudaGetLastError());
      if (err) return err;
      flash_bwd_dq_mma_kernel<D><<<dim3((Sq + kBwdOwn - 1) / kBwdOwn, Hq, B),
                                   kBwdThreads, smem, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const T*>(dout), lse, di,
          static_cast<T*>(dq), Sq, Sk, Hq, Hkv, causal, window, q_offset,
          scale, scale_log2);
    } else {
      flash_bwd_dkdv_kernel<T, D><<<dim3((Sk + kBwdF32Rows - 1) / kBwdF32Rows,
                                         Hkv, B),
                                    kBwdThreads, 0, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const T*>(dout), lse, di,
          static_cast<T*>(dk), static_cast<T*>(dv), Sq, Sk, Hq, Hkv, causal,
          window, q_offset, scale, scale_log2);
      err = static_cast<int>(cudaGetLastError());
      if (err) return err;
      flash_bwd_dq_kernel<T, D><<<dim3((Sq + kBwdF32Rows - 1) / kBwdF32Rows,
                                       Hq, B),
                                  kBwdThreads, 0, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const T*>(dout), lse, di,
          static_cast<T*>(dq), Sq, Sk, Hq, Hkv, causal, window, q_offset,
          scale, scale_log2);
    }
    return static_cast<int>(cudaGetLastError());
  }
};

}  // namespace attn

// dtype: 0 = f32, 1 = bf16. window <= 0 means no window. Query row i sits
// at position i + q_offset. di is (B, Hq, Sq) f32 scratch the call fills.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const float* lse, float* di, void* dq, void* dk,
    void* dv, int B, int Sq, int Sk, int Hq, int Hkv, int D, int dtype,
    int causal, int window, int q_offset, float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Hkv <= 0 || Hq % Hkv != 0 ||
      Hq > 65535 || Hkv > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const attn::FlashBwdLaunch f{q, k, v, out, dout, lse, di, dq, dk, dv,
                               B, Sq, Sk, Hq, Hkv, causal, window, q_offset,
                               scale, static_cast<cudaStream_t>(stream)};
  return attn::dispatch(dtype, D, f);
}

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
// Three passes on the caller's stream, all deterministic (no atomics):
//   1. Di = rowsum(dO * O) in f32, into a (B, Hq, Sq_pad) scratch;
//   2. dK and dV: a block owns a tile of keys of one KV head and walks
//      query heads of its group, and for each the query tiles whose rows
//      see any of its keys (the inverse of the forward's band); it
//      recomputes S^T = K Q^T and P^T = exp(S^T scale - lse), then
//      dV += P^T dO, dP^T = V dO^T, dS^T = P^T (dP^T - Di), dK += dS^T Q;
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
// FLOPs per pair and head dim, 11.3 GFLOP, 11.4 us), and reread Q, dO, K
// and V once per tile. The route comes from the plan of
// kernels/flash_attention_bwd.py; each route launches its kernels or
// refuses.
//
// bf16, head dims 64 and 128 (the wgmma route, the main path): warpgroup
// products (wgmma, m64, operands in wgmma.cuh's 128-byte swizzled tiles),
// loaded by TMA (tma.cuh) from one producer thread into rings of stages
// under mbarriers.
//   dK/dV: a block owns 64 keys of one KV head (K and V loaded once) and
//   one part of its group's query heads, and its two consumer warpgroups
//   take the block's (head, query tile) steps in turn. S^T = K Q^T and
//   dP^T = V dO^T take both operands from shared memory (K/V the K-major
//   A, Q/dO the K-major B); dV += P^T dO and dK += dS^T Q take P^T and
//   dS^T from registers (the S^T and dP^T accumulators rounded to bf16,
//   the forward's P V layout) and the same Q and dO tiles read MN-major.
//   Each warpgroup has its own ring of (Q, dO, lse, Di) stages (two at
//   D 128, four at D 64). dK and dV take 2 x D / 2 f32 registers a
//   thread, so the producer is a warpgroup that gives its registers to
//   the consumers (setmaxnreg). At the training shape only
//   B x Hkv x Sk/64 = 64 key tiles exist for 132 SMs, so the plan cuts
//   each group's heads into `split` parts, one a block (192 blocks
//   there): the warpgroups' f32 sums meet in shared memory, and split
//   parts go through a (split, 2, B, Sk, Hkv, D) f32 scratch (12.6 MB at
//   the training call, written and read once) that
//   flash_bwd_dkdv_sum_kernel adds in part order. Key tiles run in order
//   on the slowest grid axis: under a causal mask the first carry the
//   most query tiles.
//   dQ: a block's warpgroups own 64 query rows of one query head each
//   (two heads of one KV group where rep is even) and share a ring of K
//   and V stages: S = Q K^T, dP = dO V^T, dQ += dS K with K read
//   MN-major; last query tiles first.
//   TMA zero-fills rows past Sq or Sk, but exp2(0 - lse) is not 0, so the
//   tiles that cross an edge or the band keep the per-element mask. lse
//   (in the log2 domain) and Di come from the Di pass padded to Sq_pad, a
//   multiple of 64, so each tile's 64 of them is one aligned bulk copy.
//   The tensor maps are encoded on the host for each call.
//
// bf16, head dims 16, 32, 80 and 96 (the mma route): four warps, each
// owning 16 rows of the block's 64 (keys in pass 2, queries in pass 3),
// mma.sync m16n8k16 with f32 accumulators; the owned K/V (or Q/dO) tile
// and two stages of the streamed 32-row tiles sit in padded row-major
// shared tiles, copied by cp.async (tile t + 1 while tile t is computed);
// fragments come by ldmatrix (.trans for the B operand of dV, dK and dQ).
// The A fragments of the owned tile are reread from shared memory every
// tile, which keeps a thread under 255 registers. A warp skips the tiles
// none of its rows sees.
//
// Both bf16 routes round P and dS to bf16 only as operands of the
// tensor-core products (P is the rounding the forward and the plain
// version make) and accumulate in f32; only the tiles that cross the band
// or a ragged edge take a per-element mask.
//
// f32 (the fma route): products in full f32 on the FMA units, as the
// forward's f32 kernel (TF32 would not hold the 2e-5 checks): 4 threads a
// row, each owning D/4 columns of it; the streamed tile of 32 rows staged
// in shared memory; one (row, streamed row) pair at a time.
#include <type_traits>

#include "attention.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

namespace attn {

constexpr int kBwdThreads = 128;   // 4 warps
constexpr int kBwdOwn = 64;        // rows a bf16 block owns, 16 a warp
constexpr int kBwdStep = 32;       // rows of a streamed tile
constexpr int kBwdF32Rows = 32;    // rows an f32 block owns, 4 threads each

// ---------------------------------------------------------------------------
// 1. Di = rowsum(dO * O)
// ---------------------------------------------------------------------------

// acc + the dot product of the two 16-byte pieces (8 bf16 or 4 f32).
template <typename T>
__device__ __forceinline__ float dot16(uint4 a, uint4 b, float acc);

template <>
__device__ __forceinline__ float dot16<float>(uint4 a, uint4 b, float acc) {
  return dot4(*reinterpret_cast<float4*>(&a), *reinterpret_cast<float4*>(&b),
              acc);
}

template <>
__device__ __forceinline__ float dot16<__nv_bfloat16>(uint4 a, uint4 b,
                                                     float acc) {
  const uint32_t x[4] = {a.x, a.y, a.z, a.w}, y[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float2 u = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&x[c]));
    const float2 w = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&y[c]));
    acc = fmaf(u.x, w.x, fmaf(u.y, w.y, acc));
  }
  return acc;
}

// Four threads a row, rows in (b, h, i) order for i < Sq_pad: Di in
// (B, Hq, Sq_pad), each thread reading every fourth 16-byte piece of the
// row's dO and O. With lse2 (the wgmma route) it also writes each row's
// lse in the log2 domain into (B, Hq, Sq_pad); rows in [Sq, Sq_pad) get
// Di = lse2 = 0, so every 64-row tile of both is whole and 256-byte
// aligned for the bulk copies. The other routes pass Sq_pad = Sq.
template <typename T, int D>
__global__ void __launch_bounds__(kBwdThreads) flash_bwd_dot_kernel(
    const T* __restrict__ dout, const T* __restrict__ out,
    const float* __restrict__ lse, float* __restrict__ di,
    float* __restrict__ lse2, long long n_rows, int Sq, int Sq_pad,
    int Hq) {
  constexpr int E = 16 / sizeof(T);   // elements of a piece
  const long long row =
      (static_cast<long long>(blockIdx.x) * kBwdThreads + threadIdx.x) / 4;
  const int g = threadIdx.x % 4;
  const long long i = row % Sq_pad;
  const long long bh = row / Sq_pad;  // b * Hq + h
  const bool real = row < n_rows && i < Sq;
  float acc = 0.f;
  if (real) {
    const size_t at = ((bh / Hq * Sq + i) * Hq + bh % Hq) * D;
    const uint4* a = reinterpret_cast<const uint4*>(dout + at);
    const uint4* o = reinterpret_cast<const uint4*>(out + at);
#pragma unroll
    for (int c = g; c < D / E; c += 4) acc = dot16<T>(a[c], o[c], acc);
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  if (row < n_rows && g == 0) {
    di[row] = acc;
    if (lse2 != nullptr) lse2[row] = real ? lse[bh * Sq + i] * kLog2e : 0.f;
  }
}

// The query rows [lo, hi) whose positions see any key of [k0, k_hi]:
// pos >= k0 (causal) and pos - window < k_hi (window); lo rounded down to
// a streamed tile of `step` rows.
struct QueryBand {
  long long lo, hi;
  int step;
  __device__ QueryBand(int k0, int k_hi, int Sq, int causal, int window,
                       int q_offset, int step_ = kBwdStep)
      : step(step_) {
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
    lo -= lo % step;
  }
  __device__ int tiles() const {
    return hi > lo ? static_cast<int>((hi - lo + step - 1) / step) : 0;
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
// bf16, head dims 64 and 128: warpgroup MMA (wgmma), TMA rings, one
// producer warp
// ---------------------------------------------------------------------------

constexpr int kWgRows = 64;   // rows of every wgmma tile (keys or queries)
constexpr int kWgTile = 64 * 128;   // bytes of a 64-row, 64-column block

// Threads of a dQ block: NWG consumer warpgroups and one producer warp.
template <int NWG>
__host__ __device__ constexpr int wg_threads() { return NWG * 128 + 32; }

// A dK/dV block: two consumer warpgroups and a producer warpgroup, which
// gives its registers to the consumers (setmaxnreg: 40 + 2 x 232 of the
// 3 x 168 a thread the launch grants), so their dK and dV sums (2 x D / 2
// f32 a thread) stay in registers at D 128.
constexpr int kKvGroups = 2;
constexpr int kKvThreads = (kKvGroups + 1) * 128;

// Shared memory of the dK/dV pass (byte offsets): the owned K and V tiles;
// each warpgroup's ring of NSW stages of (Q tile, dO tile, 64 lse2, 64 Di);
// the barriers: the owned tiles', then each stage's full and empty.
template <int D>
struct KvLayout {
  static constexpr int TILE = kWgRows * D * 2;
  static constexpr int NSW = D == 128 ? 2 : 4;
  static constexpr int NST = kKvGroups * NSW;   // stages of the block
  static constexpr int K = 0;
  static constexpr int V = TILE;
  static constexpr int Q = 2 * TILE;         // [NST] tiles
  static constexpr int O = Q + NST * TILE;   // [NST] tiles
  static constexpr int L = O + NST * TILE;   // [NST][64] f32, lse2
  static constexpr int DI = L + NST * 256;   // [NST][64] f32
  static constexpr int BAR = DI + NST * 256;
  static constexpr int BYTES = BAR + (1 + 2 * NST) * 8;
  // warpgroup 1 leaves its f32 dK and dV here for warpgroup 0
  static_assert(2 * 128 * (D / 2) * 4 <= 2 * NST * TILE,
                "the combine area must fit the ring");
};

// Shared memory of the dQ pass: each warpgroup's owned Q and dO tiles, a
// ring of NS stages of (K tile, V tile) shared by the warpgroups, the
// barriers.
template <int D, int NWG>
struct QLayout {
  static constexpr int TILE = kWgRows * D * 2;
  // one warpgroup: few enough stages for two blocks (D 128) or three
  // (D 64) on an SM
  static constexpr int NS =
      NWG == 1 ? (D == 128 ? 2 : 3) : (D == 128 ? 4 : 6);
  static constexpr int Q = 0;                 // [NWG] tiles
  static constexpr int O = NWG * TILE;        // [NWG] tiles
  static constexpr int K = 2 * NWG * TILE;    // [NS] tiles
  static constexpr int V = K + NS * TILE;     // [NS] tiles
  static constexpr int BAR = V + NS * TILE;
  static constexpr int BYTES = BAR + (1 + 2 * NS) * 8;
};

// Named barrier 1 over a dK/dV block's consumer warpgroups (the producer
// may have left).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(kKvGroups * 128) : "memory");
}

// S (+)= A B^T over the head dim for two 64-row swizzled tiles, both
// K-major: k-step kk is 32 bytes into the rows of column block kk / 4.
template <int D>
__device__ __forceinline__ void wg_rows_product(float (&acc)[32],
                                                uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk >> 2) * kWgTile + (kk & 3) * 32;
    wgmma_ss_n64(acc, wgmma_desc(a + off, kWgTile, 1024),
                 wgmma_desc(b + off, kWgTile, 1024), kk > 0);
  }
}

// Issue S (+)= A B^T and dP (+)= C E^T as one group (wg_rows_product).
template <int D>
__device__ __forceinline__ void wg_scores(float (&s)[32], float (&dp)[32],
                                          uint32_t a, uint32_t c, uint32_t b,
                                          uint32_t e) {
  wgmma_fence();
  wg_rows_product<D>(s, a, b);
  wg_rows_product<D>(dp, c, e);
  wgmma_commit();
}

// acc += A B for A the 64 x 64 bf16 fragments `a` (k = the tile's 64
// rows) and B a 64-row swizzled tile read MN-major: k-step kk is 16 rows
// (2048 bytes) down the tile.
template <int D>
__device__ __forceinline__ void wg_frag_product(float (&acc)[D / 2],
                                                const uint32_t (&a)[4][4],
                                                uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    WgmmaRS<D>::run(acc, a[kk], wgmma_desc(b + kk * 2048, kWgTile, 1024), 1);
}

// Pass 2 on the tensor cores: dK and dV of 64 keys of one KV head, over
// one part of its group's query heads. The rep heads of a group are cut
// into `split` parts of rep / split heads (the plan makes them divide
// rep), one a block: block (pb, kvh, b, key tile) walks the steps (head,
// query tile of the key tile's band) of part pb, head-major, and its two
// consumer warpgroups take the even and the odd steps. Warpgroup w's ring
// holds its next NSW steps, loaded by the producer with TMA. The
// warpgroups' f32 sums meet in shared memory, warpgroup 0's plus
// warpgroup 1's; with split 1 warpgroup 0 writes dK (scaled) and dV in
// bf16, otherwise the block's f32 sum goes to `part` (split, 2, B, Sk,
// Hkv, D) and flash_bwd_dkdv_sum_kernel adds the split blocks in order.
template <int D>
__global__ void __launch_bounds__(kKvThreads, 1)
    flash_bwd_dkdv_wg_kernel(const __grid_constant__ CUtensorMap qmap,
                             const __grid_constant__ CUtensorMap omap,
                             const __grid_constant__ CUtensorMap kmap,
                             const __grid_constant__ CUtensorMap vmap,
                             const float* __restrict__ lse2,
                             const float* __restrict__ di,
                             __nv_bfloat16* __restrict__ dk,
                             __nv_bfloat16* __restrict__ dv,
                             float* __restrict__ part, int Sq, int Sq_pad,
                             int Sk, int Hq, int Hkv, int split, int causal,
                             int window, int q_offset, float scale,
                             float scale_log2) {
  using L = KvLayout<D>;
  constexpr int NSW = L::NSW;
  constexpr uint32_t TILE = L::TILE;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = smem_u32(smem);
  const uint32_t own_bar = base + L::BAR;
  auto full_bar = [&](int st) { return base + L::BAR + 8 + 8 * st; };
  auto empty_bar = [&](int st) {
    return base + L::BAR + 8 + 8 * L::NST + 8 * st;
  };

  const int pb = blockIdx.x % split;
  const int kvh = blockIdx.x / split;
  const int b = blockIdx.y;
  // Key tiles in order: under a causal mask the first carry the most
  // query tiles, and the slowest grid axis starts them first.
  const int k0 = blockIdx.z * kWgRows;
  const int rep = Hq / Hkv;
  const int heads = rep / split;           // heads of the block's part
  const int h0 = kvh * rep + pb * heads;   // its first
  const QueryBand band(k0, min(k0 + kWgRows, Sk) - 1, Sq, causal, window,
                       q_offset, kWgRows);
  const int n_qt = band.tiles();
  const int steps = heads * n_qt;          // of the block
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(own_bar, 1);
    for (int st = 0; st < L::NST; ++st) {
      mbar_init(full_bar(st), 1);
      mbar_init(empty_bar(st), 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == kKvGroups) {   // the producer: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x % 128 == 0 && steps > 0) {
      mbar_expect_tx(own_bar, 2 * TILE);
      tma_rows<D>(&kmap, base + L::K, own_bar, kvh, k0, b);
      tma_rows<D>(&vmap, base + L::V, own_bar, kvh, k0, b);
      for (int u = 0; u < steps; ++u) {   // step u is warpgroup u % 2's
        const int t = u / kKvGroups;       // its own step t
        const int st = (u % kKvGroups) * NSW + t % NSW;
        const int h = h0 + u / n_qt;
        const int i0 = static_cast<int>(band.lo) + (u % n_qt) * kWgRows;
        const size_t r = (static_cast<size_t>(b) * Hq + h) * Sq_pad + i0;
        mbar_wait(empty_bar(st), ((t / NSW) & 1) ^ 1);
        mbar_expect_tx(full_bar(st), 2 * TILE + 512);
        tma_rows<D>(&qmap, base + L::Q + st * TILE, full_bar(st), h, i0, b);
        tma_rows<D>(&omap, base + L::O + st * TILE, full_bar(st), h, i0, b);
        bulk_load(base + L::L + st * 256, lse2 + r, 256, full_bar(st));
        bulk_load(base + L::DI + st * 256, di + r, 256, full_bar(st));
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");

  const int warp = threadIdx.x / 32 % 4;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int wk_lo = k0 + warp * 16;   // this warp's keys [wk_lo, wk_lo + 16)
  const int wk_hi = wk_lo + 15;
  float dka[D / 2], dva[D / 2];   // 8-column tile d: [4d .. 4d + 3]
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;

  if (steps > wg) mbar_wait(own_bar, 0);
  for (int t = 0, u = wg; u < steps; ++t, u += kKvGroups) {
    const int st = wg * NSW + t % NSW;
    const int i0 = static_cast<int>(band.lo) + (u % n_qt) * kWgRows;
    const uint32_t q_addr = base + L::Q + st * TILE;
    const uint32_t o_addr = base + L::O + st * TILE;
    const float* lt = reinterpret_cast<const float*>(smem + L::L + st * 256);
    const float* dt = reinterpret_cast<const float*>(smem + L::DI + st * 256);
    mbar_wait(full_bar(st), (t / NSW) & 1);

    // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 queries each (the
    // first k-step overwrites the accumulators).
    float s[32], dp[32];
    wg_scores<D>(s, dp, base + L::K, base + L::V, q_addr, o_addr);
    wgmma_wait<0>();

    // P^T = exp2(S^T scale_log2 - lse2), dS^T = P^T (dP^T - Di), rounded
    // to bf16 A fragments (k = the tile's queries); only tiles that cross
    // the band or an edge take the per-element mask (a row past Sq is
    // zero-filled, but exp2(0 - lse2) is not 0).
    const long long qp_lo = static_cast<long long>(i0) + q_offset;
    const long long qp_hi = qp_lo + kWgRows - 1;
    const bool whole = wk_hi < Sk && i0 + kWgRows <= Sq &&
                       (!causal || wk_hi <= qp_lo) &&
                       (window <= 0 || wk_lo > qp_hi - window);
    uint32_t pa[4][4], da[4][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = n * 8 + tq * 2 + (c & 1);   // query in the tile
        float p = exp2f(fmaf(s[4 * n + c], scale_log2, -lt[col]));
        if (!whole) {
          const int key = wk_lo + g + (c >> 1) * 8;
          const bool keep = key < Sk && i0 + col < Sq &&
                            kept(key, qp_lo + col, causal, window);
          p = keep ? p : 0.f;
        }
        s[4 * n + c] = p;
        dp[4 * n + c] = p * (dp[4 * n + c] - dt[col]);
      }
      pa[n / 2][(n & 1) * 2] = pack_bf16(s[4 * n], s[4 * n + 1]);
      pa[n / 2][(n & 1) * 2 + 1] = pack_bf16(s[4 * n + 2], s[4 * n + 3]);
      da[n / 2][(n & 1) * 2] = pack_bf16(dp[4 * n], dp[4 * n + 1]);
      da[n / 2][(n & 1) * 2 + 1] = pack_bf16(dp[4 * n + 2], dp[4 * n + 3]);
    }

    // dV += P^T dO and dK += dS^T Q, the streamed tiles read MN-major.
    wgmma_fence();
    wg_frag_product<D>(dva, pa, o_addr);
    wg_frag_product<D>(dka, da, q_addr);
    wgmma_commit();
    wgmma_wait<0>();
    mbar_arrive(empty_bar(st));
  }

  // Warpgroup 0's sums plus warpgroup 1's, through the ring (every copy
  // into it has been consumed once both warpgroups pass the barrier).
  const int tid = threadIdx.x % 128;
  float* area = reinterpret_cast<float*>(smem + L::Q);
  consumers_sync();
  if (wg == 1) {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) {
      area[i * 128 + tid] = dka[i];
      area[(D / 2 + i) * 128 + tid] = dva[i];
    }
  }
  consumers_sync();
  if (wg == 1) return;
#pragma unroll
  for (int i = 0; i < D / 2; ++i) {
    dka[i] += area[i * 128 + tid];
    dva[i] += area[(D / 2 + i) * 128 + tid];
  }

  // This lane's keys wk_lo + g and wk_lo + g + 8, columns d 8 + 2 tq + {0, 1}.
  const int B = gridDim.y;
  const size_t kv_ld = static_cast<size_t>(Hkv) * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = wk_lo + g + 8 * i;
    if (key >= Sk) continue;
    const size_t row = (static_cast<size_t>(b) * Sk + key) * kv_ld +
                       static_cast<size_t>(kvh) * D;
#pragma unroll
    for (int d = 0; d < D / 8; ++d) {
      const int col = d * 8 + tq * 2;
      const float k_lo = dka[4 * d + 2 * i], k_hi = dka[4 * d + 2 * i + 1];
      const float v_lo = dva[4 * d + 2 * i], v_hi = dva[4 * d + 2 * i + 1];
      if (split == 1) {
        *reinterpret_cast<uint32_t*>(dk + row + col) =
            pack_bf16(k_lo * scale, k_hi * scale);
        *reinterpret_cast<uint32_t*>(dv + row + col) = pack_bf16(v_lo, v_hi);
      } else {
        const size_t n = static_cast<size_t>(B) * Sk * kv_ld;
        float* pk = part + 2 * pb * n + row + col;
        *reinterpret_cast<float2*>(pk) = make_float2(k_lo, k_hi);
        *reinterpret_cast<float2*>(pk + n) = make_float2(v_lo, v_hi);
      }
    }
  }
}

// dK = scale x (sum of the split parts' dK, in part order), dV the same
// unscaled, four elements a thread; part (split, 2, n) f32.
__global__ void __launch_bounds__(256) flash_bwd_dkdv_sum_kernel(
    const float* __restrict__ part, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, long long n, int split, float scale) {
  const long long i =
      (static_cast<long long>(blockIdx.x) * 256 + threadIdx.x) * 4;
  if (i >= n) return;
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 c = a;
  for (int p = 0; p < split; ++p) {
    const float4 x = *reinterpret_cast<const float4*>(part + 2 * p * n + i);
    const float4 y =
        *reinterpret_cast<const float4*>(part + (2 * p + 1) * n + i);
    a = make_float4(a.x + x.x, a.y + x.y, a.z + x.z, a.w + x.w);
    c = make_float4(c.x + y.x, c.y + y.y, c.z + y.z, c.w + y.w);
  }
  Vec4<__nv_bfloat16>::store(dk + i, scale4(a, scale));
  Vec4<__nv_bfloat16>::store(dv + i, c);
}

// Pass 3 on the tensor cores: dQ of 64 query rows of NWG query heads of
// one KV group, one consumer warpgroup a head, sharing a ring of NS (K, V)
// stages of the forward's key band that the producer warp loads with TMA.
template <int D, int NWG>
__global__ void __launch_bounds__(NWG * 128 + 32, 1)
    flash_bwd_dq_wg_kernel(const __grid_constant__ CUtensorMap qmap,
                           const __grid_constant__ CUtensorMap omap,
                           const __grid_constant__ CUtensorMap kmap,
                           const __grid_constant__ CUtensorMap vmap,
                           const float* __restrict__ lse2,
                           const float* __restrict__ di,
                           __nv_bfloat16* __restrict__ dq, int Sq,
                           int Sq_pad, int Sk, int Hq, int Hkv, int causal,
                           int window, int q_offset, float scale,
                           float scale_log2) {
  using L = QLayout<D, NWG>;
  constexpr int NS = L::NS;
  constexpr uint32_t TILE = L::TILE;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = smem_u32(smem);
  const uint32_t own_bar = base + L::BAR;
  auto full_bar = [&](int st) { return base + L::BAR + 8 + 8 * st; };
  auto empty_bar = [&](int st) { return base + L::BAR + 8 + 8 * NS + 8 * st; };

  const int h0 = blockIdx.x * NWG;   // first query head of the block
  const int b = blockIdx.y;
  // Last query tiles first (slowest grid axis): under a causal mask they
  // carry the most keys.
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kWgRows;
  const int kvh = h0 / (Hq / Hkv);
  const int wg = threadIdx.x / 128;

  // Keys any row of this block can keep (the forward's band).
  const int qpos_lo = q0 + q_offset;
  const int qpos_hi = min(q0 + kWgRows, Sq) - 1 + q_offset;
  int k_begin = 0;
  int k_end = Sk;
  if (causal) k_end = min(Sk, qpos_hi + 1);
  if (window > 0) k_begin = max(0, qpos_lo - window + 1);
  k_begin -= k_begin % kWgRows;
  const int n_tiles =
      k_end > k_begin ? (k_end - k_begin + kWgRows - 1) / kWgRows : 0;

  if (threadIdx.x == 0) {
    mbar_init(own_bar, 1);
    for (int st = 0; st < NS; ++st) {
      mbar_init(full_bar(st), 1);
      mbar_init(empty_bar(st), NWG * 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == NWG) {   // the producer warp
    if (threadIdx.x % 32 == 0 && n_tiles > 0) {
      mbar_expect_tx(own_bar, 2 * NWG * TILE);
      for (int w = 0; w < NWG; ++w) {
        tma_rows<D>(&qmap, base + L::Q + w * TILE, own_bar, h0 + w, q0, b);
        tma_rows<D>(&omap, base + L::O + w * TILE, own_bar, h0 + w, q0, b);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % NS;
        const int k0 = k_begin + t * kWgRows;
        mbar_wait(empty_bar(st), ((t / NS) & 1) ^ 1);
        mbar_expect_tx(full_bar(st), 2 * TILE);
        tma_rows<D>(&kmap, base + L::K + st * TILE, full_bar(st), kvh, k0, b);
        tma_rows<D>(&vmap, base + L::V + st * TILE, full_bar(st), kvh, k0, b);
      }
    }
    return;
  }

  const int h = h0 + wg;
  const int warp = threadIdx.x / 32 % 4;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const size_t q_ld = static_cast<size_t>(Hq) * D;
  __nv_bfloat16* dqb = dq + (static_cast<size_t>(b) * Sq * Hq + h) * D;
  // This warp's rows: positions [wq_lo, wq_lo + 16); this lane holds rows
  // g and g + 8 of them, and their lse2 and Di (padded rows read 0).
  const int wq_lo = q0 + warp * 16 + q_offset;
  const int wq_hi = wq_lo + 15;
  float l2[2], dr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const size_t at = (static_cast<size_t>(b) * Hq + h) * Sq_pad + q0 +
                      warp * 16 + g + 8 * i;
    l2[i] = lse2[at];
    dr[i] = di[at];
  }
  float dqa[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dqa[i] = 0.f;

  const uint32_t q_addr = base + L::Q + wg * TILE;
  const uint32_t o_addr = base + L::O + wg * TILE;
  if (n_tiles > 0) mbar_wait(own_bar, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % NS;
    const int k0 = k_begin + t * kWgRows;
    const uint32_t k_addr = base + L::K + st * TILE;
    mbar_wait(full_bar(st), (t / NS) & 1);

    // S = Q K^T and dP = dO V^T: 64 rows x 64 keys each (the first k-step
    // overwrites the accumulators).
    float s[32], dp[32];
    wg_scores<D>(s, dp, q_addr, o_addr, k_addr, base + L::V + st * TILE);
    wgmma_wait<0>();

    // dS = P (dP - Di), P = exp2(S scale_log2 - lse2), as bf16 A
    // fragments (k = the tile's keys).
    const bool whole = k0 + kWgRows <= Sk &&
                       (!causal || k0 + kWgRows - 1 <= wq_lo) &&
                       (window <= 0 || k0 > wq_hi - window);
    uint32_t da[4][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = c >> 1;
        float p = exp2f(fmaf(s[4 * n + c], scale_log2, -l2[i]));
        if (!whole) {
          const int kpos = k0 + n * 8 + tq * 2 + (c & 1);
          const bool keep = kpos < Sk &&
                            kept(kpos, wq_lo + g + 8 * i, causal, window);
          p = keep ? p : 0.f;
        }
        dp[4 * n + c] = p * (dp[4 * n + c] - dr[i]);
      }
      da[n / 2][(n & 1) * 2] = pack_bf16(dp[4 * n], dp[4 * n + 1]);
      da[n / 2][(n & 1) * 2 + 1] = pack_bf16(dp[4 * n + 2], dp[4 * n + 3]);
    }

    // dQ += dS K, K read MN-major.
    wgmma_fence();
    wg_frag_product<D>(dqa, da, k_addr);
    wgmma_commit();
    wgmma_wait<0>();
    mbar_arrive(empty_bar(st));
  }

  // Rows q0 + warp 16 + g (+ 8) below Sq; zeros where no key was kept.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = q0 + warp * 16 + g + 8 * i;
    if (r >= Sq) continue;
#pragma unroll
    for (int d = 0; d < D / 8; ++d)
      *reinterpret_cast<uint32_t*>(dqb + r * q_ld + d * 8 + tq * 2) =
          pack_bf16(dqa[4 * d + 2 * i] * scale,
                    dqa[4 * d + 2 * i + 1] * scale);
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// The routes, as kernels/flash_attention_bwd.py's plan names them.
enum BwdRoute : int { kRouteFma = 0, kRouteMma = 1, kRouteWgmma = 2 };

struct FlashBwdLaunch {
  const void* q;
  const void* k;
  const void* v;
  const void* out;
  const void* dout;
  const float* lse;
  float* di;
  float* lse2;
  float* part;
  void* dq;
  void* dk;
  void* dv;
  int B, Sq, Sk, Hq, Hkv, causal, window, q_offset;
  int route, split, wg_q, Sq_pad;
  float scale;
  cudaStream_t stream;

  template <typename T, int D>
  int dot() const {
    const long long n_rows = static_cast<long long>(B) * Sq_pad * Hq;
    const long long n_dot = (n_rows * 4 + kBwdThreads - 1) / kBwdThreads;
    if (n_dot > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    flash_bwd_dot_kernel<T, D><<<static_cast<unsigned>(n_dot), kBwdThreads, 0,
                                 stream>>>(
        static_cast<const T*>(dout), static_cast<const T*>(out), lse, di,
        route == kRouteWgmma ? lse2 : nullptr, n_rows, Sq, Sq_pad, Hq);
    return static_cast<int>(cudaGetLastError());
  }

  template <int D>
  int wg_dkdv(const CUtensorMap& qm, const CUtensorMap& om,
              const CUtensorMap& km, const CUtensorMap& vm) const {
    constexpr int smem = KvLayout<D>::BYTES;
    static int granted[kMaxDevices] = {};
    int err = allow_smem((const void*)flash_bwd_dkdv_wg_kernel<D>, smem,
                         granted);
    if (err) return err;
    const int n_kt = (Sk + kWgRows - 1) / kWgRows;
    flash_bwd_dkdv_wg_kernel<D><<<dim3(split * Hkv, B, n_kt), kKvThreads,
                                  smem, stream>>>(
        qm, om, km, vm, lse2, di, static_cast<__nv_bfloat16*>(dk),
        static_cast<__nv_bfloat16*>(dv), part, Sq, Sq_pad, Sk, Hq, Hkv, split,
        causal, window, q_offset, scale, scale * kLog2e);
    err = static_cast<int>(cudaGetLastError());
    if (err || split == 1) return err;
    const long long n = static_cast<long long>(B) * Sk * Hkv * D;
    flash_bwd_dkdv_sum_kernel<<<static_cast<unsigned>((n / 4 + 255) / 256),
                                256, 0, stream>>>(
        part, static_cast<__nv_bfloat16*>(dk),
        static_cast<__nv_bfloat16*>(dv), n, split, scale);
    return static_cast<int>(cudaGetLastError());
  }

  template <int D, int NWG>
  int wg_dq(const CUtensorMap& qm, const CUtensorMap& om,
            const CUtensorMap& km, const CUtensorMap& vm) const {
    constexpr int smem = QLayout<D, NWG>::BYTES;
    static int granted[kMaxDevices] = {};
    const int err = allow_smem((const void*)flash_bwd_dq_wg_kernel<D, NWG>,
                               smem, granted);
    if (err) return err;
    const int n_q = (Sq + kWgRows - 1) / kWgRows;
    flash_bwd_dq_wg_kernel<D, NWG><<<dim3(Hq / NWG, B, n_q),
                                     wg_threads<NWG>(), smem, stream>>>(
        qm, om, km, vm, lse2, di, static_cast<__nv_bfloat16*>(dq), Sq, Sq_pad,
        Sk, Hq, Hkv, causal, window, q_offset, scale, scale * kLog2e);
    return static_cast<int>(cudaGetLastError());
  }

  // The wgmma route: tensor maps of q, dO, k and v, then the dK/dV pass
  // (and its sum over split parts) and the dQ pass.
  template <int D>
  int wgmma() const {
    const int rep = Hq / Hkv;
    if (split < 1 || (wg_q != 1 && wg_q != 2) ||
        rep % split != 0 || rep % wg_q != 0 ||
        (Sq + kWgRows - 1) / kWgRows > 65535 ||
        (Sk + kWgRows - 1) / kWgRows > 65535 ||
        (split > 1 && part == nullptr) || Sq_pad % kWgRows != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    // The Di pass first: its launch makes the device's context current on
    // this host thread, which cuTensorMapEncodeTiled needs (on autograd's
    // device thread nothing else may have done so yet).
    int err = dot<__nv_bfloat16, D>();
    CUtensorMap qm, om, km, vm;
    if (!err) err = rows_map(&qm, q, B, Sq, Hq, D);
    if (!err) err = rows_map(&om, dout, B, Sq, Hq, D);
    if (!err) err = rows_map(&km, k, B, Sk, Hkv, D);
    if (!err) err = rows_map(&vm, v, B, Sk, Hkv, D);
    if (err) return err;
    err = wg_dkdv<D>(qm, om, km, vm);
    if (err) return err;
    return wg_q == 2 ? wg_dq<D, 2>(qm, om, km, vm)
                     : wg_dq<D, 1>(qm, om, km, vm);
  }

  // The other routes: mma.sync for bf16, the FMA units for f32.
  template <typename T, int D>
  int plain_routes() const {
    const float scale_log2 = scale * kLog2e;
    if (Sq_pad != Sq) return static_cast<int>(cudaErrorInvalidValue);
    int err = dot<T, D>();
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

  // Each route launches its own kernels or refuses: a (dtype, head dim)
  // the route does not take returns cudaErrorInvalidValue.
  template <typename T, int D>
  int operator()() const {
    constexpr bool bf16 = std::is_same_v<T, __nv_bfloat16>;
    if (route == kRouteWgmma) {
      if constexpr (bf16 && D % 64 == 0) return wgmma<D>();
    } else if (route == kRouteMma) {
      if constexpr (bf16 && D % 64 != 0) return plain_routes<T, D>();
    } else if (route == kRouteFma) {
      if constexpr (!bf16) return plain_routes<T, D>();
    }
    return static_cast<int>(cudaErrorInvalidValue);
  }
};

}  // namespace attn

// dtype: 0 = f32, 1 = bf16. window <= 0 means no window. Query row i sits
// at position i + q_offset. route (0 fma, 1 mma, 2 wgmma), split, wg_q
// and Sq_pad come from flash_attention_bwd.py's plan. di (and, on the
// wgmma route, lse2) are (B, Hq, Sq_pad) f32 scratch the call fills; part
// is the (split, 2, B, Sk, Hkv, D) f32 scratch of the wgmma route's dK/dV
// parts (null for split 1).
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const float* lse, float* di, float* lse2, float* part,
    void* dq, void* dk, void* dv, int B, int Sq, int Sk, int Hq, int Hkv,
    int D, int dtype, int causal, int window, int q_offset, int route,
    int split, int wg_q, int Sq_pad, float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Hkv <= 0 || Hq % Hkv != 0 ||
      Hq > 65535 || Hkv > 65535 || B > 65535 || Sq_pad < Sq)
    return static_cast<int>(cudaErrorInvalidValue);
  const attn::FlashBwdLaunch f{q,      k,      v,      out,   dout,  lse,
                               di,     lse2,   part,   dq,    dk,    dv,
                               B,      Sq,     Sk,     Hq,    Hkv,   causal,
                               window, q_offset, route, split, wg_q,  Sq_pad,
                               scale,  static_cast<cudaStream_t>(stream)};
  return attn::dispatch(dtype, D, f);
}

// flash_attention: causal / sliding-window / full GQA attention with an
// online softmax, the (Sq, Sk) score matrix never leaving the block.
// q (B, Sq, Hq, D), k and v (B, Sk, Hkv, D), out (B, Sq, Hq, D), all of
// one element type (bf16 or f32); f32 accumulation throughout.
//
// Replaces the TPU kernel flash_attention_pallas (src/repro/kernels/
// flash_attention.py). Same function: queries right-aligned
// (query i sits at position i + Sk - Sq), KV head h / rep, keep a key iff
// kpos <= qpos (causal) and kpos > qpos - window, running max from -1e30,
// masked probabilities exactly 0, a row with nothing kept writes 0. The
// Pallas kernel walks a sequential grid over K blocks with VMEM scratch and
// needs Sq and Sk to divide its blocks; here one thread block owns a tile
// of 32 query rows of one (b, head) and loops over K/V tiles itself,
// masking the ragged edges, so prompts of any length run.
//
// Bound on an H100: operations. At the prefill shapes of the main path
// (qwen2-1.5b, 8 prompts of 512, 12 query heads of 128 over 2 KV heads)
// the causal half of QK^T and PV is 6.4 GFLOP per layer against about
// 25 MB of q/k/v/out traffic: 6.5 us at the bf16 tensor-core peak, 7.5 us
// at 3.35 TB/s. This first version runs the products on the f32 FMA
// units (4 threads per query row, each owning D/4 columns; K/V tiles of
// 32 keys staged in shared memory as f32; scores of a tile kept in
// registers, one online-softmax update per tile; tiles wholly outside the
// causal/window band are never loaded). Moving QK^T and PV to the tensor
// cores (mma.sync or wgmma) is the next step.
#include "attention.cuh"

namespace attn {

constexpr int kFlashThreads = 128;
constexpr int kRowsPerBlock = 32;
constexpr int kThreadsPerRow = kFlashThreads / kRowsPerBlock;   // 4
constexpr int kKeysPerTile = 32;

template <typename T, int D>
__global__ void __launch_bounds__(kFlashThreads) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ out, int Sq, int Sk, int Hq,
    int Hkv, int causal, int window, float scale_log2) {
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
  const int q_offset = Sk - Sq;
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
  const float inv = 1.f / (l > 0.f ? l : 1.f);
  const size_t o_row = ((static_cast<size_t>(b) * Sq + qi) * Hq + h) * D;
#pragma unroll
  for (int c = 0; c < CPT; ++c)
    Vec4<T>::store(out + o_row + (g + c * kThreadsPerRow) * 4,
                   scale4(acc[c], inv));
}

struct FlashLaunch {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int B, Sq, Sk, Hq, Hkv, causal, window;
  float scale_log2;
  cudaStream_t stream;

  template <typename T, int D>
  int operator()() const {
    const dim3 grid((Sq + kRowsPerBlock - 1) / kRowsPerBlock, Hq, B);
    flash_attention_kernel<T, D><<<grid, kFlashThreads, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(out), Sq, Sk, Hq, Hkv,
        causal, window, scale_log2);
    return static_cast<int>(cudaGetLastError());
  }
};

}  // namespace attn

// dtype: 0 = f32, 1 = bf16. window <= 0 means no window.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, int B, int Sq,
    int Sk, int Hq, int Hkv, int D, int dtype, int causal, int window,
    float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Hkv <= 0 || Hq % Hkv != 0 ||
      Hq > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const attn::FlashLaunch f{q, k, v, out, B, Sq, Sk, Hq, Hkv, causal,
                            window, scale * attn::kLog2e,
                            static_cast<cudaStream_t>(stream)};
  return attn::dispatch(dtype, D, f);
}

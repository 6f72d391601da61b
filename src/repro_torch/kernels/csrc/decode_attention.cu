// decode_attention: one query token per sequence against its KV cache,
// GQA, prefix or ring layout. q (B, Hq, D), caches (B, S, Hkv, D) of one
// element type (bf16 or f32), lengths (B,) int32 read on the device,
// out (B, Hq, D); f32 accumulation throughout.
//
// Replaces the TPU kernel decode_attention_pallas (src/repro/kernels/
// decode_attention.py). Same function: the rep = Hq / Hkv query heads of
// one KV head share every K/V load; prefix mode keeps kpos < length
// (a length above S counts as S) and, with a window, kpos >= length -
// window; ring mode reads `lengths` as the absolute position pos, slot s
// holding position pos - ((pos - s + S (pos / S + 1)) mod S), kept iff
// >= 0 and > pos - window. Running max from -1e30, masked probabilities
// exactly 0, a head with nothing kept writes 0. The Pallas kernel walks a
// sequential grid over cache blocks with VMEM scratch; here one thread
// block owns one (b, KV head) and walks the live slots [lo, hi) itself in
// tiles of 64: slots past the length (and, in prefix mode, before the
// window) are never read, and no host sync is needed for the lengths.
//
// Bound on an H100: bytes. Each live cache row is read once (2 Hkv D
// elements per slot per sequence) against 4 rep D flops per row per KV
// head; at the main path's decode (qwen2-1.5b, 16 slots of a 1024-long
// cache, 12 query heads over 2 KV heads, D 128, bf16) that is at most
// 16.8 MB per layer, 5 us at 3.35 TB/s. This first version gives each
// (b, KV head) one block of 256 threads: 32 blocks on 132 SMs at the
// main path's shape, each streaming its rows tile by tile (K/V staged in
// shared memory as f32, scores and probabilities of all rep heads in
// shared memory, one online-softmax update per tile). Splitting the cache
// over more blocks (split-KV) is the next step.
#include "attention.cuh"

namespace attn {

constexpr int kDecThreads = 256;
constexpr int kDecWarps = kDecThreads / 32;
constexpr int kSlotsPerTile = 64;
constexpr int kMaxAcc4 = 2;   // float4 accumulators per thread: rep D <= 2048

template <int D>
__host__ __device__ constexpr int ks_stride4() { return D / 4 + 1; }

template <int D>
__host__ __device__ constexpr size_t decode_smem_bytes(int rep) {
  return sizeof(float) * (static_cast<size_t>(rep) * D              // q
                          + kSlotsPerTile * ks_stride4<D>() * 4     // K
                          + kSlotsPerTile * D                       // V
                          + static_cast<size_t>(rep) * kSlotsPerTile  // p
                          + 3 * static_cast<size_t>(rep));          // m l a
}

template <typename T, int D>
__global__ void __launch_bounds__(kDecThreads) decode_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ kc,
    const T* __restrict__ vc, const int* __restrict__ lengths,
    T* __restrict__ out, int S, int Hkv, int rep, int window, int ring,
    float scale_log2) {
  constexpr int C4 = D / 4;
  constexpr int KS4 = ks_stride4<D>();   // padded: conflict-free row reads
  extern __shared__ float4 smem4[];
  float4* qs = smem4;                                  // [rep][C4]
  float4* ks = qs + rep * C4;                          // [tile][KS4]
  float4* vs = ks + kSlotsPerTile * KS4;               // [tile][C4]
  float* ps = reinterpret_cast<float*>(vs + kSlotsPerTile * C4);  // [rep][tile]
  float* m_s = ps + rep * kSlotsPerTile;
  float* l_s = m_s + rep;
  float* a_s = l_s + rep;

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int Hq = Hkv * rep;
  const int length = lengths[b];
  int lo = 0;
  int hi;
  if (ring) {
    hi = min(S, length + 1);   // slots past pos are unwritten while pos < S
  } else {
    hi = min(S, length);
    if (window > 0) lo = max(0, length - window);
  }

  const size_t q_base = (static_cast<size_t>(b) * Hq + kvh * rep) * D;
  for (int i = threadIdx.x; i < rep * C4; i += kDecThreads)
    qs[i] = scale4(Vec4<T>::load(q + q_base + i * 4), scale_log2);
  for (int r = threadIdx.x; r < rep; r += kDecThreads) {
    m_s[r] = kNegInit;
    l_s[r] = 0.f;
  }
  float4 acc[kMaxAcc4];
#pragma unroll
  for (int e = 0; e < kMaxAcc4; ++e) acc[e] = make_float4(0.f, 0.f, 0.f, 0.f);

  const size_t slot_stride = static_cast<size_t>(Hkv) * D;
  const T* kb = kc + (static_cast<size_t>(b) * S * Hkv + kvh) * D;
  const T* vb = vc + (static_cast<size_t>(b) * S * Hkv + kvh) * D;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  for (int t0 = lo; t0 < hi; t0 += kSlotsPerTile) {
    const int n = min(kSlotsPerTile, hi - t0);
    __syncthreads();   // the previous tile is consumed; q and stats set
    for (int i = threadIdx.x; i < n * C4; i += kDecThreads) {
      const int j = i / C4;
      const int c = i % C4;
      const size_t off = (t0 + j) * slot_stride + c * 4;
      ks[j * KS4 + c] = Vec4<T>::load(kb + off);
      vs[j * C4 + c] = Vec4<T>::load(vb + off);
    }
    __syncthreads();

    // scores of (head r, slot j), log2 domain; -inf where masked
    for (int i = threadIdx.x; i < rep * kSlotsPerTile; i += kDecThreads) {
      const int r = i / kSlotsPerTile;
      const int j = i % kSlotsPerTile;
      float s = -INFINITY;
      if (j < n) {
        bool keep = true;
        if (ring) {
          const int kpos = t0 + j;
          const int ap = length - (length - kpos + S * (length / S + 1)) % S;
          keep = ap >= 0 && (window <= 0 || ap > length - window);
        }
        if (keep) {
          float part = 0.f;
#pragma unroll
          for (int c = 0; c < C4; ++c)
            part = dot4(qs[r * C4 + c], ks[j * KS4 + c], part);
          s = part;
        }
      }
      ps[r * kSlotsPerTile + j] = s;
    }
    __syncthreads();

    // one online-softmax update per head: warp w takes heads w, w+8, ...
    for (int r = warp; r < rep; r += kDecWarps) {
      float* pr = ps + r * kSlotsPerTile;
      float mt = kNegInit;
      for (int j = lane; j < kSlotsPerTile; j += 32) mt = fmaxf(mt, pr[j]);
      for (int o = 16; o > 0; o >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mt);
      float sum = 0.f;
      for (int j = lane; j < kSlotsPerTile; j += 32) {
        const float p = exp2f(pr[j] - m_new);   // exactly 0 where masked
        pr[j] = p;
        sum += p;
      }
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float alpha = exp2f(m_old - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc[r][chunk] = alpha_r acc + sum_j p[r][j] v[j][chunk]
#pragma unroll
    for (int e = 0; e < kMaxAcc4; ++e) {
      const int u = threadIdx.x + e * kDecThreads;
      if (u < rep * C4) {
        const int r = u / C4;
        const int c = u % C4;
        const float* pr = ps + r * kSlotsPerTile;
        float4 a = scale4(acc[e], a_s[r]);
        for (int j = 0; j < n; ++j) a = fma4(pr[j], vs[j * C4 + c], a);
        acc[e] = a;
      }
    }
  }

  __syncthreads();   // l_s final
  const size_t o_base = (static_cast<size_t>(b) * Hq + kvh * rep) * D;
#pragma unroll
  for (int e = 0; e < kMaxAcc4; ++e) {
    const int u = threadIdx.x + e * kDecThreads;
    if (u < rep * C4) {
      const float l = l_s[u / C4];
      Vec4<T>::store(out + o_base + u * 4,
                     scale4(acc[e], 1.f / (l > 0.f ? l : 1.f)));
    }
  }
}

struct DecodeLaunch {
  const void* q;
  const void* kc;
  const void* vc;
  const int* lengths;
  void* out;
  int B, S, Hkv, rep, window, ring;
  float scale_log2;
  cudaStream_t stream;

  template <typename T, int D>
  int operator()() const {
    if (rep * D > kMaxAcc4 * kDecThreads * 4)
      return static_cast<int>(cudaErrorInvalidValue);
    const int smem = static_cast<int>(decode_smem_bytes<D>(rep));
    auto kernel = decode_attention_kernel<T, D>;
    // The opt-in above 48 KB is per device; remember what each was given.
    static int granted[64] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
    if (smem > granted[dev]) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      granted[dev] = smem;
    }
    kernel<<<dim3(Hkv, B), kDecThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(kc),
        static_cast<const T*>(vc), lengths, static_cast<T*>(out), S, Hkv,
        rep, window, ring, scale_log2);
    return static_cast<int>(cudaGetLastError());
  }
};

}  // namespace attn

// dtype: 0 = f32, 1 = bf16. window <= 0 means no window; ring != 0 reads
// lengths as absolute positions of a rolling ring.
extern "C" int decode_attention_launch(
    const void* q, const void* kc, const void* vc, const int* lengths,
    void* out, int B, int S, int Hq, int Hkv, int D, int dtype, int window,
    int ring, float scale, void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || Hq % Hkv != 0 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const attn::DecodeLaunch f{q, kc, vc, lengths, out, B, S, Hkv, Hq / Hkv,
                             window, ring, scale * attn::kLog2e,
                             static_cast<cudaStream_t>(stream)};
  return attn::dispatch(dtype, D, f);
}

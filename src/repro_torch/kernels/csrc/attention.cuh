// Shared helpers of the attention kernels (flash_attention,
// flash_attention_bwd, decode_attention): four-element loads and stores
// that convert between the tensor's element type (bf16 or f32) and f32,
// the masked-score value, a row's log-sum-exp, the PTX wrappers (cp.async,
// ldmatrix, mma.sync), the opt-in to more than 48 KB of dynamic shared
// memory and the launch-time dispatch over head dims.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace attn {

// The reference's mask value: running maxima start here. Masked scores are
// -inf, so exp2(score - max) is exactly 0 for them while every running
// maximum stays finite.
constexpr float kNegInit = -1.0e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float4 fma4(float a, float4 x, float4 acc) {
  acc.x = fmaf(a, x.x, acc.x);
  acc.y = fmaf(a, x.y, acc.y);
  acc.z = fmaf(a, x.z, acc.z);
  acc.w = fmaf(a, x.w, acc.w);
  return acc;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float4 scale4(float4 a, float s) {
  return make_float4(a.x * s, a.y * s, a.z * s, a.w * s);
}

// A row's log-sum-exp in natural-log units from its running max m (log2
// domain) and sum l; kNegInit for a row that kept no key (l == 0).
__device__ __forceinline__ float row_lse(float m, float l) {
  return l > 0.f ? (m + log2f(l)) * kLn2 : kNegInit;
}

// Four consecutive elements at p (16-byte aligned for f32, 8 for bf16).
template <typename T>
struct Vec4;

template <>
struct Vec4<float> {
  static __device__ __forceinline__ float4 load(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  static __device__ __forceinline__ void store(float* p, float4 v) {
    *reinterpret_cast<float4*>(p) = v;
  }
};

template <>
struct Vec4<__nv_bfloat16> {
  static __device__ __forceinline__ float4 load(const __nv_bfloat16* p) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    __nv_bfloat162 lo, hi;
    *reinterpret_cast<uint32_t*>(&lo) = u.x;
    *reinterpret_cast<uint32_t*>(&hi) = u.y;
    const float2 a = __bfloat1622float2(lo);
    const float2 b = __bfloat1622float2(hi);
    return make_float4(a.x, a.y, b.x, b.y);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float4 v) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
    uint2 u;
    u.x = *reinterpret_cast<const uint32_t*>(&lo);
    u.y = *reinterpret_cast<const uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(p) = u;
  }
};

// ---------------------------------------------------------------------------
// PTX wrappers (sm_80 and later)
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy, bypassing L1. With valid false nothing is
// read and the 16 bytes are zero-filled (the src-size form), so a ragged
// tile edge holds zeros, never stale data.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid = true) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of
// matrix i, register i receives its fragment.
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr) : "memory");
}

// Two 8x8 b16 matrices from the row addresses of lanes 0..15.
__device__ __forceinline__ void ldsm_x2(uint32_t addr, uint32_t (&r)[2]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(addr) : "memory");
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t addr,
                                              uint32_t (&r)[2]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1]) : "r"(addr) : "memory");
}

// Four matrices, each transposed on the way.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr,
                                              uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr) : "memory");
}

// c += a b for a 16x16 bf16 A (row), a 16x8 bf16 B (col), f32 C.
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 rounded to bf16, lo in the low half (the lower column).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A kernel may take more than 48 KB of dynamic shared memory only after a
// per-device opt-in. `granted` (one entry per device, kept by the caller
// for its kernel) remembers what each device was given, so the attribute
// is set once.
constexpr int kMaxDevices = 64;

inline int allow_smem(const void* kernel, int bytes, int* granted) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (bytes > granted[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    granted[dev] = bytes;
  }
  return 0;
}

// Calls f.template operator()<T, D>() for the runtime (dtype, head dim);
// returns cudaErrorInvalidValue for a pair with no instantiation.
template <typename F>
int dispatch(int dtype, int D, F&& f) {
#define ATTN_CASE(DIM)                                                    \
  case DIM:                                                               \
    return dtype == kBF16 ? f.template operator()<__nv_bfloat16, DIM>()   \
                          : f.template operator()<float, DIM>();
  if (dtype != kF32 && dtype != kBF16)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (D) {
    ATTN_CASE(16)
    ATTN_CASE(32)
    ATTN_CASE(64)
    ATTN_CASE(80)
    ATTN_CASE(96)
    ATTN_CASE(128)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef ATTN_CASE
}

}  // namespace attn

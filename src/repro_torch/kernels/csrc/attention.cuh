// Shared helpers of the attention kernels (flash_attention,
// decode_attention): four-element loads and stores that convert between
// the tensor's element type (bf16 or f32) and f32, the masked-score value
// and the launch-time dispatch over head dims.
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

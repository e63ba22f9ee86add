// Packs of 8 elements and their conversions, shared by the norm kernels
// of this directory (rmsnorm.cu, fused_add_rmsnorm.cu): a row is read and
// written as 16-byte words (two for f32), converted to f32 for the
// arithmetic and rounded back to its type.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace normpack {

typedef __nv_bfloat16 bf16;

// 8 elements of T as raw 16-byte words
template <typename T>
struct Pack {
  uint4 u[sizeof(T) / 2];
};

template <typename T>
__device__ __forceinline__ void load(Pack<T>& p, const T* src) {
#pragma unroll
  for (int i = 0; i < (int)sizeof(T) / 2; ++i)
    p.u[i] = reinterpret_cast<const uint4*>(src)[i];
}

__device__ __forceinline__ void to_f32(const Pack<bf16>& p, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(p.u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}
__device__ __forceinline__ void to_f32(const Pack<__half>& p, float* f) {
  const __half2* h = reinterpret_cast<const __half2*>(p.u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __half22float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}
__device__ __forceinline__ void to_f32(const Pack<float>& p, float* f) {
  const float* s = reinterpret_cast<const float*>(p.u);
#pragma unroll
  for (int i = 0; i < 8; ++i) f[i] = s[i];
}

// v rounded to T and back
template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<bf16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}
template <>
__device__ __forceinline__ float round_to<__half>(float v) {
  return __half2float(__float2half(v));
}
template <>
__device__ __forceinline__ float round_to<float>(float v) {
  return v;
}

// a and b each rounded to T and back (the same values as round_to), the
// pair in one conversion for the 16-bit types
template <typename T>
__device__ __forceinline__ void round2_to(float& a, float& b);
template <>
__device__ __forceinline__ void round2_to<bf16>(float& a, float& b) {
  const float2 t = __bfloat1622float2(__floats2bfloat162_rn(a, b));
  a = t.x;
  b = t.y;
}
template <>
__device__ __forceinline__ void round2_to<__half>(float& a, float& b) {
  const float2 t = __half22float2(__floats2half2_rn(a, b));
  a = t.x;
  b = t.y;
}
template <>
__device__ __forceinline__ void round2_to<float>(float&, float&) {}

__device__ __forceinline__ void store(bf16* dst, const float* f) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  *reinterpret_cast<uint4*>(dst) = u;
}
__device__ __forceinline__ void store(__half* dst, const float* f) {
  uint4 u;
  __half2* h = reinterpret_cast<__half2*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2half2_rn(f[2 * i], f[2 * i + 1]);
  *reinterpret_cast<uint4*>(dst) = u;
}
__device__ __forceinline__ void store(float* dst, const float* f) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(f[0], f[1], f[2], f[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(f[4], f[5], f[6], f[7]);
}

// the output type of x and g: x's where the two share a 16-bit type
// (``paired``), else f32
template <typename TX, typename TG>
struct Out {
  typedef float type;
  static constexpr bool paired = false;
};
template <> struct Out<bf16, bf16> {
  typedef bf16 type;
  static constexpr bool paired = true;
};
template <> struct Out<__half, __half> {
  typedef __half type;
  static constexpr bool paired = true;
};

}  // namespace normpack

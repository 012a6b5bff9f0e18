// Shared helpers for the port's hand-written Hopper kernels: dtype codes
// (matching voicecraft_tpu_torch/ops/_native.py), conversions to and from
// f32, 8-wide vector loads and warp reductions.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace vc {

// dtype codes passed across the C interface (ops/_native.py DTYPE_CODES)
enum DType : int { kF32 = 0, kBF16 = 1, kFP8E4M3 = 2 };

// masked attention logit, as ops/attention.py NEG_INF (not -inf)
constexpr float kNegInf = -1e9f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(__nv_fp8_e4m3 x) {
  return static_cast<float>(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// 8 consecutive elements as f32; p must be 16-byte aligned (8 for fp8)
__device__ __forceinline__ void load8(const float* p, float (&o)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&o)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 h;
    *reinterpret_cast<uint32_t*>(&h) = w[i];
    const float2 f = __bfloat1622float2(h);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const __nv_fp8_e4m3* p, float (&o)[8]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const uint32_t w[2] = {u.x, u.y};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    __nv_fp8_e4m3 e;
    e.__x = static_cast<__nv_fp8_storage_t>((w[i / 4] >> (8 * (i % 4))) & 0xffu);
    o[i] = static_cast<float>(e);
  }
}

// the first n (<= 8) elements, zeros after; vector load when allowed
template <typename W>
__device__ __forceinline__ void load8_masked(const W* p, int n, bool vec_ok,
                                             float (&o)[8]) {
  if (vec_ok && n >= 8) {
    load8(p, o);
    return;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) o[i] = i < n ? to_float(p[i]) : 0.f;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace vc

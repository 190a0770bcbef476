// Helpers of the int8 kernels (quant_gemm.cu: K4/K5/K8's quantize pass
// and block-scaled GEMM): the tanh-approximation gelu and its derivative,
// the IEEE-exact int8 quantizer, and vector loads and stores of fp32 or
// bf16 rows as fp32.
//
// Every rounding step is written with __f*_rn intrinsics so that nvcc does
// not contract a multiply and an add into one FMA: the plain versions in
// ops/quant_matmul.py round each operation, and the kernels give the same
// bits.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dtt {

// jax.nn.gelu(approximate=True) and its derivative, in the JAX code's
// operation order with every step rounded.
constexpr float kGeluC = 0.7978845608028654f;
constexpr float kGeluA = 0.044715f;
constexpr float kGelu3A = (float)(3.0 * 0.044715);

__device__ __forceinline__ float tanh_arg(float y) {
  const float y3 = __fmul_rn(__fmul_rn(__fmul_rn(kGeluA, y), y), y);
  return __fmul_rn(kGeluC, __fadd_rn(y, y3));
}
__device__ __forceinline__ float gelu(float y) {
  const float t = tanhf(tanh_arg(y));
  return __fmul_rn(__fmul_rn(0.5f, y), __fadd_rn(1.0f, t));
}
__device__ __forceinline__ float dgelu(float y) {
  const float t = tanhf(tanh_arg(y));
  const float dt = __fmul_rn(
      __fmul_rn(__fsub_rn(1.0f, __fmul_rn(t, t)), kGeluC),
      __fadd_rn(1.0f, __fmul_rn(__fmul_rn(kGelu3A, y), y)));
  return __fadd_rn(__fmul_rn(0.5f, __fadd_rn(1.0f, t)),
                   __fmul_rn(__fmul_rn(0.5f, y), dt));
}

// q = clamp(rint(v / s), -127, 127), rounding half to even, with the
// result of the IEEE division: v * (1/s) is within 1.5 ulp of v / s, so
// the two round to different integers only when v * (1/s) lies within
// that distance of a half-integer (< 1.2e-5 for |v / s| <= 128); there
// the division itself is taken.
__device__ __forceinline__ int quant1(float v, float s, float rs) {
  float y = __fmul_rn(v, rs);
  if (fabsf(y - floorf(y) - 0.5f) < 1e-4f) y = __fdiv_rn(v, s);
  return max(-127, min(127, __float2int_rn(y)));
}

// Four codes packed little-endian into one word.
__device__ __forceinline__ uint32_t quant4(const float* v, float s,
                                           float rs) {
  uint32_t packed = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    packed |= (uint32_t)(uint8_t)(int8_t)quant1(v[i], s, rs) << (8 * i);
  return packed;
}

// N consecutive elements (N = 4 or 8; 8 * N or 16 * N bytes aligned) as
// fp32, and back, rounded to the element type.
template <int N>
__device__ __forceinline__ void loadv(const float* p, float* v) {
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    const float4 f = *reinterpret_cast<const float4*>(p + i);
    v[i] = f.x; v[i + 1] = f.y; v[i + 2] = f.z; v[i + 3] = f.w;
  }
}
template <int N>
__device__ __forceinline__ void loadv(const __nv_bfloat16* p, float* v) {
  static_assert(N == 4 || N == 8, "4 or 8 bf16 values");
  uint32_t w[N / 2];
  if constexpr (N == 8) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    w[0] = u.x; w[1] = u.y; w[2] = u.z; w[3] = u.w;
  } else {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    w[0] = u.x; w[1] = u.y;
  }
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
template <int N>
__device__ __forceinline__ void storev(float* p, const float* v) {
#pragma unroll
  for (int i = 0; i < N; i += 4)
    *reinterpret_cast<float4*>(p + i) =
        make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
}
template <int N>
__device__ __forceinline__ void storev(__nv_bfloat16* p, const float* v) {
  static_assert(N == 4 || N == 8, "4 or 8 bf16 values");
  uint32_t w[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    __nv_bfloat162 b = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    w[i] = *reinterpret_cast<uint32_t*>(&b);
  }
  if constexpr (N == 8)
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  else
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
}

// A pair of adjacent output columns: round to T and store (4- or 8-byte
// aligned, since the column is even); returns the rounded values.
__device__ __forceinline__ float2 store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
  return make_float2(a, b);
}
__device__ __forceinline__ float2 store2(__nv_bfloat16* p, float a,
                                         float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  *reinterpret_cast<__nv_bfloat162*>(p) = v;
  return __bfloat1622float2(v);
}
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

}  // namespace dtt

// GELU forms of the training kernels (float32 math), and the dtype helpers they share.
//
// The same formulas as wav2vec_heart_sounds_tpu_torch/ops/gelu.py, ported from
// wav2vec_heart_sounds_tpu/ops/pallas/conv.py:47-104: the Abramowitz-Stegun 7.1.26
// rational erf (max abs error 1.5e-7; the float32 FFN activation) and the tanh
// approximation (the bfloat16 FFN activation), each with its own gradient. Divisions are
// IEEE (no fast-math), as in the plain version.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace w2v {

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// v rounded to T and back (the compute-dtype rounding point of a float32 value).
template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) { return v; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

constexpr float kSqrt2 = 1.4142135623730951f;
constexpr float kInvSqrt2Pi = 0.3989422804014327f;
constexpr float kTanhK0 = 0.7978845608028654f;   // sqrt(2 / pi)
constexpr float kTanhK1 = 0.044715f;

__device__ __forceinline__ float erf_rational(float x) {
  const float sign = static_cast<float>((x > 0.f) - (x < 0.f));   // jnp.sign: sign(0) = 0
  const float a = fabsf(x);
  const float t = 1.f / (1.f + 0.3275911f * a);
  const float poly = t * (0.254829592f + t * (-0.284496736f + t * (1.421413741f
                     + t * (-1.453152027f + t * 1.061405429f))));
  return sign * (1.f - poly * expf(-a * a));
}

__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.f + erf_rational(x / kSqrt2));
}

__device__ __forceinline__ float gelu_erf_grad(float x) {
  return 0.5f * (1.f + erf_rational(x / kSqrt2)) + x * expf(-0.5f * x * x) * kInvSqrt2Pi;
}

__device__ __forceinline__ float gelu_tanh(float x) {
  const float u = kTanhK0 * (x + kTanhK1 * x * x * x);
  return 0.5f * x * (1.f + tanhf(u));
}

__device__ __forceinline__ float gelu_tanh_grad(float x) {
  const float u = kTanhK0 * (x + kTanhK1 * x * x * x);
  const float th = tanhf(u);
  const float du = kTanhK0 * (1.f + 3.f * kTanhK1 * x * x);
  return 0.5f * (1.f + th) + 0.5f * x * (1.f - th * th) * du;
}

}  // namespace w2v

// GELU forms of the training kernels (float32 math), and the dtype helpers they share
// (Run16: 16 bytes of a dtype as floats, the unit of the kernels' 16-byte accesses).
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

// 16 bytes of T: N values, unpacked to float and packed back with round-to-nearest.
template <typename T>
struct Run16;

template <>
struct Run16<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void unpack(const uint4& r, float (&v)[4]) {
    v[0] = __uint_as_float(r.x);
    v[1] = __uint_as_float(r.y);
    v[2] = __uint_as_float(r.z);
    v[3] = __uint_as_float(r.w);
  }
  static __device__ __forceinline__ uint4 pack(const float (&v)[4]) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                      __float_as_uint(v[3]));
  }
};

template <>
struct Run16<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void unpack(const uint4& r, float (&v)[8]) {
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(p[j]);
      v[2 * j] = f.x;
      v[2 * j + 1] = f.y;
    }
  }
  static __device__ __forceinline__ uint4 pack(const float (&v)[8]) {
    uint4 r;
    __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
    for (int j = 0; j < 4; ++j) p[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
    return r;
  }
};

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

// kQuick: the two divisions of the form as products (x times the float 1 / sqrt(2), the
// reciprocal by __fdividef, a few float ulp off): no branch per element, for a result
// rounded to bfloat16 in an epilogue that few warps run (K8's bfloat16 forward).
template <bool kQuick = false>
__device__ __forceinline__ float erf_rational(float x) {
  const float sign = static_cast<float>((x > 0.f) - (x < 0.f));   // jnp.sign: sign(0) = 0
  const float a = fabsf(x);
  const float d = 1.f + 0.3275911f * a;
  const float t = kQuick ? __fdividef(1.f, d) : 1.f / d;
  const float poly = t * (0.254829592f + t * (-0.284496736f + t * (1.421413741f
                     + t * (-1.453152027f + t * 1.061405429f))));
  return sign * (1.f - poly * expf(-a * a));
}

template <bool kQuick = false>
__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.f + erf_rational<kQuick>(kQuick ? x * (1.f / kSqrt2) : x / kSqrt2));
}

__device__ __forceinline__ float gelu_erf_grad(float x) {
  return 0.5f * (1.f + erf_rational(x / kSqrt2)) + x * expf(-0.5f * x * x) * kInvSqrt2Pi;
}

// gelu_erf_grad in the plain version's order of operations (ops/gelu.py) as PyTorch runs it
// on the card: each operation rounded on its own (no contraction), x / sqrt(2) as the product
// with the float32 reciprocal (PyTorch's division by a Python scalar). Bit for bit the plain
// version's value, for kernels whose output is checked bit for bit.
__device__ __forceinline__ float erf_rational_rn(float x) {
  const float sign = static_cast<float>((x > 0.f) - (x < 0.f));
  const float a = fabsf(x);
  const float t = __fdiv_rn(1.f, __fadd_rn(1.f, __fmul_rn(0.3275911f, a)));
  float poly = __fadd_rn(-1.453152027f, __fmul_rn(t, 1.061405429f));
  poly = __fadd_rn(1.421413741f, __fmul_rn(t, poly));
  poly = __fadd_rn(-0.284496736f, __fmul_rn(t, poly));
  poly = __fmul_rn(t, __fadd_rn(0.254829592f, __fmul_rn(t, poly)));
  return __fmul_rn(sign, __fsub_rn(1.f, __fmul_rn(poly, expf(__fmul_rn(-a, a)))));
}

__device__ __forceinline__ float gelu_erf_grad_rn(float x) {
  constexpr float kInvSqrt2 = 1.f / kSqrt2;
  const float cdf = __fmul_rn(0.5f, __fadd_rn(1.f, erf_rational_rn(__fmul_rn(x, kInvSqrt2))));
  const float pdf = __fmul_rn(__fmul_rn(x, expf(__fmul_rn(__fmul_rn(-0.5f, x), x))), kInvSqrt2Pi);
  return __fadd_rn(cdf, pdf);
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

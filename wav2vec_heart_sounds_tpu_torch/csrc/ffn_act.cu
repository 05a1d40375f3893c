// FFN activation dropout(gelu(pre)) for NVIDIA Hopper (sm_90a): forward and backward.
//
// Replaces the TPU kernel wav2vec_heart_sounds_tpu/ops/pallas/ffn.py::dense_gelu_dropout
// (K5). As there, the kernel holds only the activation pass: the products pre = x W^T + b,
// dx and dW stay matrix products outside it. Contract (the plain version in
// ops/kernels/ffn.py):
//   forward:  y = keep ? act(pre) * scale : 0, rounded to the input dtype;
//   backward: dpre = (keep ? g * scale : 0) * act'(pre), and per-chunk partial column sums
//             of the float32 dpre (the bias gradient), which the caller adds up.
// act is the rational-erf GELU in float32 and the tanh GELU in bfloat16 (gelu.cuh), as the
// JAX kernel's default. The mask is Philox4x32-10 over the row-major element index
// (philox.cuh), the same in both passes and in the plain version.
//
// What bounds it on this card: bytes, with the GELU's exp/tanh close behind (forward reads
// and writes 117 MB at [96*199, 3072] bf16, ~70 us at HBM speed). The forward is a flat
// elementwise pass, one thread per group of four elements (one Philox call each). The
// backward gives each thread four adjacent columns of a chunk of rows, so the bias partial
// sums stay in registers and need no atomics: every run reproduces.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "gelu.cuh"
#include "philox.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kColsPerBlock = 4 * kThreads;
constexpr long long kMaxBlocks = 8192;

template <bool kTanh>
__device__ __forceinline__ float act(float x) {
  return kTanh ? w2v::gelu_tanh(x) : w2v::gelu_erf(x);
}

template <bool kTanh>
__device__ __forceinline__ float act_grad(float x) {
  return kTanh ? w2v::gelu_tanh_grad(x) : w2v::gelu_erf_grad(x);
}

template <typename T, bool kTanh>
__global__ void __launch_bounds__(kThreads)
ffn_act_fwd_kernel(const T* __restrict__ pre, T* __restrict__ y, long long n, uint32_t seed,
                   uint32_t site, uint32_t thr, float scale) {
  const long long groups = (n + 3) >> 2;
  for (long long g = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       g < groups; g += static_cast<long long>(gridDim.x) * blockDim.x) {
    uint4 w = make_uint4(0u, 0u, 0u, 0u);
    if (thr) w = w2v::philox_group(seed, site, static_cast<unsigned long long>(g));
    const uint32_t bits[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long i = 4 * g + j;
      if (i < n)
        w2v::store(y + i, bits[j] >= thr ? act<kTanh>(w2v::to_float(pre[i])) * scale : 0.f);
    }
  }
}

template <typename T, bool kTanh>
__global__ void __launch_bounds__(kThreads)
ffn_act_bwd_kernel(const T* __restrict__ g, const T* __restrict__ pre, T* __restrict__ dpre,
                   float* __restrict__ dbias_part, int rows, int cols, uint32_t seed,
                   uint32_t site, uint32_t thr, float scale) {
  const int c = blockIdx.x * kColsPerBlock + 4 * threadIdx.x;
  if (c >= cols) return;
  const int per_chunk = (rows + gridDim.y - 1) / gridDim.y;
  const int r0 = blockIdx.y * per_chunk;
  const int r1 = min(rows, r0 + per_chunk);
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int r = r0; r < r1; ++r) {
    const size_t base = static_cast<size_t>(r) * cols + c;
    uint4 w = make_uint4(0u, 0u, 0u, 0u);
    if (thr) w = w2v::philox_group(seed, site, static_cast<unsigned long long>(base >> 2));
    const uint32_t bits[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float gd = bits[j] >= thr ? w2v::to_float(g[base + j]) * scale : 0.f;
      const float d = gd * act_grad<kTanh>(w2v::to_float(pre[base + j]));
      w2v::store(dpre + base + j, d);
      acc[j] += d;
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) dbias_part[static_cast<size_t>(blockIdx.y) * cols + c + j] = acc[j];
}

}  // namespace

// C entry points, bound with ctypes. dtype: 0 = float32 (rational-erf GELU), 1 = bfloat16
// (tanh GELU). Each returns the cudaError_t of its launch (0 = launched).
extern "C" int ffn_act_fwd(const void* pre, void* y, long long n, uint32_t seed, uint32_t site,
                           uint32_t thr, float scale, int dtype, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  long long blocks = (((n + 3) >> 2) + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const dim3 grid(static_cast<unsigned>(blocks));
  switch (dtype) {
    case 0:
      ffn_act_fwd_kernel<float, false><<<grid, kThreads, 0, s>>>(
          static_cast<const float*>(pre), static_cast<float*>(y), n, seed, site, thr, scale);
      break;
    case 1:
      ffn_act_fwd_kernel<__nv_bfloat16, true><<<grid, kThreads, 0, s>>>(
          static_cast<const __nv_bfloat16*>(pre), static_cast<__nv_bfloat16*>(y), n, seed,
          site, thr, scale);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// `chunks` row chunks (the partials have `chunks` rows); cols must be a multiple of 4.
extern "C" int ffn_act_bwd(const void* g, const void* pre, void* dpre, void* dbias_part,
                           int rows, int cols, uint32_t seed, uint32_t site, uint32_t thr,
                           float scale, int chunks, int dtype, void* stream) {
  if (rows <= 0 || cols <= 0 || cols % 4 || chunks <= 0 || chunks > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((cols + kColsPerBlock - 1) / kColsPerBlock, chunks);
  float* dbp = static_cast<float*>(dbias_part);
  switch (dtype) {
    case 0:
      ffn_act_bwd_kernel<float, false><<<grid, kThreads, 0, s>>>(
          static_cast<const float*>(g), static_cast<const float*>(pre),
          static_cast<float*>(dpre), dbp, rows, cols, seed, site, thr, scale);
      break;
    case 1:
      ffn_act_bwd_kernel<__nv_bfloat16, true><<<grid, kThreads, 0, s>>>(
          static_cast<const __nv_bfloat16*>(g), static_cast<const __nv_bfloat16*>(pre),
          static_cast<__nv_bfloat16*>(dpre), dbp, rows, cols, seed, site, thr, scale);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

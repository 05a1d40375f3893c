// Dropout for NVIDIA Hopper (sm_90a): out = keep ? x * scale : 0, in the input dtype.
//
// Replaces the TPU kernel wav2vec_heart_sounds_tpu/ops/pallas/dropout.py::prng_dropout
// (K1): the forward and the backward are the same kernel on the same (seed, site), so the
// backward applies the identical mask to the cotangent with nothing stored. The mask is
// Philox4x32-10 over the flat element index (philox.cuh), not the TPU core PRNG, so it is
// bit-identical to the plain version in ops/kernels/dropout.py.
//
// What bounds it on this card: bytes. At the training shape ([96*199, 768] bf16, 29 MB
// each way) the kernel should take ~20 us at HBM speed; Philox (10 rounds of two 32-bit
// multiplies) costs ~3 integer ops per element after sharing one call among four
// elements, well under the memory time. One thread per group of four consecutive
// elements (one Philox call each), a grid-stride loop, no shared memory.
//
// Also exports philox_fill, which writes the raw bits of elements 0 .. n-1: chip_smoke.py
// holds philox.cuh to the plain version's bits with it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "gelu.cuh"
#include "philox.cuh"

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 8192;

template <typename T>
__global__ void __launch_bounds__(kThreads)
dropout_kernel(const T* __restrict__ x, T* __restrict__ out, long long n, uint32_t seed,
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
      if (i < n) {
        const float v = w2v::to_float(x[i]);
        w2v::store(out + i, bits[j] >= thr ? v * scale : 0.f);
      }
    }
  }
}

__global__ void philox_fill_kernel(uint32_t* __restrict__ out, long long n, uint32_t seed,
                                   uint32_t site) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * blockDim.x)
    out[i] = w2v::philox_bits(seed, site, static_cast<unsigned long long>(i));
}

long long blocks_for(long long work) {
  const long long b = (work + kThreads - 1) / kThreads;
  return b < 1 ? 1 : (b > kMaxBlocks ? kMaxBlocks : b);
}

}  // namespace

// C entry points, bound with ctypes. dtype: 0 = float32, 1 = bfloat16. Each returns the
// cudaError_t of its launch (0 = launched); the caller raises on anything else.
extern "C" int dropout_apply(const void* x, void* out, long long n, uint32_t seed,
                             uint32_t site, uint32_t thr, float scale, int dtype,
                             void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(blocks_for((n + 3) >> 2)));
  switch (dtype) {
    case 0:
      dropout_kernel<float><<<grid, kThreads, 0, s>>>(
          static_cast<const float*>(x), static_cast<float*>(out), n, seed, site, thr, scale);
      break;
    case 1:
      dropout_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
          static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(out), n, seed,
          site, thr, scale);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int philox_fill(void* out, long long n, uint32_t seed, uint32_t site,
                           void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  philox_fill_kernel<<<static_cast<unsigned>(blocks_for(n)), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(static_cast<uint32_t*>(out), n,
                                                            seed, site);
  return static_cast<int>(cudaGetLastError());
}

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
// What bounds it on this card: bytes. The forward reads pre and writes y (234.8 MB at
// [96*199, 3072] bf16, 0.070 ms at 3.35 TB/s), the backward reads g and pre and writes dpre
// (0.105 ms) plus its partial rows; the mask's integer work (a Philox call's ~51
// instructions over four elements, 0.011 ms at the integer rate) is well below that. The
// bf16 forward's main loop issues ~47 instructions an element (tanhf is a software routine),
// which at 4 warp-instructions a clock an SM is 0.083 ms: above the bytes, so the forward is
// held by its issue rate, not its traffic.
// The forward moves every byte in 16-byte accesses and spends as few instructions an element
// as it can: a persistent grid (the occupancy API's blocks an SM times the SMs,
// ffn_act_blocks), flat over the tensor; a thread takes runs of 16 bytes (8 bf16 or 4 f32:
// two or one Philox calls, philox_keep_aligned), one run in flight per trip with its
// load issued first (streaming loads and stores), one 64-bit index a run; the last n % 8
// (or 4) elements by block 0's first threads. The backward runs at 61% of its bytes by device
// time on the H100 and keeps its simple design: each thread takes four adjacent columns of a
// chunk of rows, so the bias partial sums stay in registers and need no atomics, and every
// run reproduces.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "gelu.cuh"
#include "philox.cuh"

namespace {

constexpr int kFwdThreads = 256;
constexpr int kBwdThreads = 128;
constexpr int kColsPerBlock = 4 * kBwdThreads;

// kTanh: the bfloat16 form, else the float32 rational erf.
template <bool kTanh>
__device__ __forceinline__ float act(float x) {
  return kTanh ? w2v::gelu_tanh(x) : w2v::gelu_erf(x);
}

template <bool kTanh>
__device__ __forceinline__ float act_grad(float x) {
  return kTanh ? w2v::gelu_tanh_grad(x) : w2v::gelu_erf_grad(x);
}

// The keep bits of the N-element run at row-major index `index` (a multiple of 4): one
// Philox call per four elements, none at rate 0.
template <int N>
__device__ __forceinline__ uint32_t keep_bits(uint32_t seed, uint32_t site,
                                              unsigned long long index, uint32_t thr) {
  return thr ? w2v::philox_keep_aligned<N>(seed, site, index, thr) : (1u << N) - 1u;
}

template <typename T, bool kTanh>
__global__ void __launch_bounds__(kFwdThreads)
ffn_act_fwd_kernel(const T* __restrict__ pre, T* __restrict__ y, long long n, uint32_t seed,
                   uint32_t site, uint32_t thr, float scale) {
  using V = w2v::Run16<T>;
  constexpr int N = V::N;
  const long long runs = n / N;
  const long long stride = static_cast<long long>(gridDim.x) * kFwdThreads;
  const uint4* src = reinterpret_cast<const uint4*>(pre);
  uint4* dst = reinterpret_cast<uint4*>(y);
  for (long long r = blockIdx.x * static_cast<long long>(kFwdThreads) + threadIdx.x; r < runs;
       r += stride) {
    float v[N];
    V::unpack(__ldcs(src + r), v);
    const uint32_t keep = keep_bits<N>(seed, site, static_cast<unsigned long long>(r) * N, thr);
#pragma unroll
    for (int j = 0; j < N; ++j) v[j] = (keep >> j & 1u) ? act<kTanh>(v[j]) * scale : 0.f;
    __stcs(dst + r, V::pack(v));
  }
  const long long i = runs * N + threadIdx.x;         // the tail: fewer than N elements
  if (blockIdx.x == 0 && i < n) {
    const uint32_t bits =
        thr ? w2v::philox_bits(seed, site, static_cast<unsigned long long>(i)) : 0u;
    w2v::store(y + i, bits >= thr ? act<kTanh>(w2v::to_float(pre[i])) * scale : 0.f);
  }
}

template <typename T, bool kTanh>
__global__ void __launch_bounds__(kBwdThreads)
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

template <class F>
void on_dtype(int dtype, F&& f) {
  if (dtype == 0) f(float{}, std::false_type{});
  if (dtype == 1) f(__nv_bfloat16{}, std::true_type{});
}

}  // namespace

// C entry points, bound with ctypes. dtype: 0 = float32 (rational-erf GELU), 1 = bfloat16
// (tanh GELU). Every tensor starts on 16 bytes. Each launch returns the cudaError_t of its
// launch (0 = launched).

// The forward's persistent grid for `sms` SMs over n elements (negative on error).
extern "C" int ffn_act_blocks(long long n, int sms, int dtype) {
  if (sms <= 0 || n <= 0) return -1;
  int per_sm = -1;
  on_dtype(dtype, [&](auto t, auto is_bf16) {
    using T = decltype(t);
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, ffn_act_fwd_kernel<T, decltype(is_bf16)::value>, kFwdThreads, 0))
      per_sm = -1;
  });
  if (per_sm <= 0) return -1;
  const long long runs = n / (dtype == 1 ? 8 : 4);
  const long long want = (runs + kFwdThreads - 1) / kFwdThreads;
  const long long blocks = static_cast<long long>(per_sm) * sms;
  return static_cast<int>(want < 1 ? 1 : want < blocks ? want : blocks);
}

// Elements a thread takes per trip of its main loop, for chip_smoke.py's count of the
// instructions an element: one 16-byte run (forward), or one row of four columns (backward).
extern "C" int ffn_act_trip_elements(int dtype, int backward) {
  return backward ? 4 : (dtype == 1 ? 8 : 4);
}

extern "C" int ffn_act_fwd(const void* pre, void* y, long long n, uint32_t seed, uint32_t site,
                           uint32_t thr, float scale, int blocks, int dtype, void* stream) {
  if (n <= 0 || blocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaErrorInvalidValue;
  on_dtype(dtype, [&](auto t, auto is_bf16) {
    using T = decltype(t);
    ffn_act_fwd_kernel<T, decltype(is_bf16)::value>
        <<<blocks, kFwdThreads, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const T*>(pre), static_cast<T*>(y), n, seed, site, thr, scale);
    err = cudaGetLastError();
  });
  return static_cast<int>(err);
}

// `chunks` row chunks (the partials have `chunks` rows); cols must be a multiple of 4.
extern "C" int ffn_act_bwd(const void* g, const void* pre, void* dpre, void* dbias_part,
                           int rows, int cols, uint32_t seed, uint32_t site, uint32_t thr,
                           float scale, int chunks, int dtype, void* stream) {
  if (rows <= 0 || cols <= 0 || cols % 4 || chunks <= 0 || chunks > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((cols + kColsPerBlock - 1) / kColsPerBlock, chunks);
  cudaError_t err = cudaErrorInvalidValue;
  on_dtype(dtype, [&](auto t, auto is_bf16) {
    using T = decltype(t);
    ffn_act_bwd_kernel<T, decltype(is_bf16)::value>
        <<<grid, kBwdThreads, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const T*>(g), static_cast<const T*>(pre), static_cast<T*>(dpre),
            static_cast<float*>(dbias_part), rows, cols, seed, site, thr, scale);
    err = cudaGetLastError();
  });
  return static_cast<int>(err);
}

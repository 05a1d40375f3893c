// Residual tail LayerNorm(x + dropout(h)) for NVIDIA Hopper (sm_90a): forward and backward.
//
// Replaces the TPU kernel wav2vec_heart_sounds_tpu/ops/pallas/resid.py::
// dropout_add_layernorm (K2), which ends both sublayers of every encoder layer. Contract
// (the plain version in ops/kernels/resid.py):
//   forward:  s = round_T(x + keep ? h * scale : 0)   (the sum rounded to the compute dtype)
//             out = (s - mean) * rsqrt(var + eps) * gamma + beta, float32 statistics over
//             the row (var = E[s^2] - E[s]^2, clamped at 0); writes out and s.
//   backward: from s and g: ds = rstd * (g*gamma - mean(g*gamma) - shat * mean(g*gamma*shat)),
//             dx = ds, dh = keep ? ds * scale : 0, and per-block partial sums over rows of
//             g * shat (dgamma) and g (dbeta), which the caller adds up. Partials, not
//             atomics, so every run and the comparison with the plain version reproduce.
// The mask is Philox4x32-10 over the row-major element index (philox.cuh), the same in
// both passes and in the plain version.
//
// What bounds it on this card: bytes (forward reads h, x and writes out, s; backward reads
// g, s and writes dh, dx: 4 x 29 MB per pass at [96*199, 768] bf16, ~35 us at HBM speed).
// One warp owns a row; each lane holds its groups of four columns (one Philox call per
// group) in registers, so a row is read once and reduced with warp shuffles. Rows up to
// 768 wide (wav2vec2-base's hidden size), a multiple of 128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "gelu.cuh"
#include "philox.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxGroups = 6;                   // groups of 4 columns per lane
constexpr int kMaxCols = kMaxGroups * 128;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ void group_bits(uint32_t (&bits)[4], uint32_t seed, uint32_t site,
                                           uint32_t thr, size_t index) {
  uint4 w = make_uint4(0u, 0u, 0u, 0u);
  if (thr) w = w2v::philox_group(seed, site, static_cast<unsigned long long>(index >> 2));
  bits[0] = w.x;
  bits[1] = w.y;
  bits[2] = w.z;
  bits[3] = w.w;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
resid_fwd_kernel(const T* __restrict__ h, const T* __restrict__ x,
                 const float* __restrict__ gamma, const float* __restrict__ beta,
                 T* __restrict__ out, T* __restrict__ s_out, int rows, int cols, float eps,
                 uint32_t seed, uint32_t site, uint32_t thr, float scale) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int groups = cols >> 7;
  for (int row = blockIdx.x * kWarps + warp; row < rows; row += gridDim.x * kWarps) {
    const size_t base = static_cast<size_t>(row) * cols;
    float sv[kMaxGroups][4];
    float sum = 0.f, sq = 0.f;
#pragma unroll
    for (int gi = 0; gi < kMaxGroups; ++gi) {
      if (gi >= groups) break;
      const int col = 4 * (lane + 32 * gi);
      uint32_t bits[4];
      group_bits(bits, seed, site, thr, base + col);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const size_t i = base + col + j;
        // __fmul_rn: never contracted into an FMA with the add, so s rounds as the plain
        // version's separate multiply and add do.
        const float hv = bits[j] >= thr ? __fmul_rn(w2v::to_float(h[i]), scale) : 0.f;
        const float s = w2v::round_to<T>(w2v::to_float(x[i]) + hv);
        w2v::store(s_out + i, s);
        sv[gi][j] = s;
        sum += s;
        sq += s * s;
      }
    }
    const float mean = warp_sum(sum) / cols;
    const float var = fmaxf(warp_sum(sq) / cols - mean * mean, 0.f);
    const float rstd = rsqrtf(var + eps);
#pragma unroll
    for (int gi = 0; gi < kMaxGroups; ++gi) {
      if (gi >= groups) break;
      const int col = 4 * (lane + 32 * gi);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        w2v::store(out + base + col + j,
                   (sv[gi][j] - mean) * rstd * gamma[col + j] + beta[col + j]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
resid_bwd_kernel(const T* __restrict__ g, const T* __restrict__ s,
                 const float* __restrict__ gamma, T* __restrict__ dh, T* __restrict__ dx,
                 float* __restrict__ dgamma_part, float* __restrict__ dbeta_part, int rows,
                 int cols, float eps, uint32_t seed, uint32_t site, uint32_t thr,
                 float scale) {
  __shared__ float red_g[kWarps][kMaxCols];
  __shared__ float red_gs[kWarps][kMaxCols];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int groups = cols >> 7;
  float acc_g[kMaxGroups][4], acc_gs[kMaxGroups][4];
#pragma unroll
  for (int gi = 0; gi < kMaxGroups; ++gi)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc_g[gi][j] = acc_gs[gi][j] = 0.f;

  for (int row = blockIdx.x * kWarps + warp; row < rows; row += gridDim.x * kWarps) {
    const size_t base = static_cast<size_t>(row) * cols;
    float gv[kMaxGroups][4], sh[kMaxGroups][4];
    float sum = 0.f, sq = 0.f;
#pragma unroll
    for (int gi = 0; gi < kMaxGroups; ++gi) {
      if (gi >= groups) break;
      const int col = 4 * (lane + 32 * gi);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float sf = w2v::to_float(s[base + col + j]);
        gv[gi][j] = w2v::to_float(g[base + col + j]);
        sh[gi][j] = sf;
        sum += sf;
        sq += sf * sf;
      }
    }
    const float mean = warp_sum(sum) / cols;
    const float var = fmaxf(warp_sum(sq) / cols - mean * mean, 0.f);
    const float rstd = rsqrtf(var + eps);
    float a = 0.f, b = 0.f;                     // sums of g*gamma and g*gamma*shat
#pragma unroll
    for (int gi = 0; gi < kMaxGroups; ++gi) {
      if (gi >= groups) break;
      const int col = 4 * (lane + 32 * gi);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float shat = (sh[gi][j] - mean) * rstd;
        const float gs = gv[gi][j] * gamma[col + j];
        sh[gi][j] = shat;
        a += gs;
        b += gs * shat;
        acc_g[gi][j] += gv[gi][j];
        acc_gs[gi][j] += gv[gi][j] * shat;
      }
    }
    const float mean_gs = warp_sum(a) / cols;
    const float mean_gss = warp_sum(b) / cols;
#pragma unroll
    for (int gi = 0; gi < kMaxGroups; ++gi) {
      if (gi >= groups) break;
      const int col = 4 * (lane + 32 * gi);
      uint32_t bits[4];
      group_bits(bits, seed, site, thr, base + col);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float gs = gv[gi][j] * gamma[col + j];
        const float ds = rstd * (gs - mean_gs - sh[gi][j] * mean_gss);
        w2v::store(dx + base + col + j, ds);
        w2v::store(dh + base + col + j, bits[j] >= thr ? ds * scale : 0.f);
      }
    }
  }

  // Per-block partials, summed over the warps in a fixed order.
#pragma unroll
  for (int gi = 0; gi < kMaxGroups; ++gi) {
    if (gi >= groups) break;
    const int col = 4 * (lane + 32 * gi);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      red_g[warp][col + j] = acc_g[gi][j];
      red_gs[warp][col + j] = acc_gs[gi][j];
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < cols; c += kThreads) {
    float pg = 0.f, pgs = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      pg += red_g[w][c];
      pgs += red_gs[w][c];
    }
    dbeta_part[static_cast<size_t>(blockIdx.x) * cols + c] = pg;
    dgamma_part[static_cast<size_t>(blockIdx.x) * cols + c] = pgs;
  }
}

bool bad_shape(int rows, int cols, int blocks) {
  return rows <= 0 || cols <= 0 || cols % 128 || cols > kMaxCols || blocks <= 0;
}

}  // namespace

// C entry points, bound with ctypes. dtype: 0 = float32, 1 = bfloat16; gamma, beta and the
// partials are float32. `blocks` is the grid (the partials have `blocks` rows). Each
// returns the cudaError_t of its launch (0 = launched).
extern "C" int resid_fwd(const void* h, const void* x, const void* gamma, const void* beta,
                         void* out, void* s, int rows, int cols, float eps, uint32_t seed,
                         uint32_t site, uint32_t thr, float scale, int blocks, int dtype,
                         void* stream) {
  if (bad_shape(rows, cols, blocks)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* ga = static_cast<const float*>(gamma);
  const float* be = static_cast<const float*>(beta);
  switch (dtype) {
    case 0:
      resid_fwd_kernel<float><<<blocks, kThreads, 0, st>>>(
          static_cast<const float*>(h), static_cast<const float*>(x), ga, be,
          static_cast<float*>(out), static_cast<float*>(s), rows, cols, eps, seed, site, thr,
          scale);
      break;
    case 1:
      resid_fwd_kernel<__nv_bfloat16><<<blocks, kThreads, 0, st>>>(
          static_cast<const __nv_bfloat16*>(h), static_cast<const __nv_bfloat16*>(x), ga, be,
          static_cast<__nv_bfloat16*>(out), static_cast<__nv_bfloat16*>(s), rows, cols, eps,
          seed, site, thr, scale);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int resid_bwd(const void* g, const void* s, const void* gamma, void* dh, void* dx,
                         void* dgamma_part, void* dbeta_part, int rows, int cols, float eps,
                         uint32_t seed, uint32_t site, uint32_t thr, float scale, int blocks,
                         int dtype, void* stream) {
  if (bad_shape(rows, cols, blocks)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* ga = static_cast<const float*>(gamma);
  float* dgp = static_cast<float*>(dgamma_part);
  float* dbp = static_cast<float*>(dbeta_part);
  switch (dtype) {
    case 0:
      resid_bwd_kernel<float><<<blocks, kThreads, 0, st>>>(
          static_cast<const float*>(g), static_cast<const float*>(s), ga,
          static_cast<float*>(dh), static_cast<float*>(dx), dgp, dbp, rows, cols, eps, seed,
          site, thr, scale);
      break;
    case 1:
      resid_bwd_kernel<__nv_bfloat16><<<blocks, kThreads, 0, st>>>(
          static_cast<const __nv_bfloat16*>(g), static_cast<const __nv_bfloat16*>(s), ga,
          static_cast<__nv_bfloat16*>(dh), static_cast<__nv_bfloat16*>(dx), dgp, dbp, rows,
          cols, eps, seed, site, thr, scale);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Device code of the residual tail LayerNorm(x + dropout(h)) (K2), shared by resid.cu and
// by the FFN sublayer ffn_mega.cu: its backward adds the column sums of dh (the
// output-dense bias gradient) to the same row pass, and its bfloat16 forward ends with the
// row LayerNorm alone (ln_rows_kernel).
//
// Contract (the plain version in ops/kernels/resid.py):
//   forward:  s = round_T(x + keep ? h * scale : 0)   (the sum rounded to the compute dtype)
//             out = (s - mean) * rsqrt(var + eps) * gamma + beta, float32 statistics over
//             the row (var = E[s^2] - E[s]^2, clamped at 0); writes out and s.
//   backward: from s and g: ds = rstd * (g*gamma - mean(g*gamma) - shat * mean(g*gamma*shat)),
//             dx = ds, dh = keep ? ds * scale : 0, and per-block partial sums over rows of
//             g * shat (dgamma), g (dbeta) and, with kDhSums, the rounded dh (the bias
//             gradient of the product that made h). Partials, not atomics, so every run
//             and the comparison with the plain version reproduce.
// One warp owns a row; each lane holds its groups of four columns (one Philox call per
// group) in registers, so a row is read once and reduced with warp shuffles. Rows up to
// 768 wide (wav2vec2-base's hidden size), a multiple of 128.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "gelu.cuh"
#include "philox.cuh"

namespace w2v {

constexpr int kResidWarps = 4;
constexpr int kResidThreads = kResidWarps * 32;
constexpr int kResidMaxGroups = 6;                   // groups of 4 columns per lane
constexpr int kResidMaxCols = kResidMaxGroups * 128;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void group_bits(uint32_t (&bits)[4], uint32_t seed, uint32_t site,
                                           uint32_t thr, size_t index) {
  uint4 w = make_uint4(0u, 0u, 0u, 0u);
  if (thr) w = philox_group(seed, site, static_cast<unsigned long long>(index >> 2));
  bits[0] = w.x;
  bits[1] = w.y;
  bits[2] = w.z;
  bits[3] = w.w;
}

inline bool resid_bad_shape(int rows, int cols, int blocks) {
  return rows <= 0 || cols <= 0 || cols % 128 || cols > kResidMaxCols || blocks <= 0;
}

template <typename T>
__global__ void __launch_bounds__(kResidThreads)
resid_fwd_kernel(const T* __restrict__ h, const T* __restrict__ x,
                 const float* __restrict__ gamma, const float* __restrict__ beta,
                 T* __restrict__ out, T* __restrict__ s_out, int rows, int cols, float eps,
                 uint32_t seed, uint32_t site, uint32_t thr, float scale) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int groups = cols >> 7;
  for (int row = blockIdx.x * kResidWarps + warp; row < rows;
       row += gridDim.x * kResidWarps) {
    const size_t base = static_cast<size_t>(row) * cols;
    float sv[kResidMaxGroups][4];
    float sum = 0.f, sq = 0.f;
#pragma unroll
    for (int gi = 0; gi < kResidMaxGroups; ++gi) {
      if (gi >= groups) break;
      const int col = 4 * (lane + 32 * gi);
      uint32_t bits[4];
      group_bits(bits, seed, site, thr, base + col);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const size_t i = base + col + j;
        // __fmul_rn: never contracted into an FMA with the add, so s rounds as the plain
        // version's separate multiply and add do.
        const float hv = bits[j] >= thr ? __fmul_rn(to_float(h[i]), scale) : 0.f;
        const float s = round_to<T>(to_float(x[i]) + hv);
        store(s_out + i, s);
        sv[gi][j] = s;
        sum += s;
        sq += s * s;
      }
    }
    const float mean = warp_sum(sum) / cols;
    const float var = fmaxf(warp_sum(sq) / cols - mean * mean, 0.f);
    const float rstd = rsqrtf(var + eps);
#pragma unroll
    for (int gi = 0; gi < kResidMaxGroups; ++gi) {
      if (gi >= groups) break;
      const int col = 4 * (lane + 32 * gi);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        store(out + base + col + j, (sv[gi][j] - mean) * rstd * gamma[col + j] + beta[col + j]);
    }
  }
}

// The row LayerNorm alone, out = (s - mean) * rsqrt(var + eps) * gamma + beta over bf16
// rows of s (the K4 forward's last pass, after its (B) epilogue formed s): the statistics of
// resid_fwd_kernel (float32, var = E[s^2] - E[s]^2 clamped at 0, warp sums in a fixed
// order). One warp a row; a lane reads runs of 8 columns (16 bytes) at 8 (lane + 32 i), so a
// row of up to 768 columns, a multiple of 256, is read once into registers.
constexpr int kLnMaxRuns = kResidMaxCols / 256;

__global__ void __launch_bounds__(kResidThreads)
ln_rows_kernel(const __nv_bfloat16* __restrict__ s, const float* __restrict__ gamma,
               const float* __restrict__ beta, __nv_bfloat16* __restrict__ out, int rows,
               int cols, float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int runs = cols >> 8;
  for (int row = blockIdx.x * kResidWarps + warp; row < rows;
       row += gridDim.x * kResidWarps) {
    const size_t base = static_cast<size_t>(row) * cols;
    float v[kLnMaxRuns][8];
    float sum = 0.f, sq = 0.f;
#pragma unroll
    for (int i = 0; i < kLnMaxRuns; ++i) {
      if (i >= runs) break;
      const uint4 raw = *reinterpret_cast<const uint4*>(s + base + 8 * (lane + 32 * i));
      const __nv_bfloat162* pair = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(pair[j]);
        v[i][2 * j] = f.x;
        v[i][2 * j + 1] = f.y;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        sum += v[i][j];
        sq += v[i][j] * v[i][j];
      }
    }
    const float mean = warp_sum(sum) / cols;
    const float var = fmaxf(warp_sum(sq) / cols - mean * mean, 0.f);
    const float rstd = rsqrtf(var + eps);
#pragma unroll
    for (int i = 0; i < kLnMaxRuns; ++i) {
      if (i >= runs) break;
      const int col = 8 * (lane + 32 * i);
      uint4 raw;
      __nv_bfloat162* pair = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        pair[j] = __floats2bfloat162_rn(
            (v[i][2 * j] - mean) * rstd * gamma[col + 2 * j] + beta[col + 2 * j],
            (v[i][2 * j + 1] - mean) * rstd * gamma[col + 2 * j + 1] + beta[col + 2 * j + 1]);
      *reinterpret_cast<uint4*>(out + base + col) = raw;
    }
  }
}

template <typename T, bool kDhSums>
__global__ void __launch_bounds__(kResidThreads)
resid_bwd_kernel(const T* __restrict__ g, const T* __restrict__ s,
                 const float* __restrict__ gamma, T* __restrict__ dh, T* __restrict__ dx,
                 float* __restrict__ dgamma_part, float* __restrict__ dbeta_part,
                 float* __restrict__ dh_part, int rows, int cols, float eps, uint32_t seed,
                 uint32_t site, uint32_t thr, float scale) {
  constexpr int kSumArrays = kDhSums ? 3 : 2;
  __shared__ float red[kSumArrays][kResidWarps][kResidMaxCols];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int groups = cols >> 7;
  float acc[kSumArrays][kResidMaxGroups][4];   // sums of g, g*shat (and rounded dh)
#pragma unroll
  for (int a = 0; a < kSumArrays; ++a)
#pragma unroll
    for (int gi = 0; gi < kResidMaxGroups; ++gi)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[a][gi][j] = 0.f;

  for (int row = blockIdx.x * kResidWarps + warp; row < rows;
       row += gridDim.x * kResidWarps) {
    const size_t base = static_cast<size_t>(row) * cols;
    float gv[kResidMaxGroups][4], sh[kResidMaxGroups][4];
    float sum = 0.f, sq = 0.f;
#pragma unroll
    for (int gi = 0; gi < kResidMaxGroups; ++gi) {
      if (gi >= groups) break;
      const int col = 4 * (lane + 32 * gi);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float sf = to_float(s[base + col + j]);
        gv[gi][j] = to_float(g[base + col + j]);
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
    for (int gi = 0; gi < kResidMaxGroups; ++gi) {
      if (gi >= groups) break;
      const int col = 4 * (lane + 32 * gi);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float shat = (sh[gi][j] - mean) * rstd;
        const float gs = gv[gi][j] * gamma[col + j];
        sh[gi][j] = shat;
        a += gs;
        b += gs * shat;
        acc[0][gi][j] += gv[gi][j];
        acc[1][gi][j] += gv[gi][j] * shat;
      }
    }
    const float mean_gs = warp_sum(a) / cols;
    const float mean_gss = warp_sum(b) / cols;
#pragma unroll
    for (int gi = 0; gi < kResidMaxGroups; ++gi) {
      if (gi >= groups) break;
      const int col = 4 * (lane + 32 * gi);
      uint32_t bits[4];
      group_bits(bits, seed, site, thr, base + col);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float gs = gv[gi][j] * gamma[col + j];
        const float ds = rstd * (gs - mean_gs - sh[gi][j] * mean_gss);
        const float dhv = bits[j] >= thr ? ds * scale : 0.f;
        store(dx + base + col + j, ds);
        store(dh + base + col + j, dhv);
        if (kDhSums) acc[kSumArrays - 1][gi][j] += round_to<T>(dhv);
      }
    }
  }

  // Per-block partials, summed over the warps in a fixed order.
#pragma unroll
  for (int gi = 0; gi < kResidMaxGroups; ++gi) {
    if (gi >= groups) break;
    const int col = 4 * (lane + 32 * gi);
#pragma unroll
    for (int a = 0; a < kSumArrays; ++a)
#pragma unroll
      for (int j = 0; j < 4; ++j) red[a][warp][col + j] = acc[a][gi][j];
  }
  __syncthreads();
  float* parts[3] = {dbeta_part, dgamma_part, dh_part};
  for (int c = threadIdx.x; c < cols; c += kResidThreads) {
#pragma unroll
    for (int a = 0; a < kSumArrays; ++a) {
      float p = 0.f;
#pragma unroll
      for (int w = 0; w < kResidWarps; ++w) p += red[a][w][c];
      parts[a][static_cast<size_t>(blockIdx.x) * cols + c] = p;
    }
  }
}

}  // namespace w2v

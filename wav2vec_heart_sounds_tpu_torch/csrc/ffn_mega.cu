// FFN sublayer LN(x + drop_h(W2 drop_a(gelu(W1 x + b1)) + b2)) for NVIDIA Hopper (sm_90a):
// forward and backward.
//
// Replaces the TPU kernel wav2vec_heart_sounds_tpu/ops/pallas/megakernel.py::ffn_block (K4):
// ffn_block_fwd (pallas_call :206) and _vjp_bwd (pallas_call :260), the JAX package's
// default training FFN. Contract (the plain version in ops/kernels/megakernel.py, which is
// the decomposed route's composition):
//   forward:  pre = round_T(x W1^T + b1); h = round_T(keep_a ? act(pre) * scale_a : 0);
//             y2 = round_T(h W2^T + b2); s = round_T(x + (keep_h ? y2 * scale_h : 0));
//             y = (s - mean) * rsqrt(var + eps) * gamma + beta, float32 statistics
//             (var = E[s^2] - E[s]^2). Writes y, s and pre (the backward's residuals).
//   backward: the LayerNorm backward gives ds, dhid = keep_h ? ds * scale_h : 0;
//             dh = round_T(dhid W2) (the product in the kernel, k = 768);
//             dpre = (keep_a ? dh * scale_a : 0) * act'(pre); h recomputed from pre;
//             float32 per-block partials of db1 (sum of dpre), db2 (sum of the rounded dhid),
//             dgamma and dbeta, no atomics. dx = dpre W1 + ds, dW1 = dpre^T x and
//             dW2 = dhid^T h stay matrix products outside, as the JAX package leaves them
//             to XLA.
// act is the tanh GELU in bfloat16 and the rational erf in float32 (gelu.cuh), as K5. The
// masks are Philox4x32-10 over the row-major element index (philox.cuh): keep_a at the
// activation site over [N, F], keep_h at the FFN-tail site over [N, D], bit for bit the
// masks of the decomposed route (K5 + K2).
//
// What bounds it on this card (N = 96*199 = 19104 rows, D = 768, F = 3072, bf16): the
// forward's two products are 2 * 2*N*D*F = 180 GFLOP, 182 us at 989 TFLOP/s, against 215 MB
// of compulsory traffic (65 us at 3.35 TB/s): operations. The backward's in-kernel part
// (one product, 90 GFLOP, 91 us; 474 MB, 142 us) is bound by bytes. On the TPU both weight
// matrices sit in VMEM and one program streams row blocks; here 9.4 MB of weights and a
// [rows, 3072] intermediate do not fit in 227 KB of shared memory, so the design holds the
// contract, not the form:
//   (A) ffn_up: a tiled GEMM over W1 (128x128 tiles, mma.sync m16n8k16 bf16 on the tensor
//       cores, ldmatrix from a 3-stage cp.async ring) whose epilogue adds b1, rounds and
//       stores pre, applies GELU and the act mask, and stores h;
//   (B) ffn_down_ln: a GEMM over W2 whose block owns 32 rows and all 768 columns, so the
//       bias, the hidden mask, +x, the rounding to s and the row LayerNorm run as its
//       epilogue from the accumulators (8 warps x 96 columns, row sums through shared
//       memory);
//   (C) the K2 backward row pass of resid.cuh, which also emits the db2 partials;
//   (D) ffn_dgrad: a GEMM of dhid W2 (B tile loaded transposed, ldmatrix.trans) whose
//       epilogue computes dpre, recomputes h from pre and the act mask (instead of keeping
//       the forward's h: 117 MB per layer less memory held), and emits the db1 partials.
// h round-trips device memory between (A) and (B), 235 MB the TPU kernel never moves. The
// float32 instantiation keeps the same tiling and computes the products with FMAs (not
// TF32), so float32 checks stay tight. wgmma and TMA are the later step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "gelu.cuh"
#include "mma_tile.cuh"
#include "philox.cuh"
#include "resid.cuh"

namespace {

constexpr int kThreads = w2v::kTileThreads;      // 8 warps
constexpr int kDownCols = 768;                  // (B) owns whole rows of wav2vec2-base
constexpr unsigned kFull = 0xffffffffu;

using w2v::cp_async_commit;
using w2v::cp_async_wait;
using w2v::load_tile;
using w2v::Tiling;
using w2v::warp_tile;

// Per dtype: bf16 on the tensor cores with a 3-stage ring; float32 FMAs, 2 stages, and a
// shallower k step for (B) so two stages of its 768-row W2 tile fit.
template <typename T> struct Cfg;
template <> struct Cfg<__nv_bfloat16> {
  using Up = Tiling<__nv_bfloat16, 128, 128, 32, 64, 32, false, 3>;
  using Down = Tiling<__nv_bfloat16, 32, kDownCols, 32, 32, 96, false, 3>;
  using Dgrad = Tiling<__nv_bfloat16, 128, 128, 32, 64, 32, true, 3>;
};
template <> struct Cfg<float> {
  using Up = Tiling<float, 128, 128, 32, 64, 32, false, 2>;
  using Down = Tiling<float, 32, kDownCols, 16, 32, 96, false, 2>;
  using Dgrad = Tiling<float, 128, 128, 32, 64, 32, true, 2>;
};

// acc = A[m0 : m0+BM, :K] * B(:K, n0 : n0+BN) through a STAGES-deep cp.async ring. Leaves
// shared memory free for the epilogue (all copies retired, block synchronised).
template <typename T, class G>
__device__ __forceinline__ void gemm(float (&acc)[G::MT][G::NT][4], T* smem,
                                     const T* __restrict__ A, int lda, int m0, int rows,
                                     const T* __restrict__ B, int ldb, int n0, int K) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm0 = (warp / G::WARPS_N) * G::WM, wn0 = (warp % G::WARPS_N) * G::WN;
#pragma unroll
  for (int i = 0; i < G::MT; ++i)
#pragma unroll
    for (int j = 0; j < G::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  const int KT = K / G::BK;
  auto load = [&](int stage, int kt) {
    T* As = smem + stage * G::STAGE;
    T* Bs = As + G::A_ELEMS;
    load_tile<T, G::BM, G::BK, G::SA>(As, A, lda, m0, rows, kt * G::BK);
    if (G::kBKN)
      load_tile<T, G::BK, G::BN, G::SB>(Bs, B, ldb, kt * G::BK, K, n0);
    else
      load_tile<T, G::BN, G::BK, G::SB>(Bs, B, ldb, n0, INT_MAX, kt * G::BK);
  };
#pragma unroll
  for (int s = 0; s < G::STAGES - 1; ++s) {
    if (s < KT) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<G::STAGES - 2>();
    __syncthreads();                         // tile kt landed; stage (kt-1) % STAGES is free
    const int next = kt + G::STAGES - 1;
    if (next < KT) load(next % G::STAGES, next);
    cp_async_commit();
    const T* As = smem + (kt % G::STAGES) * G::STAGE;
    warp_tile<G>(acc, As, As + G::A_ELEMS, wm0, wn0, lane);
  }
  cp_async_wait<0>();
  __syncthreads();
}

// The Philox words of elements idx and idx + 1 (idx even; both in one group of four).
__device__ __forceinline__ void pair_bits(uint32_t (&bits)[2], uint32_t seed, uint32_t site,
                                          uint32_t thr, size_t idx) {
  bits[0] = bits[1] = 0u;
  if (!thr) return;
  const uint4 w = w2v::philox_group(seed, site, static_cast<unsigned long long>(idx >> 2));
  bits[0] = (idx & 2) ? w.z : w.x;
  bits[1] = (idx & 2) ? w.w : w.y;
}

template <bool kTanh>
__device__ __forceinline__ float act(float x) {
  return kTanh ? w2v::gelu_tanh(x) : w2v::gelu_erf(x);
}

template <bool kTanh>
__device__ __forceinline__ float act_grad(float x) {
  return kTanh ? w2v::gelu_tanh_grad(x) : w2v::gelu_erf_grad(x);
}

// ---- (A) pre = x W1^T + b1 -> pre, h ------------------------------------------------------

template <typename T, bool kTanh>
__global__ void __launch_bounds__(kThreads, 2)
ffn_up_kernel(const T* __restrict__ x, const T* __restrict__ w1, const T* __restrict__ b1,
              T* __restrict__ pre, T* __restrict__ h, int rows, int d, int f, uint32_t seed,
              uint32_t site, uint32_t thr, float scale) {
  using G = typename Cfg<T>::Up;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  float acc[G::MT][G::NT][4];
  const int m0 = blockIdx.y * G::BM, n0 = blockIdx.x * G::BN;
  gemm<T, G>(acc, smem, x, d, m0, rows, w1, d, n0, d);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm0 = (warp / G::WARPS_N) * G::WM, wn0 = (warp % G::WARPS_N) * G::WN;
  const int g = lane >> 2, t2 = 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < G::MT; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wm0 + i * 16 + g + half * 8;
      if (row >= rows) continue;
#pragma unroll
      for (int j = 0; j < G::NT; ++j) {
        const int col = n0 + wn0 + j * 8 + t2;
        const size_t idx = static_cast<size_t>(row) * f + col;
        uint32_t bits[2];
        pair_bits(bits, seed, site, thr, idx);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = w2v::round_to<T>(acc[i][j][2 * half + e] + w2v::to_float(b1[col + e]));
          w2v::store(pre + idx + e, p);
          w2v::store(h + idx + e, bits[e] >= thr ? act<kTanh>(p) * scale : 0.f);
        }
      }
    }
}

// ---- (B) y2 = h W2^T + b2 -> s, y (row LayerNorm in the epilogue) ------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
ffn_down_ln_kernel(const T* __restrict__ h, const T* __restrict__ w2, const T* __restrict__ b2,
                   const T* __restrict__ x, const float* __restrict__ gamma,
                   const float* __restrict__ beta, T* __restrict__ y, T* __restrict__ s_out,
                   int rows, int f, uint32_t seed, uint32_t site, uint32_t thr, float scale,
                   float eps) {
  using G = typename Cfg<T>::Down;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int D = G::BN;
  T* smem = reinterpret_cast<T*>(smem_raw);
  float acc[G::MT][G::NT][4];
  const int m0 = blockIdx.x * G::BM;
  gemm<T, G>(acc, smem, h, f, m0, rows, w2, f, 0, f);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wn0 = warp * G::WN;                     // one warp row: WM = BM
  const int g = lane >> 2, t2 = 2 * (lane & 3);
  float rsum[G::MT][2], rsq[G::MT][2];
#pragma unroll
  for (int i = 0; i < G::MT; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + i * 16 + g + half * 8;
      const bool live = row < rows;
      float sum = 0.f, sq = 0.f;
#pragma unroll
      for (int j = 0; j < G::NT; ++j) {
        const int col = wn0 + j * 8 + t2;
        const size_t idx = static_cast<size_t>(live ? row : 0) * D + col;
        uint32_t bits[2];
        pair_bits(bits, seed, site, thr, idx);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float y2 = w2v::round_to<T>(acc[i][j][2 * half + e] + w2v::to_float(b2[col + e]));
          // __fmul_rn: not contracted with the add, as the plain multiply then add.
          const float hv = bits[e] >= thr ? __fmul_rn(y2, scale) : 0.f;
          const float sv = live ? w2v::round_to<T>(w2v::to_float(x[idx + e]) + hv) : 0.f;
          if (live) w2v::store(s_out + idx + e, sv);
          acc[i][j][2 * half + e] = sv;
          sum += sv;
          sq += sv * sv;
        }
      }
      sum += __shfl_xor_sync(kFull, sum, 1);
      sum += __shfl_xor_sync(kFull, sum, 2);
      sq += __shfl_xor_sync(kFull, sq, 1);
      sq += __shfl_xor_sync(kFull, sq, 2);
      rsum[i][half] = sum;
      rsq[i][half] = sq;
    }
  // Row sums across the 8 warps (each holds 96 of the 768 columns), in a fixed order.
  float* red = reinterpret_cast<float*>(smem_raw);   // [8 warps][BM rows][2]
  if ((lane & 3) == 0) {
#pragma unroll
    for (int i = 0; i < G::MT; ++i)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = i * 16 + g + half * 8;
        red[(warp * G::BM + r) * 2] = rsum[i][half];
        red[(warp * G::BM + r) * 2 + 1] = rsq[i][half];
      }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < G::MT; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = i * 16 + g + half * 8;
      const int row = m0 + r;
      float sum = 0.f, sq = 0.f;
#pragma unroll
      for (int w = 0; w < kThreads / 32; ++w) {
        sum += red[(w * G::BM + r) * 2];
        sq += red[(w * G::BM + r) * 2 + 1];
      }
      if (row >= rows) continue;
      const float mean = sum / D;
      const float var = fmaxf(sq / D - mean * mean, 0.f);
      const float rstd = rsqrtf(var + eps);
#pragma unroll
      for (int j = 0; j < G::NT; ++j) {
        const int col = wn0 + j * 8 + t2;
#pragma unroll
        for (int e = 0; e < 2; ++e)
          w2v::store(y + static_cast<size_t>(row) * D + col + e,
                     (acc[i][j][2 * half + e] - mean) * rstd * gamma[col + e] + beta[col + e]);
      }
    }
}

// ---- (D) dh = dhid W2 -> dpre, h, db1 partials --------------------------------------------

template <typename T, bool kTanh>
__global__ void __launch_bounds__(kThreads, 2)
ffn_dgrad_kernel(const T* __restrict__ dhid, const T* __restrict__ w2, const T* __restrict__ pre,
                 T* __restrict__ dpre, T* __restrict__ h, float* __restrict__ db1_part, int rows,
                 int d, int f, uint32_t seed, uint32_t site, uint32_t thr, float scale) {
  using G = typename Cfg<T>::Dgrad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  float acc[G::MT][G::NT][4];
  const int m0 = blockIdx.y * G::BM, n0 = blockIdx.x * G::BN;
  gemm<T, G>(acc, smem, dhid, d, m0, rows, w2, f, n0, d);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp / G::WARPS_N;
  const int wm0 = wm * G::WM, wn0 = (warp % G::WARPS_N) * G::WN;
  const int g = lane >> 2, t2 = 2 * (lane & 3);
  float colsum[G::NT][2];
#pragma unroll
  for (int j = 0; j < G::NT; ++j) colsum[j][0] = colsum[j][1] = 0.f;
#pragma unroll
  for (int i = 0; i < G::MT; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wm0 + i * 16 + g + half * 8;
      if (row >= rows) continue;
#pragma unroll
      for (int j = 0; j < G::NT; ++j) {
        const int col = n0 + wn0 + j * 8 + t2;
        const size_t idx = static_cast<size_t>(row) * f + col;
        uint32_t bits[2];
        pair_bits(bits, seed, site, thr, idx);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float dh = w2v::round_to<T>(acc[i][j][2 * half + e]);
          const float p = w2v::to_float(pre[idx + e]);
          const bool keep = bits[e] >= thr;
          const float dp = (keep ? dh * scale : 0.f) * act_grad<kTanh>(p);
          w2v::store(dpre + idx + e, dp);
          w2v::store(h + idx + e, keep ? act<kTanh>(p) * scale : 0.f);
          colsum[j][e] += dp;
        }
      }
    }
  // Column sums: over the 8 row groups of the warp, then over the warps of the column.
#pragma unroll
  for (int j = 0; j < G::NT; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float v = colsum[j][e];
      v += __shfl_xor_sync(kFull, v, 4);
      v += __shfl_xor_sync(kFull, v, 8);
      v += __shfl_xor_sync(kFull, v, 16);
      colsum[j][e] = v;
    }
  float* red = reinterpret_cast<float*>(smem_raw);   // [BM / WM][BN]
  if (g == 0) {
#pragma unroll
    for (int j = 0; j < G::NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) red[wm * G::BN + wn0 + j * 8 + t2 + e] = colsum[j][e];
  }
  __syncthreads();
  for (int c = threadIdx.x; c < G::BN; c += kThreads) {
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < G::BM / G::WM; ++w) v += red[w * G::BN + c];
    db1_part[static_cast<size_t>(blockIdx.y) * f + n0 + c] = v;
  }
}

template <typename K>
cudaError_t set_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename T>
int fwd(const T* x, const T* w1, const T* b1, const T* w2, const T* b2, const float* gamma,
        const float* beta, T* pre, T* h, T* s, T* y, int rows, int d, int f, uint32_t seed,
        uint32_t site_act, uint32_t site_hid, uint32_t thr_act, uint32_t thr_hid,
        float scale_act, float scale_hid, float eps, cudaStream_t st) {
  constexpr bool kTanh = sizeof(T) == 2;
  using Up = typename Cfg<T>::Up;
  using Down = typename Cfg<T>::Down;
  auto up = ffn_up_kernel<T, kTanh>;
  auto down = ffn_down_ln_kernel<T>;
  cudaError_t err = set_smem(up, Up::SMEM);
  if (err == cudaSuccess) err = set_smem(down, Down::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  up<<<dim3(f / Up::BN, (rows + Up::BM - 1) / Up::BM), kThreads, Up::SMEM, st>>>(
      x, w1, b1, pre, h, rows, d, f, seed, site_act, thr_act, scale_act);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  down<<<(rows + Down::BM - 1) / Down::BM, kThreads, Down::SMEM, st>>>(
      h, w2, b2, x, gamma, beta, y, s, rows, f, seed, site_hid, thr_hid, scale_hid, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int bwd(const T* g, const T* s, const T* pre, const T* w2, const float* gamma, T* ds, T* dhid,
        T* dpre, T* h, float* dgamma_part, float* dbeta_part, float* db2_part, float* db1_part,
        int rows, int d, int f, uint32_t seed, uint32_t site_act, uint32_t site_hid,
        uint32_t thr_act, uint32_t thr_hid, float scale_act, float scale_hid, float eps,
        int row_blocks, cudaStream_t st) {
  constexpr bool kTanh = sizeof(T) == 2;
  using Dg = typename Cfg<T>::Dgrad;
  auto dgrad = ffn_dgrad_kernel<T, kTanh>;
  cudaError_t err = set_smem(dgrad, Dg::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  w2v::resid_bwd_kernel<T, true><<<row_blocks, w2v::kResidThreads, 0, st>>>(
      g, s, gamma, dhid, ds, dgamma_part, dbeta_part, db2_part, rows, d, eps, seed, site_hid,
      thr_hid, scale_hid);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dgrad<<<dim3(f / Dg::BN, (rows + Dg::BM - 1) / Dg::BM), kThreads, Dg::SMEM, st>>>(
      dhid, w2, pre, dpre, h, db1_part, rows, d, f, seed, site_act, thr_act, scale_act);
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int rows, int d, int f) {
  return rows <= 0 || d != kDownCols || f <= 0 || f % 128;
}

}  // namespace

// C entry points, bound with ctypes. dtype: 0 = float32, 1 = bfloat16; x, the weights, the
// biases and every [rows, *] tensor are in it; gamma, beta and the partials are float32.
// d must be 768 and f a multiple of 128. Each returns the cudaError_t of its launches.

// Forward: (A) then (B). h is [rows, f] scratch between the two.
extern "C" int ffn_mega_fwd(const void* x, const void* w1, const void* b1, const void* w2,
                            const void* b2, const void* gamma, const void* beta, void* pre,
                            void* h, void* s, void* y, int rows, int d, int f, uint32_t seed,
                            uint32_t site_act, uint32_t site_hid, uint32_t thr_act,
                            uint32_t thr_hid, float scale_act, float scale_hid, float eps,
                            int dtype, void* stream) {
  if (bad_shape(rows, d, f)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* ga = static_cast<const float*>(gamma);
  const float* be = static_cast<const float*>(beta);
  switch (dtype) {
    case 0:
      return fwd<float>(static_cast<const float*>(x), static_cast<const float*>(w1),
                        static_cast<const float*>(b1), static_cast<const float*>(w2),
                        static_cast<const float*>(b2), ga, be, static_cast<float*>(pre),
                        static_cast<float*>(h), static_cast<float*>(s), static_cast<float*>(y),
                        rows, d, f, seed, site_act, site_hid, thr_act, thr_hid, scale_act,
                        scale_hid, eps, st);
    case 1:
      return fwd<__nv_bfloat16>(
          static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w1),
          static_cast<const __nv_bfloat16*>(b1), static_cast<const __nv_bfloat16*>(w2),
          static_cast<const __nv_bfloat16*>(b2), ga, be, static_cast<__nv_bfloat16*>(pre),
          static_cast<__nv_bfloat16*>(h), static_cast<__nv_bfloat16*>(s),
          static_cast<__nv_bfloat16*>(y), rows, d, f, seed, site_act, site_hid, thr_act,
          thr_hid, scale_act, scale_hid, eps, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Backward: (C) then (D). `row_blocks` is (C)'s grid: the dgamma, dbeta and db2 partials
// are [row_blocks, d]; the db1 partials are [ceil(rows / 128), f].
extern "C" int ffn_mega_bwd(const void* g, const void* s, const void* pre, const void* w2,
                            const void* gamma, void* ds, void* dhid, void* dpre, void* h,
                            void* dgamma_part, void* dbeta_part, void* db2_part,
                            void* db1_part, int rows, int d, int f, uint32_t seed,
                            uint32_t site_act, uint32_t site_hid, uint32_t thr_act,
                            uint32_t thr_hid, float scale_act, float scale_hid, float eps,
                            int row_blocks, int dtype, void* stream) {
  if (bad_shape(rows, d, f) || row_blocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* ga = static_cast<const float*>(gamma);
  float* dgp = static_cast<float*>(dgamma_part);
  float* dbp = static_cast<float*>(dbeta_part);
  float* d2p = static_cast<float*>(db2_part);
  float* d1p = static_cast<float*>(db1_part);
  switch (dtype) {
    case 0:
      return bwd<float>(static_cast<const float*>(g), static_cast<const float*>(s),
                        static_cast<const float*>(pre), static_cast<const float*>(w2), ga,
                        static_cast<float*>(ds), static_cast<float*>(dhid),
                        static_cast<float*>(dpre), static_cast<float*>(h), dgp, dbp, d2p, d1p,
                        rows, d, f, seed, site_act, site_hid, thr_act, thr_hid, scale_act,
                        scale_hid, eps, row_blocks, st);
    case 1:
      return bwd<__nv_bfloat16>(
          static_cast<const __nv_bfloat16*>(g), static_cast<const __nv_bfloat16*>(s),
          static_cast<const __nv_bfloat16*>(pre), static_cast<const __nv_bfloat16*>(w2), ga,
          static_cast<__nv_bfloat16*>(ds), static_cast<__nv_bfloat16*>(dhid),
          static_cast<__nv_bfloat16*>(dpre), static_cast<__nv_bfloat16*>(h), dgp, dbp, d2p,
          d1p, rows, d, f, seed, site_act, site_hid, thr_act, thr_hid, scale_act, scale_hid,
          eps, row_blocks, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

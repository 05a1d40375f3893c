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
//             dh = round_T(dhid W2) (the product in the kernel, k = D);
//             dpre = (keep_a ? dh * scale_a : 0) * act'(pre); h recomputed from pre;
//             float32 per-block partials of db1 (sum of dpre), db2 (sum of the rounded dhid),
//             dgamma and dbeta, no atomics. dx = dpre W1 + ds, dW1 = dpre^T x and
//             dW2 = dhid^T h stay matrix products outside, as the JAX package leaves them
//             to XLA.
// act is the tanh GELU in bfloat16 and the rational erf in float32 (gelu.cuh), as K5. The
// masks are Philox4x32-10 over the row-major element index (philox.cuh): keep_a at the
// activation site over [N, F], keep_h at the FFN-tail site over [N, D], bit for bit the
// masks of the decomposed route (K5 + K2).
// Widths: the hidden size D and the FFN width F are any multiples of 8 (16-byte rows), D at
// most 1024 or 1280 (K2's rows): wav2vec2-base's 768 / 3072, wav2vec2-large's 1024 / 4096,
// XLS-R 1B's 1280 / 5120, the test config's 32 / 64. The tiles' last columns and k steps past
// D or F read zeros and store nothing.
//
// Pre-norm form (ffn_prenorm_fwd / ffn_prenorm_bwd; the stable-layer-norm encoder's FFN with
// the next LayerNorm fused): the FFN reads x (the normalised stream) and adds its output to
// a separate residual r, s = round_T(r + (keep_h ? y2 * scale_h : 0)) is the new stream and y
// = LN(s) the next sublayer's input; the backward takes gs, the stream's own gradient, adds
// it to the LayerNorm's ds (resid.cuh's kStream), and dr = ds, dx = dpre W1 outside.
//
// What bounds it on this card (N = 96*199 = 19104 rows, D = 768, F = 3072, bf16): the
// forward's two products are 2 * 2*N*D*F = 180 GFLOP, 182 us at 989 TFLOP/s, against 215 MB
// of compulsory traffic (65 us at 3.35 TB/s): operations. The backward's in-kernel part
// (one product, 90 GFLOP, 91 us; 474 MB, 142 us) is bound by bytes. On the TPU both weight
// matrices sit in VMEM and one program streams row blocks; here 9.4 MB of weights and a
// [rows, 3072] intermediate do not fit in 227 KB of shared memory, so the design holds the
// contract, not the form. The bfloat16 bodies are Hopper GEMMs (wgmma_tile.cuh): TMA loads
// with the 128-byte swizzle into a 4-slot mbarrier ring fed by one producer warp, and two
// consumer groups of two warpgroups on wgmma m64n128k16 that take turns on 128 x 128 tiles,
// one block an SM walking over the tiles, so one group's epilogue (8 warps) overlaps the
// other's products. Each epilogue stages its tile through the group's shared tile, so
// a thread owns runs of 8 consecutive columns: 16-byte loads and stores, and the mask at one
// Philox call per four elements (philox_keep_run):
//   (A) ffn_up: x W1^T; pre = round(acc + b1), h = keep_a ? gelu(pre) * scale_a : 0;
//   (B) ffn_down: h W2^T; y2 = round(acc + b2), s = round(x + (keep_h ? y2 * scale_h : 0));
//   (L) the row LayerNorm of s into y (resid.cuh's ln_rows_kernel, 16-byte rows);
//   (C) the K2 backward row pass of resid.cuh, which also emits the db2 partials;
//   (D) ffn_dgrad: dhid W2 with W2 read N-major (wgmma's transpose-B); dh = round(acc),
//       dpre, h recomputed from pre and the act mask (instead of keeping the forward's h:
//       117 MB per layer less memory held), and the db1 partials of its 128 rows.
// h round-trips device memory between (A) and (B), 235 MB (~70 us) the TPU kernel never
// moves: a fused block would hold a 64 x 768 float32 accumulator and reread both weights
// from L2 once per 64 rows (~2.8 GB), which costs more than the round trip saves. The
// float32 bodies keep the mma_tile.cuh tiling and compute the products with FMAs (wgmma on
// float32 is TF32), so float32 checks stay tight; there too (B) writes s and (L) follows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "gelu.cuh"
#include "mma_tile.cuh"
#include "philox.cuh"
#include "resid.cuh"
#include "wgmma_tile.cuh"

namespace {

constexpr int kThreads = w2v::kTileThreads;      // 8 warps (the float32 bodies)
constexpr unsigned kFull = 0xffffffffu;

using w2v::cp_async_commit;
using w2v::cp_async_wait;
using w2v::load_tile;
using w2v::Tiling;
using w2v::warp_tile;

// ---- float32 bodies: FMAs in the mma_tile.cuh layout ---------------------------------------
//
// (A), (B) and (D) as 128 x 128 tiles, 2 stages; the row LayerNorm of s is its own pass (L).
template <typename T> struct Cfg;
template <> struct Cfg<float> {
  using Up = Tiling<float, 128, 128, 32, 64, 32, false, 2>;   // (A) and (B): B K-major
  using Dgrad = Tiling<float, 128, 128, 32, 64, 32, true, 2>;
};

// acc = A[m0 : m0+BM, :K] * B(:K, n0 : n0+BN) through a STAGES-deep cp.async ring, B's
// columns bounded by N (rows past `rows`, columns past N and k past K read zeros). Leaves
// shared memory free for the epilogue (all copies retired, block synchronised).
template <typename T, class G>
__device__ __forceinline__ void gemm(float (&acc)[G::MT][G::NT][4], T* smem,
                                     const T* __restrict__ A, int lda, int m0, int rows,
                                     const T* __restrict__ B, int ldb, int n0, int N, int K) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm0 = (warp / G::WARPS_N) * G::WM, wn0 = (warp % G::WARPS_N) * G::WN;
#pragma unroll
  for (int i = 0; i < G::MT; ++i)
#pragma unroll
    for (int j = 0; j < G::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  const int KT = (K + G::BK - 1) / G::BK;
  auto load = [&](int stage, int kt) {
    T* As = smem + stage * G::STAGE;
    T* Bs = As + G::A_ELEMS;
    load_tile<T, G::BM, G::BK, G::SA>(As, A, lda, m0, rows, kt * G::BK, K);
    if (G::kBKN)
      load_tile<T, G::BK, G::BN, G::SB>(Bs, B, ldb, kt * G::BK, K, n0, N);
    else
      load_tile<T, G::BN, G::BK, G::SB>(Bs, B, ldb, n0, N, kt * G::BK, K);
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
  gemm<T, G>(acc, smem, x, d, m0, rows, w1, d, n0, f, d);

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
        if (col >= f) continue;                   // the last tile's columns past F
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

// ---- (B) y2 = h W2^T + b2 -> s --------------------------------------------------------------
// (the row LayerNorm follows as its own pass, ln_rows_kernel)

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
ffn_down_kernel(const T* __restrict__ h, const T* __restrict__ w2, const T* __restrict__ b2,
                const T* __restrict__ x, T* __restrict__ s_out, int rows, int d, int f,
                uint32_t seed, uint32_t site, uint32_t thr, float scale) {
  using G = typename Cfg<T>::Up;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  float acc[G::MT][G::NT][4];
  const int m0 = blockIdx.y * G::BM, n0 = blockIdx.x * G::BN;
  gemm<T, G>(acc, smem, h, f, m0, rows, w2, f, n0, d, f);

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
        if (col >= d) continue;                   // the last tile's columns past D
        const size_t idx = static_cast<size_t>(row) * d + col;
        uint32_t bits[2];
        pair_bits(bits, seed, site, thr, idx);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float y2 = w2v::round_to<T>(acc[i][j][2 * half + e] + w2v::to_float(b2[col + e]));
          // __fmul_rn: not contracted with the add, as the plain multiply then add.
          const float hv = bits[e] >= thr ? __fmul_rn(y2, scale) : 0.f;
          w2v::store(s_out + idx + e, w2v::round_to<T>(w2v::to_float(x[idx + e]) + hv));
        }
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
  gemm<T, G>(acc, smem, dhid, d, m0, rows, w2, f, n0, f, d);

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
        if (col >= f) continue;                   // the last tile's columns past F
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
  for (int c = threadIdx.x; c < G::BN && n0 + c < f; c += kThreads) {
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < G::BM / G::WM; ++w) v += red[w * G::BN + c];
    db1_part[static_cast<size_t>(blockIdx.y) * f + n0 + c] = v;
  }
}

// ---- bfloat16 bodies: wgmma fed by TMA (wgmma_tile.cuh) ------------------------------------

using bf16 = __nv_bfloat16;
// (A) x [N, 768] . W1 [F, 768] and (B) h [N, F] . W2 [768, F] read B K-major; (D)
// dhid [N, 768] . W2 reads W2 as [K=768, N=F], N-major.
using KMajor = w2v::WgmmaTiling<false>;
using NMajor = w2v::WgmmaTiling<true>;
using Acc = float[w2v::kGemmAcc];
constexpr int kLd = w2v::kStageLd;
// The hidden size the bfloat16 bodies are also built for as a compile-time constant
// (wav2vec2-base's), so that their tile and index arithmetic folds; kD = 0 reads it from d.
constexpr int kBaseHidden = 768;
constexpr int kWideHidden = 1280;      // XLS-R 1B's, a compile-time instance of its own

// Eight consecutive bf16 travel as one 16-byte word; pair i is its 32-bit word i.
__device__ __forceinline__ float2 pair_of(const uint4& v, int i) {
  return __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(&v)[i]);
}

__device__ __forceinline__ uint32_t pack_pair(float a, float b) {
  const __nv_bfloat162 t = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&t);
}

// The calling warpgroup's sums (+ bias, read below column `cols`) rounded to bf16 into its
// group's staging tile [128][kLd].
__device__ __forceinline__ void stage_acc(bf16* tile, const Acc& acc,
                                          const bf16* __restrict__ bias, int n0, int cols) {
  const int lane = threadIdx.x & 31;
  const int r = (w2v::group_thread() / 128) * 64 + ((threadIdx.x / 32) & 3) * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < w2v::kGemmBN / 8; ++j) {
    const int c = 8 * j + 2 * (lane & 3);
    float2 b = make_float2(0.f, 0.f);
    if (bias != nullptr && n0 + c < cols)
      b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bias + n0 + c));
    *reinterpret_cast<__nv_bfloat162*>(tile + r * kLd + c) =
        __floats2bfloat162_rn(acc[4 * j] + b.x, acc[4 * j + 1] + b.y);
    *reinterpret_cast<__nv_bfloat162*>(tile + (r + 8) * kLd + c) =
        __floats2bfloat162_rn(acc[4 * j + 2] + b.x, acc[4 * j + 3] + b.y);
  }
}

// The keep bits of the run's 8 elements idx .. idx + 7 (bit i for idx + i); rate 0 keeps all.
__device__ __forceinline__ uint32_t keep8(uint32_t seed, uint32_t site, size_t idx,
                                          uint32_t thr) {
  return thr ? w2v::philox_keep_run<8>(seed, site, idx, thr) : 0xffu;
}

// One 16-byte word of a [rows, ld] bf16 matrix at the thread's run j of tile (m0, n0), or
// zeros past the rows: loaded one run ahead, so its latency hides behind a run's arithmetic.
// A group thread takes kGemmRuns runs of its staged tile, one column run over 8 rows; the
// caller keeps its column below ld.
__device__ __forceinline__ uint4 run_word(const bf16* __restrict__ src, int ld, int m0, int n0,
                                          int rows, int j) {
  const int row = m0 + w2v::run_row(j);
  return row < rows ? *reinterpret_cast<const uint4*>(src + static_cast<size_t>(row) * ld + n0 +
                                                      w2v::run_col())
                    : make_uint4(0u, 0u, 0u, 0u);
}

// (A) pre = x W1^T + b1 -> pre, h = keep_a ? gelu(pre) * scale_a : 0
template <int kD>
__global__ void __launch_bounds__(w2v::kGemmThreads, 1)
ffn_up_wgmma_kernel(const __grid_constant__ CUtensorMap mx, const __grid_constant__ CUtensorMap mw1,
                    const bf16* __restrict__ b1, bf16* __restrict__ pre, bf16* __restrict__ h,
                    int rows, int d_arg, int f, uint32_t seed, uint32_t site, uint32_t thr,
                    float scale) {
  const int d = kD ? kD : d_arg;
  extern __shared__ unsigned char smem_raw[];
  const w2v::GemmSmem<KMajor> sm(smem_raw);
  w2v::gemm_tiles(sm, &mx, &mw1, rows, f, d, [&](const Acc& acc, int g, int m0, int n0, int) {
    bf16* tile = sm.staging(g);
    w2v::group_sync(g);                         // the group's previous runs are read
    stage_acc(tile, acc, b1, n0, f);
    w2v::group_sync(g);
    const int c = w2v::run_col();
    if (n0 + c >= f) return;                    // no runs past F
#pragma unroll 1
    for (int j = 0; j < w2v::kGemmRuns; ++j) {
      const int r = w2v::run_row(j), row = m0 + r;
      if (row >= rows) break;
      const size_t idx = static_cast<size_t>(row) * f + n0 + c;
      const uint4 v = *reinterpret_cast<const uint4*>(tile + r * kLd + c);
      const uint32_t keep = keep8(seed, site, idx, thr);
      uint32_t out[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 p = pair_of(v, i);
        out[i] = pack_pair((keep >> (2 * i)) & 1 ? act<true>(p.x) * scale : 0.f,
                           (keep >> (2 * i + 1)) & 1 ? act<true>(p.y) * scale : 0.f);
      }
      *reinterpret_cast<uint4*>(pre + idx) = v;
      *reinterpret_cast<uint4*>(h + idx) = make_uint4(out[0], out[1], out[2], out[3]);
    }
  });
}

// (B) y2 = h W2^T + b2 -> s = round(x + (keep_h ? y2 * scale_h : 0)); the row LayerNorm
// follows as its own pass.
template <int kD>
__global__ void __launch_bounds__(w2v::kGemmThreads, 1)
ffn_down_wgmma_kernel(const __grid_constant__ CUtensorMap mh,
                      const __grid_constant__ CUtensorMap mw2, const bf16* __restrict__ b2,
                      const bf16* __restrict__ x, bf16* __restrict__ s, int rows, int d_arg,
                      int f, uint32_t seed, uint32_t site, uint32_t thr, float scale) {
  const int d = kD ? kD : d_arg;
  extern __shared__ unsigned char smem_raw[];
  const w2v::GemmSmem<KMajor> sm(smem_raw);
  w2v::gemm_tiles(sm, &mh, &mw2, rows, d, f, [&](const Acc& acc, int g, int m0, int n0, int) {
    bf16* tile = sm.staging(g);
    w2v::group_sync(g);
    stage_acc(tile, acc, b2, n0, d);
    const int c = w2v::run_col();
    const bool live = n0 + c < d;               // no runs past D
    uint4 next = live ? run_word(x, d, m0, n0, rows, 0) : make_uint4(0u, 0u, 0u, 0u);
    w2v::group_sync(g);
    if (!live) return;
#pragma unroll 1
    for (int j = 0; j < w2v::kGemmRuns; ++j) {
      const uint4 xv = next;
      if (j + 1 < w2v::kGemmRuns) next = run_word(x, d, m0, n0, rows, j + 1);
      const int r = w2v::run_row(j), row = m0 + r;
      if (row >= rows) break;
      const size_t idx = static_cast<size_t>(row) * d + n0 + c;
      const uint4 y2 = *reinterpret_cast<const uint4*>(tile + r * kLd + c);
      const uint32_t keep = keep8(seed, site, idx, thr);
      uint32_t out[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 yv = pair_of(y2, i), xf = pair_of(xv, i);
        // __fmul_rn: not contracted with the add, as the plain multiply then add.
        const float h0 = (keep >> (2 * i)) & 1 ? __fmul_rn(yv.x, scale) : 0.f;
        const float h1 = (keep >> (2 * i + 1)) & 1 ? __fmul_rn(yv.y, scale) : 0.f;
        out[i] = pack_pair(xf.x + h0, xf.y + h1);
      }
      *reinterpret_cast<uint4*>(s + idx) = make_uint4(out[0], out[1], out[2], out[3]);
    }
  });
}

// (D) dh = round(dhid W2) -> dpre = (keep_a ? dh * scale_a : 0) * gelu'(pre), h recomputed,
// and the tile's float32 column sums of dpre (the db1 partial of its row tile), summed in a
// fixed order: each thread's 8 rows, then the group's 16 row groups through its scratch.
template <int kD>
__global__ void __launch_bounds__(w2v::kGemmThreads, 1)
ffn_dgrad_wgmma_kernel(const __grid_constant__ CUtensorMap mdhid,
                       const __grid_constant__ CUtensorMap mw2, const bf16* __restrict__ pre,
                       bf16* __restrict__ dpre, bf16* __restrict__ h,
                       float* __restrict__ db1_part, int rows, int d_arg, int f, uint32_t seed,
                       uint32_t site, uint32_t thr, float scale) {
  const int d = kD ? kD : d_arg;
  extern __shared__ unsigned char smem_raw[];
  const w2v::GemmSmem<NMajor> sm(smem_raw);
  w2v::gemm_tiles(sm, &mdhid, &mw2, rows, f, d, [&](const Acc& acc, int g, int m0, int n0,
                                                    int row_tile) {
    bf16* tile = sm.staging(g);
    w2v::group_sync(g);
    stage_acc(tile, acc, nullptr, n0, f);
    const int c = w2v::run_col();
    const bool live = n0 + c < f;               // no runs past F
    uint4 next = live ? run_word(pre, f, m0, n0, rows, 0) : make_uint4(0u, 0u, 0u, 0u);
    w2v::group_sync(g);
    float colsum[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) colsum[e] = 0.f;
    if (live) {
#pragma unroll 1
      for (int j = 0; j < w2v::kGemmRuns; ++j) {
        const uint4 pv = next;
        if (j + 1 < w2v::kGemmRuns) next = run_word(pre, f, m0, n0, rows, j + 1);
        const int r = w2v::run_row(j), row = m0 + r;
        if (row >= rows) break;
        const size_t idx = static_cast<size_t>(row) * f + n0 + c;
        const uint4 dh = *reinterpret_cast<const uint4*>(tile + r * kLd + c);
        const uint32_t keep = keep8(seed, site, idx, thr);
        uint32_t dp_out[4], h_out[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 dv = pair_of(dh, i), p = pair_of(pv, i);
          const bool k0 = (keep >> (2 * i)) & 1, k1 = (keep >> (2 * i + 1)) & 1;
          const float d0 = (k0 ? dv.x * scale : 0.f) * act_grad<true>(p.x);
          const float d1 = (k1 ? dv.y * scale : 0.f) * act_grad<true>(p.y);
          colsum[2 * i] += d0;
          colsum[2 * i + 1] += d1;
          dp_out[i] = pack_pair(d0, d1);
          h_out[i] = pack_pair(k0 ? act<true>(p.x) * scale : 0.f,
                               k1 ? act<true>(p.y) * scale : 0.f);
        }
        *reinterpret_cast<uint4*>(dpre + idx) =
            make_uint4(dp_out[0], dp_out[1], dp_out[2], dp_out[3]);
        *reinterpret_cast<uint4*>(h + idx) = make_uint4(h_out[0], h_out[1], h_out[2], h_out[3]);
      }
    }
    float* red = sm.scratch(g);                  // [16 row groups][128 columns]
    const int gt = w2v::group_thread();
#pragma unroll
    for (int e = 0; e < 8; ++e) red[(gt / 16) * w2v::kGemmBN + c + e] = colsum[e];
    w2v::group_sync(g);
    if (gt < w2v::kGemmBN && n0 + gt < f) {
      float v = 0.f;
#pragma unroll
      for (int q = 0; q < w2v::kGemmGroup / 16; ++q) v += red[q * w2v::kGemmBN + gt];
      db1_part[static_cast<size_t>(row_tile) * f + n0 + gt] = v;
    }
  });
}

template <typename K>
cudaError_t set_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// (L): the row LayerNorm of s into y.
template <typename T>
int ln_rows(const T* s, const float* gamma, const float* beta, T* y, int rows, int d, float eps,
            cudaStream_t st) {
  const int blocks = (rows + w2v::kLnWarps - 1) / w2v::kLnWarps;
  auto kernel = w2v::ln_rows_for<T>(d);
  kernel<<<blocks < 65535 ? blocks : 65535, w2v::kLnThreads, 0, st>>>(s, gamma, beta, y, rows,
                                                                      d, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int fwd(const T* x, const T* res, const T* w1, const T* b1, const T* w2, const T* b2,
        const float* gamma, const float* beta, T* pre, T* h, T* s, T* y, int rows, int d, int f,
        uint32_t seed,
        uint32_t site_act, uint32_t site_hid, uint32_t thr_act, uint32_t thr_hid,
        float scale_act, float scale_hid, float eps, cudaStream_t st) {
  constexpr bool kTanh = sizeof(T) == 2;
  using Up = typename Cfg<T>::Up;
  auto up = ffn_up_kernel<T, kTanh>;
  cudaError_t err = set_smem(up, Up::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int row_tiles = (rows + Up::BM - 1) / Up::BM;
  up<<<dim3((f + Up::BN - 1) / Up::BN, row_tiles), kThreads, Up::SMEM, st>>>(
      x, w1, b1, pre, h, rows, d, f, seed, site_act, thr_act, scale_act);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  auto down = ffn_down_kernel<T>;
  err = set_smem(down, Up::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  down<<<dim3((d + Up::BN - 1) / Up::BN, row_tiles), kThreads, Up::SMEM, st>>>(
      h, w2, b2, res, s, rows, d, f, seed, site_hid, thr_hid, scale_hid);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return ln_rows(s, gamma, beta, y, rows, d, eps, st);
}

// (C)'s launch: the K2 backward row pass with the db2 sums, its pre-norm form when gs is set.
template <typename T>
cudaError_t row_pass(const T* g, const T* gs, const T* s, const float* gamma, T* dhid, T* ds,
                     float* dgamma_part, float* dbeta_part, float* db2_part, int rows, int d,
                     float eps, uint32_t seed, uint32_t site, uint32_t thr, float scale,
                     int row_blocks, cudaStream_t st) {
  if (gs != nullptr)
    return w2v::ResidBwd<T, true, true>::launch(d, row_blocks, st, g, s, gamma, dhid, ds,
                                                dgamma_part, dbeta_part, db2_part, rows, d, eps,
                                                seed, site, thr, scale, gs);
  return w2v::ResidBwd<T, true>::launch(d, row_blocks, st, g, s, gamma, dhid, ds, dgamma_part,
                                        dbeta_part, db2_part, rows, d, eps, seed, site, thr,
                                        scale, gs);
}

template <typename T>
int bwd(const T* g, const T* gs, const T* s, const T* pre, const T* w2, const float* gamma,
        T* ds, T* dhid, T* dpre, T* h, float* dgamma_part, float* dbeta_part, float* db2_part,
        float* db1_part,
        int rows, int d, int f, uint32_t seed, uint32_t site_act, uint32_t site_hid,
        uint32_t thr_act, uint32_t thr_hid, float scale_act, float scale_hid, float eps,
        int row_blocks, cudaStream_t st) {
  constexpr bool kTanh = sizeof(T) == 2;
  using Dg = typename Cfg<T>::Dgrad;
  auto dgrad = ffn_dgrad_kernel<T, kTanh>;
  cudaError_t err = set_smem(dgrad, Dg::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = row_pass(g, gs, s, gamma, dhid, ds, dgamma_part, dbeta_part, db2_part, rows, d, eps,
                 seed, site_hid, thr_hid, scale_hid, row_blocks, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  dgrad<<<dim3((f + Dg::BN - 1) / Dg::BN, (rows + Dg::BM - 1) / Dg::BM), kThreads, Dg::SMEM, st>>>(
      dhid, w2, pre, dpre, h, db1_part, rows, d, f, seed, site_act, thr_act, scale_act);
  return static_cast<int>(cudaGetLastError());
}

int fwd_bf16(const bf16* x, const bf16* res, const bf16* w1, const bf16* b1, const bf16* w2,
             const bf16* b2, const float* gamma, const float* beta, bf16* pre, bf16* h, bf16* s,
             bf16* y,
             int rows, int d, int f, uint32_t seed, uint32_t site_act, uint32_t site_hid,
             uint32_t thr_act, uint32_t thr_hid, float scale_act, float scale_hid, float eps,
             cudaStream_t st) {
  CUtensorMap mx, mw1, mh, mw2;
  if (!w2v::tensor_map(&mx, x, rows, d, w2v::kGemmBM) ||
      !w2v::tensor_map(&mw1, w1, f, d, w2v::kGemmBN) ||
      !w2v::tensor_map(&mh, h, rows, f, w2v::kGemmBM) ||
      !w2v::tensor_map(&mw2, w2, d, f, w2v::kGemmBN))
    return static_cast<int>(cudaErrorInvalidValue);
  auto up = d == kBaseHidden   ? ffn_up_wgmma_kernel<kBaseHidden>
            : d == kWideHidden ? ffn_up_wgmma_kernel<kWideHidden>
                               : ffn_up_wgmma_kernel<0>;
  auto down = d == kBaseHidden   ? ffn_down_wgmma_kernel<kBaseHidden>
              : d == kWideHidden ? ffn_down_wgmma_kernel<kWideHidden>
                                 : ffn_down_wgmma_kernel<0>;
  cudaError_t err = set_smem(up, KMajor::SMEM);
  if (err == cudaSuccess) err = set_smem(down, KMajor::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  up<<<w2v::gemm_grid(rows, f), w2v::kGemmThreads, KMajor::SMEM, st>>>(
      mx, mw1, b1, pre, h, rows, d, f, seed, site_act, thr_act, scale_act);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  down<<<w2v::gemm_grid(rows, d), w2v::kGemmThreads, KMajor::SMEM, st>>>(
      mh, mw2, b2, res, s, rows, d, f, seed, site_hid, thr_hid, scale_hid);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return ln_rows(s, gamma, beta, y, rows, d, eps, st);
}

int bwd_bf16(const bf16* g, const bf16* gs, const bf16* s, const bf16* pre, const bf16* w2,
             const float* gamma, bf16* ds, bf16* dhid, bf16* dpre, bf16* h, float* dgamma_part,
             float* dbeta_part,
             float* db2_part, float* db1_part, int rows, int d, int f, uint32_t seed,
             uint32_t site_act, uint32_t site_hid, uint32_t thr_act, uint32_t thr_hid,
             float scale_act, float scale_hid, float eps, int row_blocks, cudaStream_t st) {
  CUtensorMap mdhid, mw2;
  if (!w2v::tensor_map(&mdhid, dhid, rows, d, w2v::kGemmBM) ||
      !w2v::tensor_map(&mw2, w2, d, f, w2v::kGemmBK))     // boxes of 64 k rows x 64 columns
    return static_cast<int>(cudaErrorInvalidValue);
  auto dgrad = d == kBaseHidden   ? ffn_dgrad_wgmma_kernel<kBaseHidden>
               : d == kWideHidden ? ffn_dgrad_wgmma_kernel<kWideHidden>
                                  : ffn_dgrad_wgmma_kernel<0>;
  cudaError_t err = set_smem(dgrad, NMajor::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = row_pass(g, gs, s, gamma, dhid, ds, dgamma_part, dbeta_part, db2_part, rows, d, eps,
                 seed, site_hid, thr_hid, scale_hid, row_blocks, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  dgrad<<<w2v::gemm_grid(rows, f), w2v::kGemmThreads, NMajor::SMEM, st>>>(
      mdhid, mw2, pre, dpre, h, db1_part, rows, d, f, seed, site_act, thr_act, scale_act);
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int rows, int d, int f) {
  return rows <= 0 || d <= 0 || d % 8 || (d > w2v::kResidMaxCols && d != w2v::kResidWideCols) ||
         f <= 0 || f % 8;
}

// Both entries' forward and backward on a dtype code; r (the residual) and gs are the
// pre-norm form's, x and null in the post-norm one.
int fwd_any(const void* x, const void* r, const void* w1, const void* b1, const void* w2,
            const void* b2, const void* gamma, const void* beta, void* pre, void* h, void* s,
            void* y, int rows, int d, int f, uint32_t seed, uint32_t site_act, uint32_t site_hid,
            uint32_t thr_act, uint32_t thr_hid, float scale_act, float scale_hid, float eps,
            int dtype, void* stream) {
  if (bad_shape(rows, d, f)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* ga = static_cast<const float*>(gamma);
  const float* be = static_cast<const float*>(beta);
  switch (dtype) {
    case 0:
      return fwd<float>(static_cast<const float*>(x), static_cast<const float*>(r),
                        static_cast<const float*>(w1), static_cast<const float*>(b1),
                        static_cast<const float*>(w2), static_cast<const float*>(b2), ga, be,
                        static_cast<float*>(pre), static_cast<float*>(h), static_cast<float*>(s),
                        static_cast<float*>(y), rows, d, f, seed, site_act, site_hid, thr_act,
                        thr_hid, scale_act, scale_hid, eps, st);
    case 1:
      return fwd_bf16(static_cast<const bf16*>(x), static_cast<const bf16*>(r),
                      static_cast<const bf16*>(w1), static_cast<const bf16*>(b1),
                      static_cast<const bf16*>(w2), static_cast<const bf16*>(b2), ga, be,
                      static_cast<bf16*>(pre), static_cast<bf16*>(h), static_cast<bf16*>(s),
                      static_cast<bf16*>(y), rows, d, f, seed, site_act, site_hid, thr_act,
                      thr_hid, scale_act, scale_hid, eps, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

int bwd_any(const void* g, const void* gs, const void* s, const void* pre, const void* w2,
            const void* gamma, void* ds, void* dhid, void* dpre, void* h, void* dgamma_part,
            void* dbeta_part, void* db2_part, void* db1_part, int rows, int d, int f,
            uint32_t seed, uint32_t site_act, uint32_t site_hid, uint32_t thr_act,
            uint32_t thr_hid, float scale_act, float scale_hid, float eps, int row_blocks,
            int dtype, void* stream) {
  if (bad_shape(rows, d, f) || row_blocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* ga = static_cast<const float*>(gamma);
  float* dgp = static_cast<float*>(dgamma_part);
  float* dbp = static_cast<float*>(dbeta_part);
  float* d2p = static_cast<float*>(db2_part);
  float* d1p = static_cast<float*>(db1_part);
  switch (dtype) {
    case 0:
      return bwd<float>(static_cast<const float*>(g), static_cast<const float*>(gs),
                        static_cast<const float*>(s), static_cast<const float*>(pre),
                        static_cast<const float*>(w2), ga, static_cast<float*>(ds),
                        static_cast<float*>(dhid), static_cast<float*>(dpre),
                        static_cast<float*>(h), dgp, dbp, d2p, d1p, rows, d, f, seed, site_act,
                        site_hid, thr_act, thr_hid, scale_act, scale_hid, eps, row_blocks, st);
    case 1:
      return bwd_bf16(static_cast<const bf16*>(g), static_cast<const bf16*>(gs),
                      static_cast<const bf16*>(s), static_cast<const bf16*>(pre),
                      static_cast<const bf16*>(w2), ga, static_cast<bf16*>(ds),
                      static_cast<bf16*>(dhid), static_cast<bf16*>(dpre), static_cast<bf16*>(h),
                      dgp, dbp, d2p, d1p, rows, d, f, seed, site_act, site_hid, thr_act, thr_hid,
                      scale_act, scale_hid, eps, row_blocks, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// C entry points, bound with ctypes. dtype: 0 = float32, 1 = bfloat16; x, the weights, the
// biases and every [rows, *] tensor are in it; gamma, beta and the partials are float32.
// d and f are multiples of 8, d at most 1024 or 1280. Each returns the cudaError_t of its
// launches.

// Forward: (A) then (B); in bfloat16 (B) writes s and the row LayerNorm pass y. h is
// [rows, f] scratch between (A) and (B). Every tensor is 16-byte aligned (TMA and the
// epilogues' 16-byte accesses in bfloat16; cp.async in float32).
extern "C" int ffn_mega_fwd(const void* x, const void* w1, const void* b1, const void* w2,
                            const void* b2, const void* gamma, const void* beta, void* pre,
                            void* h, void* s, void* y, int rows, int d, int f, uint32_t seed,
                            uint32_t site_act, uint32_t site_hid, uint32_t thr_act,
                            uint32_t thr_hid, float scale_act, float scale_hid, float eps,
                            int dtype, void* stream) {
  return fwd_any(x, x, w1, b1, w2, b2, gamma, beta, pre, h, s, y, rows, d, f, seed, site_act,
                 site_hid, thr_act, thr_hid, scale_act, scale_hid, eps, dtype, stream);
}

// The pre-norm forward: (A) on x, (B) adding to the residual r, then the next LayerNorm of s
// into y. Tensors as in ffn_mega_fwd; r is [rows, d] like x.
extern "C" int ffn_prenorm_fwd(const void* x, const void* r, const void* w1, const void* b1,
                               const void* w2, const void* b2, const void* gamma,
                               const void* beta, void* pre, void* h, void* s, void* y, int rows,
                               int d, int f, uint32_t seed, uint32_t site_act, uint32_t site_hid,
                               uint32_t thr_act, uint32_t thr_hid, float scale_act,
                               float scale_hid, float eps, int dtype, void* stream) {
  return fwd_any(x, r, w1, b1, w2, b2, gamma, beta, pre, h, s, y, rows, d, f, seed, site_act,
                 site_hid, thr_act, thr_hid, scale_act, scale_hid, eps, dtype, stream);
}

// (C)'s persistent grid for `sms` SMs (resid.cuh's K2 backward row pass with the db2 sums),
// which the caller passes to ffn_mega_bwd as `row_blocks` (negative on error).
extern "C" int ffn_mega_row_blocks(int rows, int d, int sms, int dtype) {
  if (bad_shape(rows, d, 8) || sms <= 0) return -1;
  switch (dtype) {
    case 0: return w2v::ResidBwd<float, true>::grid(rows, d, sms);
    case 1: return w2v::ResidBwd<bf16, true>::grid(rows, d, sms);
    default: return -1;
  }
}

// The same for the pre-norm backward's (C).
extern "C" int ffn_prenorm_row_blocks(int rows, int d, int sms, int dtype) {
  if (bad_shape(rows, d, 8) || sms <= 0) return -1;
  switch (dtype) {
    case 0: return w2v::ResidBwd<float, true, true>::grid(rows, d, sms);
    case 1: return w2v::ResidBwd<bf16, true, true>::grid(rows, d, sms);
    default: return -1;
  }
}

// Backward: (C) then (D). `row_blocks` is (C)'s grid (ffn_mega_row_blocks): the dgamma, dbeta
// and db2 partials are [row_blocks, d]; the db1 partials are [ceil(rows / 128), f].
extern "C" int ffn_mega_bwd(const void* g, const void* s, const void* pre, const void* w2,
                            const void* gamma, void* ds, void* dhid, void* dpre, void* h,
                            void* dgamma_part, void* dbeta_part, void* db2_part,
                            void* db1_part, int rows, int d, int f, uint32_t seed,
                            uint32_t site_act, uint32_t site_hid, uint32_t thr_act,
                            uint32_t thr_hid, float scale_act, float scale_hid, float eps,
                            int row_blocks, int dtype, void* stream) {
  return bwd_any(g, nullptr, s, pre, w2, gamma, ds, dhid, dpre, h, dgamma_part, dbeta_part,
                 db2_part, db1_part, rows, d, f, seed, site_act, site_hid, thr_act, thr_hid,
                 scale_act, scale_hid, eps, row_blocks, dtype, stream);
}

// The pre-norm backward: g the gradient of y, gs that of s (the stream); ds (= dr) is the
// LayerNorm's gradient plus gs. `row_blocks` from ffn_prenorm_row_blocks.
extern "C" int ffn_prenorm_bwd(const void* g, const void* gs, const void* s, const void* pre,
                               const void* w2, const void* gamma, void* ds, void* dhid,
                               void* dpre, void* h, void* dgamma_part, void* dbeta_part,
                               void* db2_part, void* db1_part, int rows, int d, int f,
                               uint32_t seed, uint32_t site_act, uint32_t site_hid,
                               uint32_t thr_act, uint32_t thr_hid, float scale_act,
                               float scale_hid, float eps, int row_blocks, int dtype,
                               void* stream) {
  return bwd_any(g, gs, s, pre, w2, gamma, ds, dhid, dpre, h, dgamma_part, dbeta_part, db2_part,
                 db1_part, rows, d, f, seed, site_act, site_hid, thr_act, thr_hid, scale_act,
                 scale_hid, eps, row_blocks, dtype, stream);
}

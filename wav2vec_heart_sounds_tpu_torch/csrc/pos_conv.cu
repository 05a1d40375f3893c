// The encoder's grouped positional convolution with its erf GELU, forward and backward, for
// NVIDIA Hopper (sm_90a), on the encoder's own [B, T, D] layout (channels last).
//
// Replaces no TPU kernel: the JAX package leaves this layer to XLA
// (wav2vec_heart_sounds_tpu/models/wav2vec2.py:551-570). On the card cuDNN's default
// heuristics ran its bfloat16 weight gradient at 48 channels a group (wav2vec2-base) on a
// generic dgrad engine at about 1000 times the layer's bound, 77 % of a training step.
// Contract (the plain versions in ops/kernels/pos_conv.py), with C = D / groups channels a
// group, K taps, pad = K / 2, w [D, C, K] (nn.Conv1d's layout) and x zero outside [0, T):
//   forward:  y[b, t, gC + o] = bias[gC + o] + sum_{j, c} w[gC + o, c, j] x[b, t + j - pad, gC + c]
//             for t < T (an even K's trailing frame is dropped), products of bfloat16 summed
//             in float32; pre = round(y), out = round(gelu(y)) with the exact erf GELU.
//   backward: dpre = round(g * gelu'(pre)) (the gradient at the rounded pre, frames < T);
//             dx[b, s, gC + c] = sum_{j, o} w[gC + o, c, K - 1 - j] dpre[b, s + j - pad', gC + o]
//             with pad' = K - 1 - pad;
//             dw[gC + o, c, j] = sum_{b, t} dpre[b, t, gC + o] x[b, t + j - pad, gC + c] and
//             db = sum_{b, t} dpre, float32 sums over fixed row ranges (partials) reduced in a
//             fixed order by a last pass: no atomics, the same bits run to run.
//
// What bounds it (wav2vec2-base: B = 96, T = 199, D = 768, 16 groups of C = 48, K = 128):
// each of the three products is 2 B T D C K = 180 GFLOP, 0.18 ms at 989 TFLOP/s, against
// 29 MB for each of x, out, pre, g, dpre, dx (about 9 us each at 3.35 TB/s): operations.
// The design, one sliding-window GEMM per row tile:
//   * forward and dx are one kernel (pos_conv_slide_kernel): out[t] = sum_j in[t + j - pad] Wj,
//     the dx form with the taps flipped, W transposed and pad' = K - 1 - pad, on dpre. A block
//     takes one (batch, group, tile of 32 frames a warp) and loads its input window, the
//     tile's frames plus K - 1 rows of halo, into shared memory once (rows padded to an odd
//     multiple of 16 bytes, so every ldmatrix is free of bank conflicts): each tap is the
//     same window read one row further down. A from the window by ldmatrix at the shifted
//     row (a wgmma descriptor cannot start on an arbitrary row of a swizzled tile); the
//     group's weight, re-laid by the wrapper as [G][K][C][C + 8] (one tap an output channel
//     a row), streams through a 3-slot ring of tap chunks by 1D bulk copies (TMA) on mbarriers,
//     shared by every block of the group from L2. Each warp computes 32 frames x C channels
//     with mma.sync m16n8k16 (bfloat16, float32 sums): per 16 of depth 2 A and C / 16 B
//     ldmatrix.x4 for 2 C / 8 products. The epilogue adds the bias, keeps pre and writes the
//     GELU in bfloat16 (forward) or writes dx.
//   * dw (pos_conv_dw_kernel): for a (part, group, chunk of 8 taps) block, warp w sums tap
//     k0 + w over the part's (batch, 64-frame) tiles: A = dpre^T and B = the x window at the
//     warp's shift, both by ldmatrix.trans from tiles double-buffered by cp.async (zero-filled
//     past the edges); C x C float32 sums a warp, written as the part's partial
//     [part][G][K][C][C].
//   * dpre (pos_conv_dpre_kernel), 16-byte runs over rows, with per-block float32 column
//     sums for db; a last pass (pos_conv_reduce_kernel) sums the partials in order, re-lays
//     dw as [D, C, K] through shared memory and writes dw and db in bfloat16.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "gelu.cuh"
#include "mbarrier.cuh"
#include "mma_tile.cuh"

namespace {

using bf16 = __nv_bfloat16;

// Shapes that follow from C, the channels of a group (a template instance each).
template <int C>
struct Width {
  static_assert(C == 16 || C == 48 || C == 64, "channels a group");
  static constexpr int LD = C + 8;          // shared-memory row: an odd multiple of 16 bytes
  static constexpr int NT = C / 8;          // n8 tiles of the output channels
  static constexpr int KS = C / 16;         // k16 steps of one tap
  static constexpr int TAP = C * LD;        // one tap of the re-laid weight, [C][LD]
  static constexpr int TAPS = C == 16 ? 16 : C == 48 ? 4 : 2;   // taps a slot
  static constexpr int SLOT = TAPS * TAP;   // 12-22 KB
  static constexpr int STAGES = 3;
  static constexpr int DW_MIN_BLOCKS = C <= 48 ? 2 : 1;
};

constexpr int kMaxSmem = 232448 - 1024;     // a block's shared memory, less the static part
constexpr int kSlideWarps = 8;              // at most; 32 frames a warp
constexpr int kDwFrames = 64;               // frames of a dw row tile
constexpr int kDwTaps = 8;                  // taps of a dw block: one a warp
constexpr int kThreads = 256;

// ---- forward and dx: the sliding-window GEMM ----------------------------------------------

template <int C, bool kFwd>
__global__ void __launch_bounds__(kThreads, 2)
pos_conv_slide_kernel(const bf16* __restrict__ in, const bf16* __restrict__ wr,
                      const bf16* __restrict__ bias, bf16* __restrict__ out,
                      bf16* __restrict__ pre, int T, int D, int K, int pad) {
  using W = Width<C>;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ uint64_t full[W::STAGES];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  bf16* xs = ring + W::STAGES * W::SLOT;
  const int frames = blockDim.x;              // 32 frames a warp
  const int t0 = blockIdx.x * frames, g = blockIdx.y, b = blockIdx.z;
  const int win = frames + K - 1;
  const int chunks = (K + W::TAPS - 1) / W::TAPS;
  const bf16* wg = wr + static_cast<size_t>(g) * K * W::TAP;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < W::STAGES; ++s) w2v::mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // Chunk i of the group's taps into slot i % STAGES, counted on its barrier.
  auto issue = [&](int i) {
    const int taps = min(W::TAPS, K - i * W::TAPS);
    const uint32_t bytes = static_cast<uint32_t>(taps * W::TAP * 2);
    uint64_t* bar = &full[i % W::STAGES];
    w2v::mbar_expect_tx(bar, bytes);
    w2v::bulk_load(ring + (i % W::STAGES) * W::SLOT, wg + static_cast<size_t>(i) * W::SLOT, bytes,
                   bar);
  };
  if (threadIdx.x == 0)
    for (int i = 0; i < W::STAGES && i < chunks; ++i) issue(i);
  // The input window: row r holds frame t0 - pad + r of the group's channels, zero outside.
  const bf16* src = in + static_cast<size_t>(b) * T * D + g * C;
  for (int i = threadIdx.x; i < win * (C / 8); i += blockDim.x) {
    const int r = i / (C / 8), c = (i % (C / 8)) * 8, t = t0 - pad + r;
    const bool valid = t >= 0 && t < T;
    w2v::cp_async16(xs + r * W::LD + c, valid ? src + static_cast<size_t>(t) * D + c : in, valid);
  }
  w2v::cp_async_commit();
  w2v::cp_async_wait<0>();
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m0 = warp * 32;
  float acc[2][W::NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < W::NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  // ldmatrix rows: A (frames x channels) at the warp's frames, B (outputs x channels) of a tap.
  const bf16* a_lane = xs + (m0 + (lane & 15)) * W::LD + (lane >> 4) * 8;
  const int b_lane = ((lane & 7) + ((lane >> 4) << 3)) * W::LD + ((lane >> 3) & 1) * 8;
  for (int i = 0; i < chunks; ++i) {
    const int slot = i % W::STAGES;
    w2v::mbar_wait(&full[slot], (i / W::STAGES) & 1);
    const bf16* ws = ring + slot * W::SLOT + b_lane;
    const int taps = min(W::TAPS, K - i * W::TAPS);
    for (int jj = 0; jj < taps; ++jj) {
      const bf16* at = a_lane + (i * W::TAPS + jj) * W::LD;     // tap j: one row further down
      const bf16* wt = ws + jj * W::TAP;
#pragma unroll
      for (int ks = 0; ks < W::KS; ++ks) {
        uint32_t a0[4], a1[4];
        w2v::ldmatrix_x4(a0, at + ks * 16);
        w2v::ldmatrix_x4(a1, at + 16 * W::LD + ks * 16);
#pragma unroll
        for (int np = 0; np < W::NT / 2; ++np) {
          uint32_t bq[4];
          w2v::ldmatrix_x4(bq, wt + np * 16 * W::LD + ks * 16);
          w2v::mma_bf16(acc[0][2 * np], a0, bq[0], bq[1]);
          w2v::mma_bf16(acc[0][2 * np + 1], a0, bq[2], bq[3]);
          w2v::mma_bf16(acc[1][2 * np], a1, bq[0], bq[1]);
          w2v::mma_bf16(acc[1][2 * np + 1], a1, bq[2], bq[3]);
        }
      }
    }
    __syncthreads();                          // every warp is done with the slot
    if (threadIdx.x == 0 && i + W::STAGES < chunks) {
      w2v::fence_proxy_async();
      issue(i + W::STAGES);
    }
  }

  // Epilogue: the mma layout gives a thread rows lane / 4 and + 8 of each m16 tile, columns
  // 2 (lane % 4) and + 1 of each n8 tile.
  const int row = lane / 4, col = 2 * (lane % 4);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = t0 + m0 + mt * 16 + row + 8 * h;
      if (t >= T) continue;
      const size_t o = (static_cast<size_t>(b) * T + t) * D + g * C;
#pragma unroll
      for (int nt = 0; nt < W::NT; ++nt) {
        const int n = nt * 8 + col;
        float v0 = acc[mt][nt][2 * h], v1 = acc[mt][nt][2 * h + 1];
        if constexpr (kFwd) {
          if (bias != nullptr) {
            v0 += __bfloat162float(bias[g * C + n]);
            v1 += __bfloat162float(bias[g * C + n + 1]);
          }
          *reinterpret_cast<__nv_bfloat162*>(pre + o + n) = __floats2bfloat162_rn(v0, v1);
          *reinterpret_cast<__nv_bfloat162*>(out + o + n) =
              __floats2bfloat162_rn(w2v::gelu_erf_exact(v0), w2v::gelu_erf_exact(v1));
        } else {
          *reinterpret_cast<__nv_bfloat162*>(out + o + n) = __floats2bfloat162_rn(v0, v1);
        }
      }
    }
}

// ---- dpre and the column partials of db ---------------------------------------------------

// Block q takes rows [q rows_per_part, (q + 1) rows_per_part) of the [rows, D] tensors; a
// thread one 16-byte run of columns every `lanes` rows. dbp[q][d] = the block's column sums
// of the rounded dpre, its lanes added in order.
__global__ void __launch_bounds__(kThreads)
pos_conv_dpre_kernel(const bf16* __restrict__ g, const bf16* __restrict__ pre,
                     bf16* __restrict__ dpre, float* __restrict__ dbp, int rows, int D,
                     int rows_per_part) {
  __shared__ float sums[kThreads * 8];
  const int runs = D / 8, lanes = kThreads / runs;
  const int run = threadIdx.x % runs, lane = threadIdx.x / runs;
  const int r0 = blockIdx.x * rows_per_part, r1 = min(rows, r0 + rows_per_part);
  float s[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (lane < lanes) {
    for (int r = r0 + lane; r < r1; r += lanes) {
      const size_t o = static_cast<size_t>(r) * D + run * 8;
      float gv[8], pv[8], dv[8];
      w2v::Run16<bf16>::unpack(*reinterpret_cast<const uint4*>(g + o), gv);
      w2v::Run16<bf16>::unpack(*reinterpret_cast<const uint4*>(pre + o), pv);
#pragma unroll
      for (int e = 0; e < 8; ++e) dv[e] = gv[e] * w2v::gelu_erf_exact_grad(pv[e]);
      const uint4 packed = w2v::Run16<bf16>::pack(dv);
      *reinterpret_cast<uint4*>(dpre + o) = packed;
      w2v::Run16<bf16>::unpack(packed, dv);
#pragma unroll
      for (int e = 0; e < 8; ++e) s[e] += dv[e];
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) sums[lane * D + run * 8 + e] = s[e];
  }
  if (dbp == nullptr) return;
  __syncthreads();
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float total = 0.f;
    for (int l = 0; l < lanes; ++l) total += sums[l * D + d];
    dbp[static_cast<size_t>(blockIdx.x) * D + d] = total;
  }
}

// ---- dw: float32 partials over row ranges -------------------------------------------------

template <int C>
__global__ void __launch_bounds__(kThreads, Width<C>::DW_MIN_BLOCKS)
pos_conv_dw_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dpre,
                   float* __restrict__ parts, int B, int T, int D, int K, int pad, int n_parts) {
  using W = Width<C>;
  constexpr int XR = kDwFrames + kDwTaps;     // window rows (the last one unused)
  __shared__ __align__(128) bf16 ds[2][kDwFrames * W::LD];
  __shared__ __align__(128) bf16 xs[2][XR * W::LD];
  const int p = blockIdx.x, k0 = blockIdx.y * kDwTaps, g = blockIdx.z;
  const int groups = D / C;
  const int per_b = (T + kDwFrames - 1) / kDwFrames, tiles = B * per_b;
  const int lo = static_cast<int>(static_cast<long long>(tiles) * p / n_parts);
  const int hi = static_cast<int>(static_cast<long long>(tiles) * (p + 1) / n_parts);
  // Tile (b, t0): dpre frames t0 .. t0 + 63 and x frames t0 + k0 - pad .. + 70, zero outside.
  auto load = [&](int tile, int buf) {
    const int b = tile / per_b, t0 = (tile % per_b) * kDwFrames;
    const size_t base = static_cast<size_t>(b) * T * D + g * C;
    for (int i = threadIdx.x; i < kDwFrames * (C / 8); i += kThreads) {
      const int r = i / (C / 8), c = (i % (C / 8)) * 8, t = t0 + r;
      const bool valid = t < T;
      w2v::cp_async16(&ds[buf][r * W::LD + c], valid ? dpre + base + static_cast<size_t>(t) * D + c
                                                     : dpre, valid);
    }
    for (int i = threadIdx.x; i < (XR - 1) * (C / 8); i += kThreads) {
      const int r = i / (C / 8), c = (i % (C / 8)) * 8, t = t0 + k0 - pad + r;
      const bool valid = t >= 0 && t < T;
      w2v::cp_async16(&xs[buf][r * W::LD + c], valid ? x + base + static_cast<size_t>(t) * D + c
                                                     : x, valid);
    }
    w2v::cp_async_commit();
  };
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int k = k0 + warp;                    // the warp's tap
  float acc[C / 16][W::NT][4];
#pragma unroll
  for (int mt = 0; mt < C / 16; ++mt)
#pragma unroll
    for (int nt = 0; nt < W::NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  // ldmatrix.trans rows: A = dpre^T (rows: frames, columns: outputs), B = x at the tap's shift.
  const int a_lane = (((lane >> 4) & 1) * 8 + (lane & 7)) * W::LD + ((lane >> 3) & 1) * 8;
  const int b_lane = (warp + (lane & 15)) * W::LD + (lane >> 4) * 8;
  if (lo < hi) load(lo, 0);
  for (int tile = lo; tile < hi; ++tile) {
    const int buf = (tile - lo) & 1;
    if (tile + 1 < hi) load(tile + 1, buf ^ 1);
    else w2v::cp_async_commit();
    w2v::cp_async_wait<1>();
    __syncthreads();
    if (k < K) {
#pragma unroll
      for (int kk = 0; kk < kDwFrames / 16; ++kk) {
        uint32_t a[C / 16][4];
#pragma unroll
        for (int mt = 0; mt < C / 16; ++mt)
          w2v::ldmatrix_x4_trans(a[mt], &ds[buf][kk * 16 * W::LD + a_lane + mt * 16]);
#pragma unroll
        for (int np = 0; np < W::NT / 2; ++np) {
          uint32_t bq[4];
          w2v::ldmatrix_x4_trans(bq, &xs[buf][kk * 16 * W::LD + b_lane + np * 16]);
#pragma unroll
          for (int mt = 0; mt < C / 16; ++mt) {
            w2v::mma_bf16(acc[mt][2 * np], a[mt], bq[0], bq[1]);
            w2v::mma_bf16(acc[mt][2 * np + 1], a[mt], bq[2], bq[3]);
          }
        }
      }
    }
    __syncthreads();                          // the buffer may be loaded again
  }
  if (k >= K) return;
  float* dst = parts + ((static_cast<size_t>(p) * groups + g) * K + k) * C * C;
  const int row = lane / 4, col = 2 * (lane % 4);
#pragma unroll
  for (int mt = 0; mt < C / 16; ++mt)
#pragma unroll
    for (int nt = 0; nt < W::NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(dst + (mt * 16 + row + 8 * h) * C + nt * 8 + col) =
            make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
}

// Block d (an output channel gC + o): dw[d] [C, K] = the sum of the parts in order, re-laid
// from [K][C] through shared memory; db[d] = the sum of the dpre blocks' column sums.
__global__ void __launch_bounds__(kThreads)
pos_conv_reduce_kernel(const float* __restrict__ parts, const float* __restrict__ dbp,
                       bf16* __restrict__ dw, bf16* __restrict__ db, int D, int C, int K,
                       int n_parts, int n_db) {
  extern __shared__ float tile[];
  const int d = blockIdx.x, g = d / C, o = d % C, groups = D / C;
  if (dw != nullptr) {
    for (int e = threadIdx.x; e < C * K; e += blockDim.x) {
      const int k = e / C, c = e % C;
      const float* src = parts + ((static_cast<size_t>(g) * K + k) * C + o) * C + c;
      const size_t stride = static_cast<size_t>(groups) * K * C * C;
      float s = 0.f;
      for (int p = 0; p < n_parts; ++p) s += src[p * stride];
      tile[c * K + k] = s;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < C * K; e += blockDim.x)
      dw[static_cast<size_t>(d) * C * K + e] = __float2bfloat16(tile[e]);
  }
  if (db != nullptr && threadIdx.x == 0) {
    float s = 0.f;
    for (int q = 0; q < n_db; ++q) s += dbp[static_cast<size_t>(q) * D + d];
    db[d] = __float2bfloat16(s);
  }
}

// ---- host ---------------------------------------------------------------------------------

bool takes_width(int C) { return C == 16 || C == 48 || C == 64; }

bool bad_shape(int B, int T, int D, int C, int K) {
  return B <= 0 || T <= 0 || K <= 0 || C <= 0 || !takes_width(C) || D % C != 0 || D / 8 > kThreads;
}

// Raises a kernel's dynamic shared memory ceiling to kMaxSmem once a device (``raised`` holds
// a bit a device ordinal below 64, one ``raised`` a kernel): the attribute is the current
// device's, and a ceiling, so it covers every smaller launch after it.
template <typename Kernel>
cudaError_t allow_max_smem(Kernel kernel, std::atomic<uint64_t>& raised) {
  int device = 0;
  if (cudaError_t err = cudaGetDevice(&device); err != cudaSuccess) return err;
  const uint64_t bit = device < 64 ? uint64_t{1} << device : 0;
  if (raised.load(std::memory_order_acquire) & bit) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err == cudaSuccess) raised.fetch_or(bit, std::memory_order_release);
  return err;
}

template <int C>
cudaError_t slide(bool fwd, const bf16* in, const bf16* wr, const bf16* bias, bf16* out,
                  bf16* pre, int B, int T, int D, int K, int pad, cudaStream_t st) {
  using W = Width<C>;
  const int warps = (T + 31) / 32 < kSlideWarps ? (T + 31) / 32 : kSlideWarps;
  const int frames = 32 * warps;
  const long long smem =
      2ll * W::STAGES * W::SLOT + 2ll * (frames + K - 1) * W::LD;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  static std::atomic<uint64_t> raised_fwd{0}, raised_dx{0};
  auto kernel = fwd ? pos_conv_slide_kernel<C, true> : pos_conv_slide_kernel<C, false>;
  const cudaError_t err = allow_max_smem(kernel, fwd ? raised_fwd : raised_dx);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((T + frames - 1) / frames, D / C, B), frames, static_cast<size_t>(smem), st>>>(
      in, wr, bias, out, pre, T, D, K, pad);
  return cudaGetLastError();
}

cudaError_t slide_any(bool fwd, const bf16* in, const bf16* wr, const bf16* bias, bf16* out,
                      bf16* pre, int B, int T, int D, int C, int K, int pad, cudaStream_t st) {
  switch (C) {
    case 16: return slide<16>(fwd, in, wr, bias, out, pre, B, T, D, K, pad, st);
    case 48: return slide<48>(fwd, in, wr, bias, out, pre, B, T, D, K, pad, st);
    default: return slide<64>(fwd, in, wr, bias, out, pre, B, T, D, K, pad, st);
  }
}

template <int C>
cudaError_t dw_parts(const bf16* x, const bf16* dpre, float* parts, int B, int T, int D, int K,
                     int pad, int n_parts, cudaStream_t st) {
  pos_conv_dw_kernel<C><<<dim3(n_parts, (K + kDwTaps - 1) / kDwTaps, D / C), kThreads, 0, st>>>(
      x, dpre, parts, B, T, D, K, pad, n_parts);
  return cudaGetLastError();
}

cudaError_t dw_parts_any(const bf16* x, const bf16* dpre, float* parts, int B, int T, int D, int C,
                         int K, int pad, int n_parts, cudaStream_t st) {
  switch (C) {
    case 16: return dw_parts<16>(x, dpre, parts, B, T, D, K, pad, n_parts, st);
    case 48: return dw_parts<48>(x, dpre, parts, B, T, D, K, pad, n_parts, st);
    default: return dw_parts<64>(x, dpre, parts, B, T, D, K, pad, n_parts, st);
  }
}

}  // namespace

// Every pointer 16-byte aligned, every tensor contiguous bfloat16. Forward: x [B, T, D],
// wr = w re-laid as [G][K][C][C + 8] (wr[g][j][o][c] = w[gC + o, c, j]), bias [D] or null ->
// out, pre [B, T, D].
extern "C" int pos_conv_fwd_bf16(const void* x, const void* wr, const void* bias, void* out,
                                 void* pre, int B, int T, int D, int C, int K, void* stream) {
  if (bad_shape(B, T, D, C, K)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(slide_any(true, static_cast<const bf16*>(x),
                                    static_cast<const bf16*>(wr), static_cast<const bf16*>(bias),
                                    static_cast<bf16*>(out), static_cast<bf16*>(pre), B, T, D, C,
                                    K, K / 2, static_cast<cudaStream_t>(stream)));
}

// Backward from x, pre and the cotangent g [B, T, D]: dpre [B, T, D] (scratch) with the db
// column partials dbp [n_db, D] (float32 scratch, need_db); dx [B, T, D] from wd = w re-laid
// as [G][K][C][C + 8] with the taps flipped and w transposed (wd[g][j][c][o] =
// w[gC + o, c, K - 1 - j]; need_dx); dw [D, C, K] through the float32 partials
// [n_parts, G, K, C, C] (need_dw); db [D] (need_db).
extern "C" int pos_conv_bwd_bf16(const void* x, const void* g, const void* pre, const void* wd,
                                 void* dpre, void* dbp, void* dx, void* parts, void* dw, void* db,
                                 int B, int T, int D, int C, int K, int n_db, int n_parts,
                                 int need_dx, int need_dw, int need_db, void* stream) {
  if (bad_shape(B, T, D, C, K) || n_db <= 0 || n_parts <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows = B * T, rows_per_part = (rows + n_db - 1) / n_db;
  pos_conv_dpre_kernel<<<n_db, kThreads, 0, st>>>(
      static_cast<const bf16*>(g), static_cast<const bf16*>(pre), static_cast<bf16*>(dpre),
      need_db ? static_cast<float*>(dbp) : nullptr, rows, D, rows_per_part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (need_dx) {
    err = slide_any(false, static_cast<const bf16*>(dpre), static_cast<const bf16*>(wd), nullptr,
                    static_cast<bf16*>(dx), nullptr, B, T, D, C, K, K - 1 - K / 2, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (need_dw) {
    err = dw_parts_any(static_cast<const bf16*>(x), static_cast<const bf16*>(dpre),
                       static_cast<float*>(parts), B, T, D, C, K, K / 2, n_parts, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (need_dw || need_db) {
    const int smem = need_dw ? C * K * 4 : 0;
    if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
    static std::atomic<uint64_t> raised{0};
    err = allow_max_smem(pos_conv_reduce_kernel, raised);
    if (err != cudaSuccess) return static_cast<int>(err);
    pos_conv_reduce_kernel<<<D, kThreads, smem, st>>>(
        static_cast<const float*>(parts), static_cast<const float*>(dbp),
        need_dw ? static_cast<bf16*>(dw) : nullptr, need_db ? static_cast<bf16*>(db) : nullptr, D,
        C, K, n_parts, n_db);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}

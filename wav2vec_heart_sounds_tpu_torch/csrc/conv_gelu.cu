// Fused strided conv + erf GELU (kernel 3, stride 2, VALID) for NVIDIA Hopper (sm_90a):
// forward and backward, on the port's channels-first [B, C, T] layout.
//
// Replaces the TPU kernel wav2vec_heart_sounds_tpu/ops/pallas/conv.py::conv_gelu (K8):
// _conv_gelu_fwd (pallas_call :192) and _conv_gelu_bwd (pallas_call :277), the feature
// encoder's conv_1 under W2VHS_CONVFUSE=1. Contract (the plain version in
// ops/kernels/conv.py), with w [Cout, Cin, 3] (nn.Conv1d's layout) and
// out_len = (Tin - 3) / 2 + 1:
//   forward:  y[b, o, t] = sum_{c, j} w[o, c, j] x[b, c, 2t + j], products of the input
//             dtype summed in float32; pre = round_T(y), out = round_T(gelu(y)) with the
//             erf GELU (gelu.cuh's rational erf, the JAX kernel's _gelu_exact) in every dtype
//             (in bfloat16 its divisions as products, a few float ulp below bf16 rounding).
//   backward: dpre = round_T(g * gelu'(pre)) (the gradient taken at the rounded pre; in
//             bfloat16 in the plain version's order of operations, the same bits);
//             dx[b, c, s] = sum_{o, j: s = 2t + j} w[o, c, j] dpre[b, o, t] and
//             dw[o, c, j] = sum_{b, t} dpre[b, o, t] x[b, c, 2t + j], float32 sums, dw from
//             per-block float32 partials reduced in a second pass (no atomics). Input rows
//             past 2 out_len get only what the taps give them: row 2 out_len the tap-2 term
//             of the last frame (the JAX kernel's `tail`), row 2 out_len + 1 zero.
//
// What bounds it on this card (wav2vec2-base conv_1: B = 96, Cin = Cout = 512,
// Tin = 12799, out_len = 6399, bf16): the forward is 2 * 614304 * 512 * 1536 = 0.97 TFLOP,
// 0.98 ms at 989 TFLOP/s, against 2.5 GB of x, out and pre (0.75 ms at 3.35 TB/s):
// operations. The backward (dx and dw) is twice the products, 1.95 ms. On the TPU the frame
// view [B, T/2, 2C] is a free VMEM reindexing of channels-last blocks with an 8-row halo
// from conv_time_plan's padding; here the layout is channels-first with exact, odd lengths:
// a row of x (25598 bytes) or of out (12798) starts at any 2-byte offset, and a tensor map
// needs every row stride to be a multiple of 16 bytes (and, as measured on the card, every
// box to start at a 16-byte column: a one-element shift along the contiguous axis cannot be
// loaded). So the bfloat16 bodies make the JAX kernel's frame view once and run three Hopper
// GEMMs on it (wgmma_tile.cuh: TMA with the 128-byte swizzle into a 4-slot mbarrier ring, one
// producer warp, two ping-pong consumer groups of two warpgroups on wgmma m64n128k16, 128 x
// 128 tiles, one block an SM), each tap's shift a shift of the rows a k step reads:
//   * pack: xf [B, out_len + 1, 2 Cin], row u = (x[:, 2u], x[:, 2u + 1]), zero past T (row
//     out_len holds x[2 out_len], the last frame's tap-2 input), transposed through shared
//     memory and written in 16-byte runs. The backward reads xf, not x (no second pack).
//   * forward: M = Cout, N = the frames of one batch (tiles of 128, the one past out_len
//     skipped), K = 3 Cin in the weight re-laid as wr [Cout, 3 Cin] (k = tap Cin + c): the k
//     steps of the first 2 Cin read xf at row n, the last Cin at row n + 1. Both operands
//     K-major. The epilogue stages the tile through shared memory twice (pre, then the erf
//     GELU of the float32 sums, its divisions as products: only the 8 warps of a group run
//     it, and the IEEE divisions' branches kept it from overlapping the other group's
//     products), and each warp writes a row's 128 frames as 64 contiguous bytes a store (out
//     and pre rows start at any 2-byte offset).
//   * dpre: one elementwise pass, g and pre -> dpre_t [B, P, Cout], channels last, the frame
//     axis padded with zeros to P = out_len + 1 rounded up to 64 (transposed through shared
//     memory).
//   * dx: M = 64 channels, N = 128 pairs u of one batch (rows 2u and 2u + 1), K = Cout, both
//     operands K-major (wx, the weight re-laid per 64 channels as [w0^T; w1^T; w2^T], and
//     dpre_t). Warpgroup 0 sums the even rows: tap 0 at frame u and tap 2 at frame u - 1 (row
//     u - 1 of dpre_t: the previous batch's zero pad, or a zero fill before the first row);
//     warpgroup 1 the odd rows: tap 1 at u (it idles in the tap-2 k steps). So one tile
//     holds both rows of each pair and writes each channel's 256 outputs as one run. Row
//     2 out_len gets only the tap-2 term and row 2 out_len + 1 zero, from the pad.
//   * dW: M = Cout, N = 3 Cin, K = the padded frames of a range of (batch, 64-frame) steps:
//     A = dpre_t M-major (transpose-A), B = xf N-major (transpose-B), tap 2 at row t + 1; the
//     pad rows of dpre_t are zero, so frames past out_len add nothing. Float32 partials
//     [P, Cout, 3 Cin] over P ranges, summed in a fixed order by a last pass (no atomics).
// Products in bf16 with float32 sums; pre rounded to bf16, the GELU and its gradient from
// the float32 sums and from the rounded pre. The float32 bodies keep the earlier design:
// three GEMMs over the mma_tile.cuh tiling in FMAs whose data operand is gathered through
// registers (scalar loads, every block edge guarded), so float32 checks stay tight:
//   * forward: M = Cout (128), N = frames (128), K = (c, j) in steps of 16 channels x 3
//     taps; the frame tile is an in-shared-memory im2col of the 257 samples 128 frames read.
//   * dx: M = Cin (128), N = 64 output pairs u, K = Cout in steps of 32, two accumulators
//     (even rows w0^T dpre[u] + w2^T dpre[u - 1], odd rows w1^T dpre[u]); wt [3][Cin][Cout].
//   * dw: M = Cout (128), N = Cin of one tap (128), K = the rows (b, t) of one of P ranges,
//     float32 partials [P, Cout, 3 Cin] summed by the same last pass.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "gelu.cuh"
#include "mma_tile.cuh"
#include "wgmma_tile.cuh"

namespace {

constexpr int kThreads = w2v::kTileThreads;
using w2v::cp_async_commit;
using w2v::cp_async_wait;
using w2v::load_tile;
using w2v::store;
using w2v::Tiling;
using w2v::to_float;
using w2v::warp_tile;

// ---- float32 bodies (mma_tile.cuh; the templates serve T = float, the reduce both) ---------

constexpr int kFwdChannels = 16;                 // input channels per forward k step

template <typename T>
using FwdTile = Tiling<T, 128, 128, 3 * kFwdChannels, 64, 32, true, 1>;
template <typename T>
using DxTile = Tiling<T, 128, 64, 32, 32, 32, true, 1>;
template <typename T>
using DwTile = Tiling<T, 128, 128, 32, 64, 32, false, 1>;

// A pair of values of T: the forward's prefetch.
template <typename T> struct PairOf;
template <> struct PairOf<float> { using type = float2; };

// One block an SM: the float32 FMA tiles need the registers.
template <typename T>
constexpr int kMinBlocks = 1;

template <class G>
__device__ __forceinline__ void zero(float (&acc)[G::MT][G::NT][4]) {
#pragma unroll
  for (int i = 0; i < G::MT; ++i)
#pragma unroll
    for (int j = 0; j < G::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
}

// Each k step's data tile is gathered in two halves: the global loads of step k + 1 go out
// into registers before step k's products, and land in shared memory after them, so their
// latency hides behind the tensor cores. A thread's share of a tile is fixed (item
// threadIdx.x + i * kThreads), so the loads of one step are independent and all in flight.

// ---- forward: out, pre [B, Cout, out_len] ------------------------------------------------

// The frame tile of one k step: kFwdChannels channels x (BN + 1) sample pairs
// (x[2u], x[2u + 1]) for frames u0 .. u0 + BN (the last pair feeds tap 2 of frame BN - 1).
template <typename T>
struct FwdGather {
  using G = FwdTile<T>;
  static constexpr int kPairs = G::BN + 1;
  static constexpr int kItems = kFwdChannels * kPairs;
  static constexpr int kPer = (kItems + kThreads - 1) / kThreads;

  using Pair = typename PairOf<T>::type;

  __device__ __forceinline__ static void load(Pair (&r)[kPer], const T* __restrict__ xb,
                                              int tin, int c0, int t0) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = threadIdx.x + i * kThreads;
      const int c = e / kPairs, u = e - c * kPairs;
      const int src = 2 * (t0 + u);
      const T* row = xb + static_cast<size_t>(c0 + (e < kItems ? c : 0)) * tin;
      r[i].x = e < kItems && src < tin ? row[src] : T();
      r[i].y = e < kItems && src + 1 < tin ? row[src + 1] : T();
    }
  }

  // Row 3c + j, column u of the tile holds x[c0 + c, 2 (t0 + u) + j].
  __device__ __forceinline__ static void put(const Pair (&r)[kPer], T* Bs) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = threadIdx.x + i * kThreads;
      if (e >= kItems) continue;
      const int c = e / kPairs, u = e - c * kPairs;
      T* rows = Bs + 3 * c * G::SB;
      if (u < G::BN) {
        rows[u] = r[i].x;                                       // tap 0 of frame u
        rows[G::SB + u] = r[i].y;                               // tap 1 of frame u
      }
      if (u > 0) rows[2 * G::SB + u - 1] = r[i].x;              // tap 2 of frame u - 1
    }
  }
};

template <typename T>
constexpr int fwd_smem() {
  return (2 * FwdTile<T>::A_ELEMS + FwdTile<T>::B_ELEMS) * static_cast<int>(sizeof(T));
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks<T>)
conv_gelu_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out,
                     T* __restrict__ pre, int cin, int tin, int cout, int out_len) {
  using G = FwdTile<T>;
  using Gather = FwdGather<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* As = reinterpret_cast<T*>(smem_raw);        // two stages of the weight tile
  T* Bs = As + 2 * G::A_ELEMS;                   // the frame tile
  const int t0 = blockIdx.x * G::BN, m0 = blockIdx.y * G::BM, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm0 = (warp / G::WARPS_N) * G::WM, wn0 = (warp % G::WARPS_N) * G::WN;
  const T* xb = x + static_cast<size_t>(b) * cin * tin;
  float acc[G::MT][G::NT][4];
  zero<G>(acc);

  typename Gather::Pair r[Gather::kPer];
  const int steps = cin / kFwdChannels;
  Gather::load(r, xb, tin, 0, t0);
  load_tile<T, G::BM, G::BK, G::SA>(As, w, 3 * cin, m0, INT_MAX, 0);
  cp_async_commit();
  for (int kt = 0; kt < steps; ++kt) {
    Gather::put(r, Bs);
    cp_async_wait<0>();
    __syncthreads();                             // step kt's weights and frames are in
    if (kt + 1 < steps) {
      load_tile<T, G::BM, G::BK, G::SA>(As + ((kt + 1) & 1) * G::A_ELEMS, w, 3 * cin, m0,
                                        INT_MAX, 3 * (kt + 1) * kFwdChannels);
      cp_async_commit();
      Gather::load(r, xb, tin, (kt + 1) * kFwdChannels, t0);
    }
    warp_tile<G>(acc, As + (kt & 1) * G::A_ELEMS, Bs, wm0, wn0, lane);
    __syncthreads();                             // the frame tile is consumed
  }

  const int g = lane >> 2, t2 = 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < G::MT; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int o = m0 + wm0 + i * 16 + g + half * 8;
      const size_t row = (static_cast<size_t>(b) * cout + o) * out_len;
#pragma unroll
      for (int j = 0; j < G::NT; ++j) {
        const int t = t0 + wn0 + j * 8 + t2;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (t + e >= out_len) continue;
          const float y = acc[i][j][2 * half + e];
          store(pre + row + t + e, y);
          store(out + row + t + e, w2v::gelu_erf(y));
        }
      }
    }
}

// ---- backward ------------------------------------------------------------------------------

template <typename T>
__global__ void conv_gelu_dpre_kernel(const T* __restrict__ g, const T* __restrict__ pre,
                                      T* __restrict__ dpre, long long n) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * blockDim.x)
    store(dpre + i, to_float(g[i]) * w2v::gelu_erf_grad(to_float(pre[i])));
}

// The dpre tile of one dx k step: BK outputs o x frames u0 - 1 .. u0 + BN - 1.
template <typename T>
struct DxGather {
  using G = DxTile<T>;
  static constexpr int kSpan = G::BN + 1;
  static constexpr int kItems = G::BK * kSpan;
  static constexpr int kPer = (kItems + kThreads - 1) / kThreads;

  __device__ __forceinline__ static void load(T (&r)[kPer], const T* __restrict__ db,
                                              int out_len, int o0, int u0) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = threadIdx.x + i * kThreads;
      const int o = e / kSpan, s = e - o * kSpan;
      const int t = u0 - 1 + s;
      r[i] = e < kItems && t >= 0 && t < out_len ? db[static_cast<size_t>(o0 + o) * out_len + t]
                                                 : T();
    }
  }

  // D0[o][u] = dpre[o0 + o, u0 + u], D1[o][u] = dpre[o0 + o, u0 + u - 1].
  __device__ __forceinline__ static void put(const T (&r)[kPer], T* D0, T* D1) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = threadIdx.x + i * kThreads;
      if (e >= kItems) continue;
      const int o = e / kSpan, s = e - o * kSpan;
      if (s < G::BN) D1[o * G::SB + s] = r[i];
      if (s > 0) D0[o * G::SB + s - 1] = r[i];
    }
  }
};

template <typename T>
constexpr int dx_smem() {
  return (6 * DxTile<T>::A_ELEMS + 2 * DxTile<T>::B_ELEMS) * static_cast<int>(sizeof(T));
}

// dx[b, c, 2u] and dx[b, c, 2u + 1] for 64 pairs u and 128 channels c.
template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks<T>)
conv_gelu_dx_kernel(const T* __restrict__ dpre, const T* __restrict__ wt, T* __restrict__ dx,
                    int cin, int tin, int cout, int out_len) {
  using G = DxTile<T>;
  using Gather = DxGather<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* As = reinterpret_cast<T*>(smem_raw);        // two stages of three taps of wt, [c][o]
  T* D0 = As + 6 * G::A_ELEMS;
  T* D1 = D0 + G::B_ELEMS;
  const int u0 = blockIdx.x * G::BN, m0 = blockIdx.y * G::BM, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm0 = (warp / G::WARPS_N) * G::WM, wn0 = (warp % G::WARPS_N) * G::WN;
  const T* db = dpre + static_cast<size_t>(b) * cout * out_len;
  float even[G::MT][G::NT][4], odd[G::MT][G::NT][4];
  zero<G>(even);
  zero<G>(odd);

  auto load_weights = [&](int stage, int o0) {
#pragma unroll
    for (int j = 0; j < 3; ++j)
      load_tile<T, G::BM, G::BK, G::SA>(As + (3 * stage + j) * G::A_ELEMS,
                                        wt + static_cast<size_t>(j) * cin * cout, cout, m0,
                                        INT_MAX, o0);
    cp_async_commit();
  };
  T r[Gather::kPer];
  const int steps = cout / G::BK;
  Gather::load(r, db, out_len, 0, u0);
  load_weights(0, 0);
  for (int kt = 0; kt < steps; ++kt) {
    Gather::put(r, D0, D1);
    cp_async_wait<0>();
    __syncthreads();
    if (kt + 1 < steps) {
      load_weights((kt + 1) & 1, (kt + 1) * G::BK);
      Gather::load(r, db, out_len, (kt + 1) * G::BK, u0);
    }
    const T* A = As + 3 * (kt & 1) * G::A_ELEMS;
    warp_tile<G>(even, A, D0, wm0, wn0, lane);
    warp_tile<G>(odd, A + G::A_ELEMS, D0, wm0, wn0, lane);
    warp_tile<G>(even, A + 2 * G::A_ELEMS, D1, wm0, wn0, lane);
    __syncthreads();
  }

  const int g = lane >> 2, t2 = 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < G::MT; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c = m0 + wm0 + i * 16 + g + half * 8;
      T* row = dx + (static_cast<size_t>(b) * cin + c) * tin;
#pragma unroll
      for (int j = 0; j < G::NT; ++j) {
        const int u = u0 + wn0 + j * 8 + t2;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int s = 2 * (u + e);
          if (s < tin) store(row + s, even[i][j][2 * half + e]);
          if (s + 1 < tin) store(row + s + 1, odd[i][j][2 * half + e]);
        }
      }
    }
}

// Float32 partial p of dw over rows r = b * out_len + t in [p * chunk, (p + 1) * chunk):
// parts[p, o, j * Cin + c] for 128 outputs o and 128 channels c of one tap j. Item i of a
// thread is row m = warp + 8 i of both tiles at k = lane, so each thread's row r (and its
// (b, t)) is the same for all its items; items 2q and 2q + 1 share a register.
template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks<T>)
conv_gelu_dw_kernel(const T* __restrict__ dpre, const T* __restrict__ x, float* __restrict__ parts,
                    int batch, int cin, int tin, int cout, int out_len, int chunk) {
  using G = DwTile<T>;
  static_assert(G::BK == 32 && G::BM == G::BN && G::BM % (2 * kThreads / 32) == 0, "dw tiling");
  constexpr int kPer = G::BM / (kThreads / 32);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* As = reinterpret_cast<T*>(smem_raw);        // [o][k] = dpre[b, o, t]
  T* Bs = As + G::A_ELEMS;                       // [c][k] = x[b, c, 2t + j]
  const int tiles = cin / G::BN;
  const int j = blockIdx.x / tiles, c0 = (blockIdx.x % tiles) * G::BN;
  const int m0 = blockIdx.y * G::BM, p = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm0 = (warp / G::WARPS_N) * G::WM, wn0 = (warp % G::WARPS_N) * G::WN;
  const long long total = static_cast<long long>(batch) * out_len;
  const long long begin = static_cast<long long>(p) * chunk;
  const long long end = begin + chunk < total ? begin + chunk : total;
  float acc[G::MT][G::NT][4];
  zero<G>(acc);

  using Pair = typename PairOf<T>::type;
  Pair ra[kPer / 2], rb[kPer / 2];
  auto load = [&](long long r0) {
    const long long r = r0 + lane;
    const bool live = r < end;
    const long long bb = r / out_len, t = r - bb * out_len;
    const T* a = dpre + (bb * cout + m0 + warp) * out_len + t;
    const T* bx = x + (bb * cin + c0 + warp) * tin + 2 * t + j;
#pragma unroll
    for (int q = 0; q < kPer / 2; ++q) {
      ra[q].x = live ? a[static_cast<long long>(16 * q) * out_len] : T();
      ra[q].y = live ? a[static_cast<long long>(16 * q + 8) * out_len] : T();
      rb[q].x = live ? bx[static_cast<long long>(16 * q) * tin] : T();
      rb[q].y = live ? bx[static_cast<long long>(16 * q + 8) * tin] : T();
    }
  };
  if (begin < end) load(begin);
  for (long long r0 = begin; r0 < end; r0 += G::BK) {
#pragma unroll
    for (int q = 0; q < kPer / 2; ++q) {
      As[(warp + 16 * q) * G::SA + lane] = ra[q].x;
      As[(warp + 16 * q + 8) * G::SA + lane] = ra[q].y;
      Bs[(warp + 16 * q) * G::SB + lane] = rb[q].x;
      Bs[(warp + 16 * q + 8) * G::SB + lane] = rb[q].y;
    }
    __syncthreads();
    if (r0 + G::BK < end) load(r0 + G::BK);
    warp_tile<G>(acc, As, Bs, wm0, wn0, lane);
    __syncthreads();
  }

  const int g = lane >> 2, t2 = 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < G::MT; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int o = m0 + wm0 + i * 16 + g + half * 8;
      float* row = parts + (static_cast<size_t>(p) * cout + o) * 3 * cin + j * cin + c0;
#pragma unroll
      for (int jj = 0; jj < G::NT; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) row[wn0 + jj * 8 + t2 + e] = acc[i][jj][2 * half + e];
    }
}

// dw[o, c, j] = sum over p (in order) of parts[p, o, j * Cin + c], in the weight's dtype.
template <typename T>
__global__ void conv_gelu_dw_reduce_kernel(const float* __restrict__ parts, T* __restrict__ dw,
                                           int n_parts, int cin, int cout) {
  const long long n = static_cast<long long>(cout) * cin * 3;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long o = i / (3 * cin), rest = i - o * 3 * cin;
    const long long c = rest / 3, j = rest - c * 3;
    const float* src = parts + o * 3 * cin + j * cin + c;
    float sum = 0.f;
    for (int p = 0; p < n_parts; ++p) sum += src[static_cast<long long>(p) * cout * 3 * cin];
    store(dw + i, sum);
  }
}

// ---- bfloat16 bodies: the frame view and three GEMMs on wgmma (wgmma_tile.cuh) ------------

using bf16 = __nv_bfloat16;
using w2v::kGemmBK;
using w2v::kGemmBM;
using w2v::kGemmBN;
using Acc = float[w2v::kGemmAcc];
using KMajor = w2v::WgmmaTiling<false>;         // forward (wr, xf) and dx (wx, dpre_t)
using MNMajor = w2v::WgmmaTiling<true, true>;   // dW: dpre_t M-major, xf N-major
constexpr int kLd = w2v::kStageLd;
constexpr int kTr = 64;                         // a transpose block: 64 channels x 64 frames
constexpr int kPackFrames = 64;                 // frames of a pack block
constexpr int kTrThreads = 256;

__device__ __forceinline__ uint32_t bits(bf16 v) { return __bfloat16_as_ushort(v); }

// xf[b, u, j Cin + c] = x[b, c, 2u + j] (0 past T) for u < frames = out_len + 1. A block
// takes kPackFrames frames x 64 channels: each warp reads channel rows (a warp's two loads
// cover 128 contiguous bytes), the pairs (x[2u], x[2u + 1]) go through shared memory as one
// 32-bit word each, and each thread writes 8 channels of a frame's even and odd halves as
// two 16-byte stores.
__global__ void __launch_bounds__(kTrThreads)
conv_pack_kernel(const bf16* __restrict__ x, bf16* __restrict__ xf, int cin, int tin,
                 int frames) {
  __shared__ uint32_t tile[kTr][kPackFrames + 1];   // [c][u]
  const int u0 = blockIdx.x * kPackFrames, c0 = blockIdx.y * kTr, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < kTr; r += kTrThreads / 32) {
    const bf16* row = x + (static_cast<size_t>(b) * cin + c0 + r) * tin;
#pragma unroll
    for (int q = lane; q < kPackFrames; q += 32) {
      const int s = 2 * (u0 + q);
      const uint32_t lo = s < tin ? bits(row[s]) : 0u, hi = s + 1 < tin ? bits(row[s + 1]) : 0u;
      tile[r][q] = lo | hi << 16;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kPackFrames * kTr / 8; i += kTrThreads) {
    const int cg = i % (kTr / 8), q = i / (kTr / 8);
    if (u0 + q >= frames) break;
    uint32_t w[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) w[e] = tile[8 * cg + e][q];
    const uint4 even = make_uint4(__byte_perm(w[0], w[1], 0x5410), __byte_perm(w[2], w[3], 0x5410),
                                  __byte_perm(w[4], w[5], 0x5410), __byte_perm(w[6], w[7], 0x5410));
    const uint4 odd = make_uint4(__byte_perm(w[0], w[1], 0x7632), __byte_perm(w[2], w[3], 0x7632),
                                 __byte_perm(w[4], w[5], 0x7632), __byte_perm(w[6], w[7], 0x7632));
    bf16* dst = xf + (static_cast<size_t>(b) * frames + u0 + q) * 2 * cin + c0 + 8 * cg;
    *reinterpret_cast<uint4*>(dst) = even;
    *reinterpret_cast<uint4*>(dst + cin) = odd;
  }
}

// dpre_t[b, t, o] = round(g[b, o, t] gelu'(pre[b, o, t])) for t < out_len, 0 up to the
// padded frame count: the gradient taken at the rounded pre (in the plain version's order of
// operations: the same bits), channels last, through shared memory as the pack (each thread
// writes 8 outputs o of one frame as a 16-byte store).
__global__ void __launch_bounds__(kTrThreads)
conv_dpre_kernel(const bf16* __restrict__ g, const bf16* __restrict__ pre,
                 bf16* __restrict__ dpre_t, int cout, int out_len, int frames_pad) {
  // frames_pad is a multiple of kTr: every block's 64 frames are stored.
  __shared__ bf16 tile[kTr][kTr + 2];            // [o][t]
  const int t0 = blockIdx.x * kTr, o0 = blockIdx.y * kTr, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < kTr; r += kTrThreads / 32) {
    const size_t row = (static_cast<size_t>(b) * cout + o0 + r) * out_len;
#pragma unroll
    for (int q = lane; q < kTr; q += 32) {
      const int t = t0 + q;
      const float d = t < out_len ? __fmul_rn(__bfloat162float(g[row + t]),
                                              w2v::gelu_erf_grad_rn(__bfloat162float(pre[row + t])))
                                  : 0.f;
      tile[r][q] = __float2bfloat16(d);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kTr * kTr / 8; i += kTrThreads) {
    const int og = i % (kTr / 8), q = i / (kTr / 8);
    uint32_t w[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      w[e] = bits(tile[8 * og + 2 * e][q]) | bits(tile[8 * og + 2 * e + 1][q]) << 16;
    *reinterpret_cast<uint4*>(dpre_t + (static_cast<size_t>(b) * frames_pad + t0 + q) * cout + o0 +
                              8 * og) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// f(sum) of the calling warpgroup's 64 rows, rounded to bf16, into its group's staging tile
// [128][kLd] (4-byte stores: the 8 rows x 4 pairs of a warp's store hit 32 banks).
template <class F>
__device__ __forceinline__ void stage(bf16* tile, const Acc& acc, F f) {
  const int lane = threadIdx.x & 31;
  const int r = (w2v::group_thread() / 128) * 64 + ((threadIdx.x / 32) & 3) * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < w2v::kGemmBN / 8; ++j) {
    const int c = 8 * j + 2 * (lane & 3);
    *reinterpret_cast<__nv_bfloat162*>(tile + r * kLd + c) =
        __floats2bfloat162_rn(f(acc[4 * j]), f(acc[4 * j + 1]));
    *reinterpret_cast<__nv_bfloat162*>(tile + (r + 8) * kLd + c) =
        __floats2bfloat162_rn(f(acc[4 * j + 2]), f(acc[4 * j + 3]));
  }
}

// The staged tile [kRows][kTileLd]'s row r, columns 0 .. cols - 1, to dst + r * ld +
// column: warp w of the group takes rows w, w + 8, ..., its lanes 32 consecutive columns a
// store (64 contiguous bytes).
template <int kRows, int kCols, int kTileLd>
__device__ __forceinline__ void write_rows(const bf16* tile, bf16* __restrict__ dst, size_t ld,
                                           int cols) {
  const int warp = w2v::group_thread() / 32, lane = threadIdx.x & 31;
#pragma unroll 4
  for (int r = warp; r < kRows; r += w2v::kGemmGroup / 32)
#pragma unroll
    for (int c = lane; c < kCols; c += 32)
      if (c < cols) dst[r * ld + c] = tile[r * kTileLd + c];
}

// Forward tiles: per batch ceil(out_len / 128) frame tiles, each taken by the Cout / 128 row
// tiles in turn (row tiles fastest: the blocks that share a frame tile run together and
// read it once from device memory).
struct FwdSchedule {
  int m_tiles, f_tiles, tiles, k_tiles, k_pair, frames;   // k_pair: k steps of taps 0, 1
  __device__ __forceinline__ int steps(int) const { return k_tiles; }
  __device__ __forceinline__ bool mma(int, int, int) const { return true; }
  __device__ __forceinline__ int m0(int t) const { return t % m_tiles * kGemmBM; }
  __device__ __forceinline__ int t0(int t) const { return t / m_tiles % f_tiles * kGemmBN; }
  __device__ __forceinline__ int batch(int t) const { return t / m_tiles / f_tiles; }
  __device__ __forceinline__ int2 a(int t, int kt) const { return make_int2(kt * kGemmBK, m0(t)); }
  __device__ __forceinline__ int2 b(int t, int kt) const {
    const int row = batch(t) * frames + t0(t);           // xf row of the tile's first frame
    return kt < k_pair ? make_int2(kt * kGemmBK, row) : make_int2((kt - k_pair) * kGemmBK, row + 1);
  }
};

// out, pre [B, Cout, out_len] = gelu(y), y from the maps of wr [Cout, 3 Cin] and
// xf [B (out_len + 1), 2 Cin] (boxes of 128 rows).
__global__ void __launch_bounds__(w2v::kGemmThreads, 1)
conv_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap mw,
                      const __grid_constant__ CUtensorMap mx, bf16* __restrict__ out,
                      bf16* __restrict__ pre, int cout, int out_len, const FwdSchedule sched) {
  extern __shared__ unsigned char smem_raw[];
  const w2v::GemmSmem<KMajor> sm(smem_raw);
  w2v::gemm_run(sm, &mw, &mx, sched, [&](const Acc& acc, int g, int t) {
    const int t0 = sched.t0(t), cols = min(kGemmBN, out_len - t0);
    const size_t first = (static_cast<size_t>(sched.batch(t)) * cout + sched.m0(t)) * out_len + t0;
    bf16* tile = sm.staging(g);
    w2v::group_sync(g);                          // the group's previous tile is written
    stage(tile, acc, [](float y) { return y; });
    w2v::group_sync(g);
    write_rows<kGemmBM, kGemmBN, kLd>(tile, pre + first, out_len, cols);
    w2v::group_sync(g);
    stage(tile, acc, [](float y) { return w2v::gelu_erf<true>(y); });
    w2v::group_sync(g);
    write_rows<kGemmBM, kGemmBN, kLd>(tile, out + first, out_len, cols);
  });
}

// dx tiles: per batch ceil((out_len + 1) / 128) tiles of 128 pairs u, each taken by the
// Cin / 64 channel tiles in turn (fastest). A tile's two warpgroups share its 64 channels:
// warpgroup 0 sums the even rows 2u (tap 0 at frame u, tap 2 at u - 1), warpgroup 1 the odd
// rows 2u + 1 (tap 1 at u). Its k steps alternate a step of taps 0 and 1 (A: the tile's
// rows of w0^T over those of w1^T, B: dpre_t at frames u) and a step of tap 2 (A: its rows
// of w2^T, B: frames u - 1), in which warpgroup 1 idles. The weight arrives as wx
// [Cin / 64][3][64][Cout], so each A box is 128 consecutive rows.
struct DxSchedule {
  int m_tiles, u_tiles, tiles, k_o, frames_pad;          // k_o: k steps of one tap
  __device__ __forceinline__ int steps(int) const { return 2 * k_o; }
  __device__ __forceinline__ bool mma(int, int kt, int wg) const { return wg == 0 || !(kt & 1); }
  __device__ __forceinline__ int m_tile(int t) const { return t % m_tiles; }
  __device__ __forceinline__ int u0(int t) const { return t / m_tiles % u_tiles * kGemmBN; }
  __device__ __forceinline__ int batch(int t) const { return t / m_tiles / u_tiles; }
  __device__ __forceinline__ int2 a(int t, int kt) const {
    return make_int2(kt / 2 * kGemmBK, m_tile(t) * 3 * 64 + (kt & 1) * 2 * 64);
  }
  __device__ __forceinline__ int2 b(int t, int kt) const {
    return make_int2(kt / 2 * kGemmBK, batch(t) * frames_pad + u0(t) - (kt & 1));
  }
};

constexpr int kDxLd = 2 * kGemmBN + 8;          // a dx staging row: 256 outputs and a pad
static_assert(64 * kDxLd * 2 <= KMajor::STAGING_BYTES, "dx staging tile");

// dx [B, Cin, T] from the maps of wx and dpre_t [B P, Cout] (boxes of 128 rows): each
// warpgroup stages its rows' sums interleaved (row 2u + wg at column 2 (u - u0) + wg), and
// the tile's 64 channels are written as runs of 256 outputs, each below T.
__global__ void __launch_bounds__(w2v::kGemmThreads, 1)
conv_dx_wgmma_kernel(const __grid_constant__ CUtensorMap mw,
                     const __grid_constant__ CUtensorMap md, bf16* __restrict__ dx, int cin,
                     int tin, const DxSchedule sched) {
  extern __shared__ unsigned char smem_raw[];
  const w2v::GemmSmem<KMajor> sm(smem_raw);
  w2v::gemm_run(sm, &mw, &md, sched, [&](const Acc& acc, int g, int t) {
    const int s0 = 2 * sched.u0(t), lane = threadIdx.x & 31, wg = w2v::group_thread() / 128;
    const size_t first =
        (static_cast<size_t>(sched.batch(t)) * cin + sched.m_tile(t) * 64) * tin + s0;
    bf16* tile = sm.staging(g);
    w2v::group_sync(g);
    const int r = ((threadIdx.x / 32) & 3) * 16 + (lane >> 2);
#pragma unroll
    for (int j = 0; j < w2v::kGemmBN / 8; ++j) {
      const int c = 2 * (8 * j + 2 * (lane & 3)) + wg;
      tile[r * kDxLd + c] = __float2bfloat16(acc[4 * j]);
      tile[r * kDxLd + c + 2] = __float2bfloat16(acc[4 * j + 1]);
      tile[(r + 8) * kDxLd + c] = __float2bfloat16(acc[4 * j + 2]);
      tile[(r + 8) * kDxLd + c + 2] = __float2bfloat16(acc[4 * j + 3]);
    }
    w2v::group_sync(g);
    write_rows<64, 2 * kGemmBN, kDxLd>(tile, dx + first, tin, tin - s0);
  });
}

// dW tiles: P ranges of the B P / 64 (batch, 64-frame) k steps, each range taken by the
// (Cout / 128) x (3 Cin / 128) output tiles (row tiles fastest); the last range may be
// shorter.
struct DwSchedule {
  int m_tiles, n_tiles, tiles, chunk, total, spb;        // spb: k steps a batch
  int cin, frames, frames_pad;
  __device__ __forceinline__ int part(int t) const { return t / (m_tiles * n_tiles); }
  __device__ __forceinline__ int steps(int t) const { return min(chunk, total - part(t) * chunk); }
  __device__ __forceinline__ bool mma(int, int, int) const { return true; }
  __device__ __forceinline__ int m0(int t) const { return t % m_tiles * kGemmBM; }
  __device__ __forceinline__ int n0(int t) const { return t / m_tiles % n_tiles * kGemmBN; }
  __device__ __forceinline__ int2 a(int t, int kt) const {
    const int s = part(t) * chunk + kt;
    return make_int2(m0(t), s / spb * frames_pad + s % spb * kGemmBK);
  }
  __device__ __forceinline__ int2 b(int t, int kt) const {
    const int s = part(t) * chunk + kt, n = n0(t);
    const int row = s / spb * frames + s % spb * kGemmBK;
    return n < 2 * cin ? make_int2(n, row) : make_int2(n - 2 * cin, row + 1);
  }
};

// Float32 partials parts[p, o, k] of dW_r = dpre^T xf over range p, from the maps of dpre_t
// and xf (boxes of 64 rows), written from the accumulators (8-byte stores).
__global__ void __launch_bounds__(w2v::kGemmThreads, 1)
conv_dw_wgmma_kernel(const __grid_constant__ CUtensorMap md,
                     const __grid_constant__ CUtensorMap mx, float* __restrict__ parts, int cout,
                     const DwSchedule sched) {
  extern __shared__ unsigned char smem_raw[];
  const w2v::GemmSmem<MNMajor> sm(smem_raw);
  w2v::gemm_run(sm, &md, &mx, sched, [&](const Acc& acc, int, int t) {
    const int lane = threadIdx.x & 31;
    const int r = sched.m0(t) + (w2v::group_thread() / 128) * 64 + ((threadIdx.x / 32) & 3) * 16 +
                  (lane >> 2);
    float* row = parts + (static_cast<size_t>(sched.part(t)) * cout + r) * 3 * sched.cin +
                 sched.n0(t) + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < w2v::kGemmBN / 8; ++j) {
      *reinterpret_cast<float2*>(row + 8 * j) = make_float2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<float2*>(row + 8 * static_cast<size_t>(3 * sched.cin) + 8 * j) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
  });
}

template <typename K>
cudaError_t set_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

constexpr int kElemThreads = 256;

int blocks_for(long long n) {
  const long long b = (n + kElemThreads - 1) / kElemThreads;
  return static_cast<int>(b < 4096 ? b : 4096);
}

int sm_count() {
  int device = 0, sms = 132;
  if (cudaGetDevice(&device) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  return sms;
}

// The persistent grid of a wgmma kernel: one block an SM, no more blocks than tiles.
int persistent(int tiles) { return tiles < sm_count() ? tiles : sm_count(); }

int fwd_f32(const float* x, const float* w, float* out, float* pre, int batch, int cin, int tin,
            int cout, int out_len, cudaStream_t st) {
  using G = FwdTile<float>;
  auto kernel = conv_gelu_fwd_kernel<float>;
  cudaError_t err = set_smem(kernel, fwd_smem<float>());
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3((out_len + G::BN - 1) / G::BN, cout / G::BM, batch), kThreads, fwd_smem<float>(),
           st>>>(x, w, out, pre, cin, tin, cout, out_len);
  return static_cast<int>(cudaGetLastError());
}

int reduce_dw(const float* parts, void* dw, int n_parts, int cin, int cout, bool bf16_out,
              cudaStream_t st) {
  const int blocks = blocks_for(static_cast<long long>(cout) * cin * 3);
  if (bf16_out)
    conv_gelu_dw_reduce_kernel<bf16><<<blocks, kElemThreads, 0, st>>>(
        parts, static_cast<bf16*>(dw), n_parts, cin, cout);
  else
    conv_gelu_dw_reduce_kernel<float><<<blocks, kElemThreads, 0, st>>>(
        parts, static_cast<float*>(dw), n_parts, cin, cout);
  return static_cast<int>(cudaGetLastError());
}

int bwd_f32(const float* x, const float* wt, const float* pre, const float* g, float* dpre,
            float* dx, float* parts, float* dw, int batch, int cin, int tin, int cout,
            int out_len, int n_parts, bool need_dx, bool need_dw, cudaStream_t st) {
  const long long n = static_cast<long long>(batch) * cout * out_len;
  conv_gelu_dpre_kernel<float><<<blocks_for(n), kElemThreads, 0, st>>>(g, pre, dpre, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (need_dx) {
    using G = DxTile<float>;
    auto kernel = conv_gelu_dx_kernel<float>;
    err = set_smem(kernel, dx_smem<float>());
    if (err != cudaSuccess) return static_cast<int>(err);
    const int pairs = (tin + 1) / 2;
    kernel<<<dim3((pairs + G::BN - 1) / G::BN, cin / G::BM, batch), kThreads, dx_smem<float>(),
             st>>>(dpre, wt, dx, cin, tin, cout, out_len);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (need_dw) {
    using G = DwTile<float>;
    auto kernel = conv_gelu_dw_kernel<float>;
    err = set_smem(kernel, G::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long total = static_cast<long long>(batch) * out_len;
    const int chunk = static_cast<int>((total + n_parts - 1) / n_parts);
    kernel<<<dim3(3 * cin / G::BN, cout / G::BM, n_parts), kThreads, G::SMEM, st>>>(
        dpre, x, parts, batch, cin, tin, cout, out_len, chunk);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    return reduce_dw(parts, dw, n_parts, cin, cout, false, st);
  }
  return static_cast<int>(err);
}

int pack_bf16(const bf16* x, bf16* xf, int batch, int cin, int tin, int out_len,
              cudaStream_t st) {
  const int frames = out_len + 1;
  conv_pack_kernel<<<dim3((frames + kPackFrames - 1) / kPackFrames, cin / kTr, batch),
                     kTrThreads, 0, st>>>(x, xf, cin, tin, frames);
  return static_cast<int>(cudaGetLastError());
}

int fwd_bf16(const bf16* xf, const bf16* wr, bf16* out, bf16* pre, int batch, int cin, int cout,
             int out_len, cudaStream_t st) {
  const int frames = out_len + 1;
  CUtensorMap mw, mx;
  if (!w2v::tensor_map(&mw, wr, cout, 3 * cin, kGemmBM) ||
      !w2v::tensor_map(&mx, xf, batch * frames, 2 * cin, kGemmBN))
    return static_cast<int>(cudaErrorInvalidValue);
  FwdSchedule sched{cout / kGemmBM, (out_len + kGemmBN - 1) / kGemmBN, 0, 3 * cin / kGemmBK,
                    2 * cin / kGemmBK, frames};
  sched.tiles = sched.m_tiles * sched.f_tiles * batch;
  const cudaError_t err = set_smem(conv_fwd_wgmma_kernel, KMajor::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  conv_fwd_wgmma_kernel<<<persistent(sched.tiles), w2v::kGemmThreads, KMajor::SMEM, st>>>(
      mw, mx, out, pre, cout, out_len, sched);
  return static_cast<int>(cudaGetLastError());
}

int bwd_bf16(const bf16* xf, const bf16* wx, const bf16* pre, const bf16* g, bf16* dpre_t,
             bf16* dx, float* parts, bf16* dw, int batch, int cin, int tin, int cout, int out_len,
             int frames_pad, int n_parts, bool need_dx, bool need_dw, cudaStream_t st) {
  const int frames = out_len + 1;
  conv_dpre_kernel<<<dim3(frames_pad / kTr, cout / kTr, batch), kTrThreads, 0, st>>>(
      g, pre, dpre_t, cout, out_len, frames_pad);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (need_dx) {
    CUtensorMap mw, md;
    if (!w2v::tensor_map(&mw, wx, 3 * cin, cout, kGemmBM) ||
        !w2v::tensor_map(&md, dpre_t, batch * frames_pad, cout, kGemmBN))
      return static_cast<int>(cudaErrorInvalidValue);
    DxSchedule sched{cin / 64, (frames + kGemmBN - 1) / kGemmBN, 0, cout / kGemmBK, frames_pad};
    sched.tiles = sched.m_tiles * sched.u_tiles * batch;
    err = set_smem(conv_dx_wgmma_kernel, KMajor::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    conv_dx_wgmma_kernel<<<persistent(sched.tiles), w2v::kGemmThreads, KMajor::SMEM, st>>>(
        mw, md, dx, cin, tin, sched);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (need_dw) {
    CUtensorMap md, mx;                          // boxes of 64 k rows x 64 columns
    if (!w2v::tensor_map(&md, dpre_t, batch * frames_pad, cout, kGemmBK) ||
        !w2v::tensor_map(&mx, xf, batch * frames, 2 * cin, kGemmBK))
      return static_cast<int>(cudaErrorInvalidValue);
    const int spb = frames_pad / kGemmBK, total = batch * spb;
    const int chunk = (total + n_parts - 1) / n_parts, parts_used = (total + chunk - 1) / chunk;
    DwSchedule sched{cout / kGemmBM, 3 * cin / kGemmBN, 0, chunk, total, spb, cin, frames,
                     frames_pad};
    sched.tiles = parts_used * sched.m_tiles * sched.n_tiles;
    err = set_smem(conv_dw_wgmma_kernel, MNMajor::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    conv_dw_wgmma_kernel<<<persistent(sched.tiles), w2v::kGemmThreads, MNMajor::SMEM, st>>>(
        md, mx, parts, cout, sched);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    return reduce_dw(parts, dw, parts_used, cin, cout, true, st);
  }
  return static_cast<int>(err);
}

bool bad_shape(int batch, int cin, int tin, int cout, int out_len) {
  return batch <= 0 || cin <= 0 || cout <= 0 || cin % 128 || cout % 128 || tin < 3 ||
         out_len != (tin - 3) / 2 + 1;
}

}  // namespace

// C entry points, bound with ctypes. Cin and Cout must be multiples of 128 and
// out_len = (Tin - 3) / 2 + 1. Each returns the cudaError_t of its launches (0 = launched);
// the caller raises on anything else.

// Float32: x [B, Cin, Tin], w [Cout, Cin, 3] -> out, pre [B, Cout, out_len].
extern "C" int conv_gelu_fwd_f32(const void* x, const void* w, void* out, void* pre, int batch,
                                 int cin, int tin, int cout, int out_len, void* stream) {
  if (bad_shape(batch, cin, tin, cout, out_len)) return static_cast<int>(cudaErrorInvalidValue);
  return fwd_f32(static_cast<const float*>(x), static_cast<const float*>(w),
                 static_cast<float*>(out), static_cast<float*>(pre), batch, cin, tin, cout,
                 out_len, static_cast<cudaStream_t>(stream));
}

// Float32 backward: from x, wt = w re-laid as [3, Cin, Cout], pre and the cotangent g of out,
// the kernels write dpre [B, Cout, out_len] (scratch), dx [B, Cin, Tin] (need_dx) and
// dw [Cout, Cin, 3] (need_dw, through the float32 partials [n_parts, Cout, 3 Cin]).
extern "C" int conv_gelu_bwd_f32(const void* x, const void* wt, const void* pre, const void* g,
                                 void* dpre, void* dx, void* parts, void* dw, int batch, int cin,
                                 int tin, int cout, int out_len, int n_parts, int need_dx,
                                 int need_dw, void* stream) {
  if (bad_shape(batch, cin, tin, cout, out_len) || n_parts <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return bwd_f32(static_cast<const float*>(x), static_cast<const float*>(wt),
                 static_cast<const float*>(pre), static_cast<const float*>(g),
                 static_cast<float*>(dpre), static_cast<float*>(dx), static_cast<float*>(parts),
                 static_cast<float*>(dw), batch, cin, tin, cout, out_len, n_parts, need_dx != 0,
                 need_dw != 0, static_cast<cudaStream_t>(stream));
}

// bfloat16, every pointer 16-byte aligned. The frame view: x [B, Cin, Tin] ->
// xf [B, out_len + 1, 2 Cin].
extern "C" int conv_gelu_pack_bf16(const void* x, void* xf, int batch, int cin, int tin,
                                   int out_len, void* stream) {
  if (bad_shape(batch, cin, tin, 128, out_len)) return static_cast<int>(cudaErrorInvalidValue);
  return pack_bf16(static_cast<const bf16*>(x), static_cast<bf16*>(xf), batch, cin, tin, out_len,
                   static_cast<cudaStream_t>(stream));
}

// Forward from the frame view and wr = w re-laid as [Cout, 3 Cin] (k = tap Cin + c):
// out, pre [B, Cout, out_len].
extern "C" int conv_gelu_fwd_bf16(const void* xf, const void* wr, void* out, void* pre, int batch,
                                  int cin, int tin, int cout, int out_len, void* stream) {
  if (bad_shape(batch, cin, tin, cout, out_len)) return static_cast<int>(cudaErrorInvalidValue);
  return fwd_bf16(static_cast<const bf16*>(xf), static_cast<const bf16*>(wr),
                  static_cast<bf16*>(out), static_cast<bf16*>(pre), batch, cin, cout, out_len,
                  static_cast<cudaStream_t>(stream));
}

// Backward from the frame view, wx (w re-laid as [Cin / 64][3][64][Cout]: row
// 192 m + 64 j + i is tap j of channel 64 m + i), pre and g: dpre_t [B, frames_pad, Cout]
// (scratch; frames_pad = out_len + 1 rounded up to 64), dx [B, Cin, Tin] (need_dx) and
// dw [Cout, Cin, 3] (need_dw, through float32 partials [n_parts, Cout, 3 Cin]; the ranges are
// ceil(B frames_pad / 64 / n_parts) k steps each, so fewer may be used). need_dx = need_dw = 0
// runs the dpre pass alone.
extern "C" int conv_gelu_bwd_bf16(const void* xf, const void* wx, const void* pre, const void* g,
                                  void* dpre_t, void* dx, void* parts, void* dw, int batch,
                                  int cin, int tin, int cout, int out_len, int frames_pad,
                                  int n_parts, int need_dx, int need_dw, void* stream) {
  if (bad_shape(batch, cin, tin, cout, out_len) || n_parts <= 0 || frames_pad % 64 ||
      frames_pad < out_len + 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return bwd_bf16(static_cast<const bf16*>(xf), static_cast<const bf16*>(wx),
                  static_cast<const bf16*>(pre), static_cast<const bf16*>(g),
                  static_cast<bf16*>(dpre_t), static_cast<bf16*>(dx), static_cast<float*>(parts),
                  static_cast<bf16*>(dw), batch, cin, tin, cout, out_len, frames_pad, n_parts,
                  need_dx != 0, need_dw != 0, static_cast<cudaStream_t>(stream));
}

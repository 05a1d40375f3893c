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
//             erf GELU (gelu.cuh's rational erf, the JAX kernel's _gelu_exact) in every dtype.
//   backward: dpre = round_T(g * gelu'(pre)) (the gradient taken at the rounded pre);
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
// from conv_time_plan's padding; here the layout is channels-first with exact, odd lengths
// (a row of x starts at any 2-byte offset), so the design is three GEMMs over mma.sync
// m16n8k16 bf16 tiles (mma_tile.cuh; float32 is the same tiling in FMAs) whose "data"
// operand is gathered through registers into shared memory, with every block edge guarded:
//   * forward: M = Cout (128), N = frames (128), K = (c, j) in steps of 16 channels x 3
//     taps. The weight tile is a cp.async copy of w's contiguous [o, 3c + j] rows; the
//     frame tile is built from the 257 input samples the 128 frames read, each channel's
//     even samples written to its tap-0 and (one frame earlier) tap-2 rows, its odd samples
//     to its tap-1 row (an in-shared-memory im2col, ldmatrix.trans reads it). The epilogue
//     writes pre and out.
//   * dpre: one elementwise pass (g, pre -> dpre), so the two products read it once each
//     instead of recomputing the erf per tile.
//   * dx: M = Cin (128), N = 64 output pairs u (rows 2u and 2u + 1), K = Cout in steps of
//     32, two accumulators: even rows take w0^T dpre[u] + w2^T dpre[u - 1], odd rows
//     w1^T dpre[u]. The weight arrives re-laid as wt [3][Cin][Cout] (a 1.5 MB copy by the
//     caller); dpre is staged twice, at u and shifted by one frame.
//   * dw: M = Cout (128), N = Cin of one tap (128), K = the rows (b, t) of one of P ranges
//     in steps of 32, written as float32 partials [P, Cout, 3 Cin]; a last pass sums the P
//     partials in a fixed order into dw [Cout, Cin, 3] in the weight's dtype.
// The data tiles are gathered with scalar loads (odd lengths break 16-byte alignment) into
// registers one k step ahead, two bf16 values to a register, so their latency hides behind
// the previous step's products; the weight tiles are double-buffered cp.async copies; in
// bf16 every kernel fits 128 registers, so two blocks share an SM. TMA/wgmma, vector loads
// and channels-last staging are the later steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "gelu.cuh"
#include "mma_tile.cuh"

namespace {

constexpr int kThreads = w2v::kTileThreads;
using w2v::cp_async_commit;
using w2v::cp_async_wait;
using w2v::load_tile;
using w2v::store;
using w2v::Tiling;
using w2v::to_float;
using w2v::warp_tile;

constexpr int kFwdChannels = 16;                 // input channels per forward k step

template <typename T>
using FwdTile = Tiling<T, 128, 128, 3 * kFwdChannels, 64, 32, true, 1>;
template <typename T>
using DxTile = Tiling<T, 128, 64, 32, 32, 32, true, 1>;
template <typename T>
using DwTile = Tiling<T, 128, 128, 32, 64, 32, false, 1>;

// A pair of values of T in one register (bf16) or two (float32): the forward's prefetch.
template <typename T> struct PairOf;
template <> struct PairOf<float> { using type = float2; };
template <> struct PairOf<__nv_bfloat16> { using type = __nv_bfloat162; };

// Two blocks per SM in bf16 (registers capped at 128 a thread), one in float32, whose
// FMA tiles need more.
template <typename T>
constexpr int kMinBlocks = sizeof(T) == 2 ? 2 : 1;

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

template <typename K>
cudaError_t set_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

constexpr int kElemThreads = 256;

int blocks_for(long long n) {
  const long long b = (n + kElemThreads - 1) / kElemThreads;
  return static_cast<int>(b < 4096 ? b : 4096);
}

template <typename T>
int fwd(const T* x, const T* w, T* out, T* pre, int batch, int cin, int tin, int cout,
        int out_len, cudaStream_t st) {
  using G = FwdTile<T>;
  auto kernel = conv_gelu_fwd_kernel<T>;
  cudaError_t err = set_smem(kernel, fwd_smem<T>());
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3((out_len + G::BN - 1) / G::BN, cout / G::BM, batch), kThreads, fwd_smem<T>(),
           st>>>(x, w, out, pre, cin, tin, cout, out_len);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int bwd(const T* x, const T* wt, const T* pre, const T* g, T* dpre, T* dx, float* parts, T* dw,
        int batch, int cin, int tin, int cout, int out_len, int n_parts, bool need_dx,
        bool need_dw, cudaStream_t st) {
  const long long n = static_cast<long long>(batch) * cout * out_len;
  conv_gelu_dpre_kernel<T><<<blocks_for(n), kElemThreads, 0, st>>>(g, pre, dpre, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (need_dx) {
    using G = DxTile<T>;
    auto kernel = conv_gelu_dx_kernel<T>;
    err = set_smem(kernel, dx_smem<T>());
    if (err != cudaSuccess) return static_cast<int>(err);
    const int pairs = (tin + 1) / 2;
    kernel<<<dim3((pairs + G::BN - 1) / G::BN, cin / G::BM, batch), kThreads, dx_smem<T>(),
             st>>>(dpre, wt, dx, cin, tin, cout, out_len);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (need_dw) {
    using G = DwTile<T>;
    auto kernel = conv_gelu_dw_kernel<T>;
    err = set_smem(kernel, G::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long total = static_cast<long long>(batch) * out_len;
    const int chunk = static_cast<int>((total + n_parts - 1) / n_parts);
    kernel<<<dim3(3 * cin / G::BN, cout / G::BM, n_parts), kThreads, G::SMEM, st>>>(
        dpre, x, parts, batch, cin, tin, cout, out_len, chunk);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    conv_gelu_dw_reduce_kernel<T><<<blocks_for(static_cast<long long>(cout) * cin * 3),
                                    kElemThreads, 0, st>>>(parts, dw, n_parts, cin, cout);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}

bool bad_shape(int batch, int cin, int tin, int cout, int out_len) {
  return batch <= 0 || cin <= 0 || cout <= 0 || cin % 128 || cout % 128 || tin < 3 ||
         out_len != (tin - 3) / 2 + 1;
}

}  // namespace

// C entry points, bound with ctypes. dtype: 0 = float32, 1 = bfloat16 for x, w, wt, out,
// pre, g, dpre, dx and dw; parts is float32 scratch [n_parts, Cout, 3 Cin]. Cin and Cout
// must be multiples of 128 and out_len = (Tin - 3) / 2 + 1. Each returns the cudaError_t of
// its launches (0 = launched); the caller raises on anything else.

// Forward: x [B, Cin, Tin], w [Cout, Cin, 3] -> out, pre [B, Cout, out_len].
extern "C" int conv_gelu_fwd(const void* x, const void* w, void* out, void* pre, int batch,
                             int cin, int tin, int cout, int out_len, int dtype, void* stream) {
  if (bad_shape(batch, cin, tin, cout, out_len)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return fwd<float>(static_cast<const float*>(x), static_cast<const float*>(w),
                        static_cast<float*>(out), static_cast<float*>(pre), batch, cin, tin,
                        cout, out_len, st);
    case 1:
      return fwd<__nv_bfloat16>(static_cast<const __nv_bfloat16*>(x),
                                static_cast<const __nv_bfloat16*>(w),
                                static_cast<__nv_bfloat16*>(out), static_cast<__nv_bfloat16*>(pre),
                                batch, cin, tin, cout, out_len, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Backward: from x, wt = w re-laid as [3, Cin, Cout], pre and the cotangent g of out, the
// kernels write dpre [B, Cout, out_len] (scratch), dx [B, Cin, Tin] (need_dx) and
// dw [Cout, Cin, 3] (need_dw, through parts).
extern "C" int conv_gelu_bwd(const void* x, const void* wt, const void* pre, const void* g,
                             void* dpre, void* dx, void* parts, void* dw, int batch, int cin,
                             int tin, int cout, int out_len, int n_parts, int need_dx,
                             int need_dw, int dtype, void* stream) {
  if (bad_shape(batch, cin, tin, cout, out_len) || n_parts <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pp = static_cast<float*>(parts);
  switch (dtype) {
    case 0:
      return bwd<float>(static_cast<const float*>(x), static_cast<const float*>(wt),
                        static_cast<const float*>(pre), static_cast<const float*>(g),
                        static_cast<float*>(dpre), static_cast<float*>(dx), pp,
                        static_cast<float*>(dw), batch, cin, tin, cout, out_len, n_parts,
                        need_dx != 0, need_dw != 0, st);
    case 1:
      return bwd<__nv_bfloat16>(
          static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(wt),
          static_cast<const __nv_bfloat16*>(pre), static_cast<const __nv_bfloat16*>(g),
          static_cast<__nv_bfloat16*>(dpre), static_cast<__nv_bfloat16*>(dx), pp,
          static_cast<__nv_bfloat16*>(dw), batch, cin, tin, cout, out_len, n_parts,
          need_dx != 0, need_dw != 0, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

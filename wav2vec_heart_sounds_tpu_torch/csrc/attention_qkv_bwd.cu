// Attention backward for NVIDIA Hopper (sm_90a), with attention dropout: one kernel body for
// the packed-QKV (K3b) and the unpacked (K3a) routes.
//
// Replaces the TPU kernels wav2vec_heart_sounds_tpu/ops/pallas/attention.py::_packed_bwd
// (K3b backward) and ::_flash_bwd (K3a backward; K3a computes exactly K3b's function). From
// q, k, v, the forward's output o, the output cotangent do and the forward's row
// log-sum-exp lse ([B, H, T] float32, contiguous), it writes dq, dk and dv. Every one of
// these eight tensors is a [B, H, T, d] view given by its base pointer and element strides
// over (b, h, t), d contiguous, rows 16-byte aligned: the thirds of one packed tensor and of
// one packed gradient (K3b, contiguous [B, 3H, T, d] or the head view of [B, T, 3H, d]), or
// separate tensors and head views of [B, T, H, d] ones (K3a). With p the probabilities
// recomputed as exp(q.k * scale - lse) (keys >= t_keys masked), keep the Philox mask the
// forward drew at index ((b*H + h)*T + q)*T + k (philox.cuh, whatever the strides) and c
// the dropout scale 1 / (1 - rate):
//
//     dv_k = sum_q keep c p_qk do_q            dp_qk = keep ? c (do_q . v_k) : 0
//     D_q  = do_q . o_q  (= sum_k dp_qk p_qk, since o is the dropped output)
//     ds_qk = p_qk (dp_qk - D_q)               dq_q = scale sum_k ds_qk k_k
//                                              dk_k = scale sum_q ds_qk q_q
//
// the FlashAttention-2 backward: nothing of size T x T is stored, and no mask either.
//
// What bounds it on this card: at T ~ 199, d = 64, B = 96 the five score-shaped products
// are 29 GFLOP (0.030 ms of bf16 tensor-core time) against 236 MB (0.070 ms): bound by
// bytes, as long as the products run on the tensor cores and the two regenerations of the
// mask (one per kernel) stay cheap. Two kernels, neither with atomics, so every run, and
// K3a against K3b, reproduces bit for bit:
//   * dq: one block per (b*h, 64 queries), 4 warps of 16 query rows, K/V tiles of 64 keys
//     through a cp.async double buffer (bf16 in padded shared memory, never converted). Per
//     32-key half: S = Q K^T and dP = dO V^T on mma.sync, ds in registers, rounded to bf16
//     as the A fragments of dq += ds K (K by ldmatrix.trans). It also writes
//     D = rowsum(do * o) for the second kernel.
//   * dk/dv: one block per (b*h, 64 keys), 4 warps of 16 key rows, Q/dO tiles of 64 queries
//     (and their lse and D) double-buffered. With keys as rows, S^T = K Q^T and
//     dP^T = V dO^T leave P^T and dS^T in registers as the A fragments of dV = P^T dO and
//     dK = dS^T Q, with dO and Q read by ldmatrix.trans.
//   * The mask costs one Philox call per ~3.5 elements in each kernel: a lane draws a run of
//     consecutive keys (32 of one query row in dq; 16 of one query column in dk/dv) and the
//     owners take their bits by shuffle (attention_tile.cuh).
//   * float32 runs the same bodies with the products as FMAs into the same layout.
// A fused one-kernel backward would draw the mask once, but needs dq partials per key
// tile reduced in a fixed order; the split keeps each output written by one block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <cstdint>

#include "attention_tile.cuh"

namespace {

using namespace w2v::attn;
using w2v::to_float;

constexpr int kHalf = kTile / 2;          // columns of one score-shaped product

// The views of one call, in the order of the C entry's strides.
struct Views {
  View q, k, v, o, dout, dq, dk, dv;
};

template <int NT>
__device__ __forceinline__ void zero(float (&a)[NT][4]) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) a[n][i] = 0.f;
}

template <typename T, int D>
constexpr int dq_smem_bytes() {
  return 6 * Tile<T, D>::ELEMS * static_cast<int>(sizeof(T)) +
         p_buffer_floats<T, kHalf>() * static_cast<int>(sizeof(float));
}

template <typename T, int D>
constexpr int dkdv_smem_bytes() {
  return 6 * Tile<T, D>::ELEMS * static_cast<int>(sizeof(T)) +
         (4 * kTile + p_buffer_floats<T, kHalf>()) * static_cast<int>(sizeof(float));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, min_blocks<T>())
attention_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ o,
                        const T* __restrict__ dout, const float* __restrict__ lse,
                        float* __restrict__ dsum, T* __restrict__ dq, Views vw, int heads,
                        int seq, int t_keys, float scale, uint32_t seed, uint32_t site,
                        uint32_t thr, float drop_scale) {
  using Tl = Tile<T, D>;
  constexpr int S = Tl::S;
  extern __shared__ __align__(16) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);
  T* do_s = q_s + Tl::ELEMS;
  T* kv_s = do_s + Tl::ELEMS;                              // [stage][K, V]
  float* p_s = reinterpret_cast<float*>(kv_s + 4 * Tl::ELEMS);

  const int bh = blockIdx.x;
  const int b = bh / heads, h = bh - (bh / heads) * heads;
  const int q0 = blockIdx.y * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t2 = 2 * (lane & 3);
  const int wrow = q0 + warp * 16;
  const bool active = wrow < seq;
  const T* k_g = k + b * vw.k.b + h * vw.k.h;
  const T* v_g = v + b * vw.v.b + h * vw.v.h;
  float* pbuf = p_s + warp * 16 * (kHalf + 4);

  stage<T, D>(q_s, q + b * vw.q.b + h * vw.q.h, vw.q.t, q0, seq);
  stage<T, D>(do_s, dout + b * vw.dout.b + h * vw.dout.h, vw.dout.t, q0, seq);
  w2v::cp_async_commit();
  stage<T, D>(kv_s, k_g, vw.k.t, 0, t_keys);
  stage<T, D>(kv_s + Tl::ELEMS, v_g, vw.v.t, 0, t_keys);
  w2v::cp_async_commit();
  w2v::cp_async_wait<1>();
  __syncthreads();

  // rowsum(do * o): lane L takes row L >> 1, columns D / 2 (L & 1) .. + D / 2 - 1.
  float d_r[2] = {0.f, 0.f}, lse_r[2] = {0.f, 0.f};
  if (active) {
    const int r = lane >> 1, c0 = (D / 2) * (lane & 1);
    const int row = wrow + r;
    float part = 0.f;
    if (row < seq) {
      const T* o_row = o + b * vw.o.b + h * vw.o.h + row * vw.o.t + c0;
      const T* do_row = do_s + (warp * 16 + r) * S + c0;
      constexpr int E = 16 / static_cast<int>(sizeof(T));
#pragma unroll
      for (int c = 0; c < D / 2; c += E) {                 // 16-byte loads of o
        const uint4 chunk = *reinterpret_cast<const uint4*>(o_row + c);
        const T* oc = reinterpret_cast<const T*>(&chunk);
#pragma unroll
        for (int e = 0; e < E; ++e) part = fmaf(to_float(oc[e]), to_float(do_row[c + e]), part);
      }
    }
    part += __shfl_xor_sync(kFull, part, 1);
    if ((lane & 1) == 0 && row < seq) dsum[static_cast<size_t>(bh) * seq + row] = part;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      d_r[i] = __shfl_sync(kFull, part, 2 * (g + 8 * i));
      const int rr = wrow + g + 8 * i;
      lse_r[i] = rr < seq ? lse[static_cast<size_t>(bh) * seq + rr] : 0.f;
    }
  }

  float acc[D / 8][4];
  zero(acc);
  const int tiles = (t_keys + kTile - 1) / kTile;
  for (int it = 0; it < tiles; ++it) {
    const int k0 = it * kTile;
    if (it + 1 < tiles) {
      T* next = kv_s + ((it + 1) & 1) * 2 * Tl::ELEMS;
      stage<T, D>(next, k_g, vw.k.t, k0 + kTile, t_keys);
      stage<T, D>(next + Tl::ELEMS, v_g, vw.v.t, k0 + kTile, t_keys);
      w2v::cp_async_commit();
      w2v::cp_async_wait<1>();
    } else {
      w2v::cp_async_wait<0>();
    }
    __syncthreads();
    const T* k_t = kv_s + (it & 1) * 2 * Tl::ELEMS;
    const T* v_t = k_t + Tl::ELEMS;
    if (active) {
      const uint32_t runs =
          thr ? draw_row_runs(seed, site, thr,
                              (static_cast<unsigned long long>(bh) * seq + wrow) * seq + k0,
                              seq, lane)
              : kFull;
#pragma unroll 1                           // rolled: fewer registers and spills
      for (int half = 0; half < 2; ++half) {
        const int c0 = half * kHalf;
        if (k0 + c0 >= t_keys) break;            // the ragged last tile's empty half
        float s[4][4], dp[4][4];
        zero(s);
        zero(dp);
        mma_abt<4, D>(s, q_s + warp * 16 * S, k_t + c0 * S, lane);
        mma_abt<4, D>(dp, do_s + warp * 16 * S, v_t + c0 * S, lane);
        uint32_t keep[2];
        row_keep(runs, lane, half, keep);
        // ds = p (dp - D), with dp dropped as the forward dropped p.
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int c = n * 8 + t2 + (i & 1);
            const bool valid = k0 + c0 + c < t_keys;
            const float p = valid ? expf(s[n][i] * scale - lse_r[i >> 1]) : 0.f;
            const float dpv = (keep[i >> 1] >> c) & 1u ? dp[n][i] * drop_scale : 0.f;
            s[n][i] = p * (dpv - d_r[i >> 1]);
          }
        mma_pv<kHalf, D>(acc, s, k_t + c0 * S, pbuf, lane);
      }
    }
    __syncthreads();
  }

  if (!active) return;
  T* dq_g = dq + b * vw.dq.b + h * vw.dq.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wrow + g + 8 * r;
    if (row >= seq) continue;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      store2(dq_g + row * vw.dq.t + n * 8 + t2, acc[n][2 * r] * scale,
             acc[n][2 * r + 1] * scale);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, min_blocks<T>())
attention_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ dsum,
                          T* __restrict__ dk_out, T* __restrict__ dv_out, Views vw, int heads,
                          int seq, int t_keys, float scale, uint32_t seed, uint32_t site,
                          uint32_t thr, float drop_scale) {
  using Tl = Tile<T, D>;
  constexpr int S = Tl::S;
  extern __shared__ __align__(16) unsigned char smem[];
  T* k_s = reinterpret_cast<T*>(smem);
  T* v_s = k_s + Tl::ELEMS;
  T* qdo_s = v_s + Tl::ELEMS;                              // [stage][Q, dO]
  float* lse_s = reinterpret_cast<float*>(qdo_s + 4 * Tl::ELEMS);        // [stage][64]
  float* d_s = lse_s + 2 * kTile;                                        // [stage][64]
  float* p_s = d_s + 2 * kTile;

  const int bh = blockIdx.x;
  const int b = bh / heads, h = bh - (bh / heads) * heads;
  const int key0 = blockIdx.y * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t2 = 2 * (lane & 3);
  const int wkey = key0 + warp * 16;                       // the warp's first key
  const bool active = wkey < seq;
  const T* q_g = q + b * vw.q.b + h * vw.q.h;
  const T* do_g = dout + b * vw.dout.b + h * vw.dout.h;
  const float* lse_g = lse + static_cast<size_t>(bh) * seq;
  const float* d_g = dsum + static_cast<size_t>(bh) * seq;
  float* pbuf = p_s + warp * 16 * (kHalf + 4);

  auto stage_queries = [&](int buf, int r0) {
    T* dst = qdo_s + buf * 2 * Tl::ELEMS;
    stage<T, D>(dst, q_g, vw.q.t, r0, seq);
    stage<T, D>(dst + Tl::ELEMS, do_g, vw.dout.t, r0, seq);
    w2v::cp_async_commit();
    for (int r = threadIdx.x; r < kTile; r += kThreads) {
      const bool ok = r0 + r < seq;
      lse_s[buf * kTile + r] = ok ? lse_g[r0 + r] : 0.f;
      d_s[buf * kTile + r] = ok ? d_g[r0 + r] : 0.f;
    }
  };

  stage<T, D>(k_s, k + b * vw.k.b + h * vw.k.h, vw.k.t, key0, t_keys);
  stage<T, D>(v_s, v + b * vw.v.b + h * vw.v.h, vw.v.t, key0, t_keys);
  w2v::cp_async_commit();
  stage_queries(0, 0);

  float dk[D / 8][4], dv[D / 8][4];
  zero(dk);
  zero(dv);
  const int tiles = (seq + kTile - 1) / kTile;
  for (int it = 0; it < tiles; ++it) {
    const int q0 = it * kTile, buf = it & 1;
    if (it + 1 < tiles) {
      stage_queries((it + 1) & 1, q0 + kTile);
      w2v::cp_async_wait<1>();
    } else {
      w2v::cp_async_wait<0>();
    }
    __syncthreads();
    const T* q_t = qdo_s + buf * 2 * Tl::ELEMS;
    const T* do_t = q_t + Tl::ELEMS;
    if (active) {
      const uint32_t runs =
          thr ? draw_col_runs(seed, site, thr,
                              (static_cast<unsigned long long>(bh) * seq + q0) * seq + wkey,
                              seq, lane)
              : kFull;
#pragma unroll 1                           // rolled: fewer registers and spills
      for (int half = 0; half < 2; ++half) {
        const int c0 = half * kHalf;
        if (q0 + c0 >= seq) break;               // the ragged last tile's empty half
        float s[4][4], dp[4][4];                 // S^T and dP^T: keys as rows
        zero(s);
        zero(dp);
        mma_abt<4, D>(s, k_s + warp * 16 * S, q_t + c0 * S, lane);
        mma_abt<4, D>(dp, v_s + warp * 16 * S, do_t + c0 * S, lane);
        // pd = the dropped p (for dv); ds = p (dp - D) (for dk).
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = n * 8 + t2 + e;
            const uint32_t keep = col_keep(runs, c, half);
            const float lse_c = lse_s[buf * kTile + c0 + c], d_c = d_s[buf * kTile + c0 + c];
            const bool valid_q = q0 + c0 + c < seq;
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int i = 2 * r + e;
              const bool valid = valid_q && wkey + g + 8 * r < t_keys;
              const float p = valid ? expf(s[n][i] * scale - lse_c) : 0.f;
              const bool kept = (keep >> (g + 8 * r)) & 1u;
              s[n][i] = kept ? p * drop_scale : 0.f;
              dp[n][i] = p * ((kept ? dp[n][i] * drop_scale : 0.f) - d_c);
            }
          }
        mma_pv<kHalf, D>(dv, s, do_t + c0 * S, pbuf, lane);
        mma_pv<kHalf, D>(dk, dp, q_t + c0 * S, pbuf, lane);
      }
    }
    __syncthreads();
  }

  if (!active) return;
  T* dk_g = dk_out + b * vw.dk.b + h * vw.dk.h;
  T* dv_g = dv_out + b * vw.dv.b + h * vw.dv.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = wkey + g + 8 * r;
    if (key >= seq) continue;                    // keys in [t_keys, seq) get exact zeros
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      store2(dk_g + key * vw.dk.t + n * 8 + t2, dk[n][2 * r] * scale, dk[n][2 * r + 1] * scale);
      store2(dv_g + key * vw.dv.t + n * 8 + t2, dv[n][2 * r], dv[n][2 * r + 1]);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
           const void* lse, void* dsum, void* dq, void* dk, void* dv, const Views& vw,
           int batch, int heads, int seq, int t_keys, float scale, uint32_t seed, uint32_t site,
           uint32_t thr, float drop_scale, cudaStream_t stream) {
  // Above 48 KB: set at every launch, as the attribute is the device's.
  const cudaError_t set_dq = cudaFuncSetAttribute(
      attention_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      dq_smem_bytes<T, D>());
  const cudaError_t set_dkdv = cudaFuncSetAttribute(
      attention_bwd_dkdv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      dkdv_smem_bytes<T, D>());
  if (set_dq != cudaSuccess) return static_cast<int>(set_dq);
  if (set_dkdv != cudaSuccess) return static_cast<int>(set_dkdv);
  const dim3 grid(batch * heads, (seq + kRows - 1) / kRows);
  const T *qp = static_cast<const T*>(q), *kp = static_cast<const T*>(k),
          *vp = static_cast<const T*>(v), *dop = static_cast<const T*>(dout);
  attention_bwd_dq_kernel<T, D><<<grid, kThreads, dq_smem_bytes<T, D>(), stream>>>(
      qp, kp, vp, static_cast<const T*>(o), dop, static_cast<const float*>(lse),
      static_cast<float*>(dsum), static_cast<T*>(dq), vw, heads, seq, t_keys, scale, seed, site,
      thr, drop_scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_bwd_dkdv_kernel<T, D><<<grid, kThreads, dkdv_smem_bytes<T, D>(), stream>>>(
      qp, kp, vp, dop, static_cast<const float*>(lse), static_cast<const float*>(dsum),
      static_cast<T*>(dk), static_cast<T*>(dv), vw, heads, seq, t_keys, scale, seed, site, thr,
      drop_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry point, bound with ctypes. strides: 24 element strides, (b, h, t) of q, k, v, o,
// dout, dq, dk and dv in that order (d contiguous in each). head_dim: 16, 32, 64 or 128.
// dtype: 0 = float32,
// 1 = bfloat16 (the eight views); lse and the scratch dsum ([B, H, T], contiguous) are
// float32. thr = uint32(rate * (2^32 - 1)) (0 = no dropout), drop_scale = 1 / (1 - rate), as
// the forward was given. Returns the cudaError_t of the launches (0 = launched); the caller
// raises on anything else.
extern "C" int attention_bwd(const void* q, const void* k, const void* v, const void* o,
                             const void* dout, const void* lse, void* dsum, void* dq, void* dk,
                             void* dv, const long long* strides, int batch, int heads, int seq,
                             int head_dim, int t_keys, float scale, uint32_t seed,
                             uint32_t site, uint32_t thr, float drop_scale, int dtype,
                             void* stream) {
  if (batch <= 0 || heads <= 0 || seq <= 0 || t_keys <= 0 || t_keys > seq)
    return static_cast<int>(cudaErrorInvalidValue);
  View v8[8];
  for (int i = 0; i < 8; ++i)
    v8[i] = View{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const Views vw{v8[0], v8[1], v8[2], v8[3], v8[4], v8[5], v8[6], v8[7]};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = static_cast<int>(cudaErrorInvalidValue);
  on_head_dim(head_dim, [&](auto dim) {
    constexpr int D = decltype(dim)::value;
    if (dtype == 0)
      err = launch<float, D>(q, k, v, o, dout, lse, dsum, dq, dk, dv, vw, batch, heads, seq,
                             t_keys, scale, seed, site, thr, drop_scale, st);
    if (dtype == 1)
      err = launch<__nv_bfloat16, D>(q, k, v, o, dout, lse, dsum, dq, dk, dv, vw, batch, heads,
                                     seq, t_keys, scale, seed, site, thr, drop_scale, st);
  });
  return err;
}

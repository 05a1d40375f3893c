// Attention backward for NVIDIA Hopper (sm_90a), with attention dropout: one kernel body for
// the packed-QKV (K3b) and the unpacked (K3a) routes.
//
// Replaces the TPU kernels wav2vec_heart_sounds_tpu/ops/pallas/attention.py::_packed_bwd
// (K3b backward) and ::_flash_bwd (K3a backward; K3a computes exactly K3b's function). From
// q, k, v, the forward's output o, the output cotangent do and the forward's row
// log-sum-exp lse ([B, H, T] float32, contiguous), it writes dq, dk and dv. Every one of
// these eight tensors is a [B, H, T, d] view given by its base pointer and element strides
// over (b, h, t), d contiguous: the three thirds of one packed [B, 3H, T, d] tensor and of
// one packed gradient (K3b), or separate tensors and head views of [B, T, H, d] ones (K3a).
// With p the probabilities recomputed as exp(q.k * scale - lse) (keys >= t_keys masked),
// keep the Philox mask the forward drew at index ((b*H + h)*T + q)*T + k (philox.cuh,
// whatever the strides) and c the dropout scale 1 / (1 - rate):
//
//     dv_k = sum_q keep c p_qk do_q            dp_qk = keep ? c (do_q . v_k) : 0
//     D_q  = do_q . o_q  (= sum_k dp_qk p_qk, since o is the dropped output)
//     ds_qk = p_qk (dp_qk - D_q)               dq_q = scale sum_k ds_qk k_k
//                                              dk_k = scale sum_q ds_qk q_q
//
// the FlashAttention-2 backward: nothing of size T x T is stored, and no mask either.
//
// What bounds it on this card: at T ~ 199, d = 64 the work per (b, h) is ~35 MFLOP of
// float32 SIMT arithmetic on ~130 KB, so it is bound by the FMA pipes and shared-memory
// traffic, not by HBM. Two kernels, neither with atomics (so every run, and the comparison
// with the plain version, reproduces):
//   * dq: grid (b*h, 16-query tiles), as the forward: K/V tiles of 64 keys staged in shared
//     memory as float32; each warp owns 4 query rows, each lane one key per 32 for the
//     score and dp steps (float4 reads from padded rows) and d / 32 columns of dq (ds
//     broadcast by warp shuffle). It also writes D = rowsum(do * o) for the second kernel.
//   * dk/dv: grid (b*h, 16-key tiles), the same scheme with queries and keys exchanged:
//     Q/dO tiles of 64 queries staged, each warp owns 4 keys.
// No wgmma or TMA yet: the first version is the simple one that is right.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <cstdint>

#include "gelu.cuh"
#include "philox.cuh"

namespace {

using w2v::store;
using w2v::to_float;

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 4;
constexpr int kTile = kWarps * kRowsPerWarp;     // rows a block owns (queries or keys)
constexpr int kThreads = kWarps * 32;
constexpr int kStage = 64;                       // rows per staged tile of the other side
constexpr int kPerLane = kStage / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Element strides of a [B, H, T, d] view over (b, h, t); d is contiguous.
struct View {
  long long b, h, t;
};

// The views of one call, in the order of the C entry's strides.
struct Views {
  View q, k, v, o, dout, dq, dk, dv;
};

__device__ __forceinline__ bool kept(uint32_t seed, uint32_t site, uint32_t thr, int bh,
                                     int seq, int q, int k) {
  if (!thr) return true;
  const unsigned long long index =
      (static_cast<unsigned long long>(bh) * seq + q) * seq + k;
  return w2v::philox_bits(seed, site, index) >= thr;
}

// float4 dot product accumulated into acc.
__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ o,
                        const T* __restrict__ dout, const float* __restrict__ lse,
                        float* __restrict__ dsum, T* __restrict__ dq, Views vw, int heads,
                        int seq, int t_keys, float scale, uint32_t seed, uint32_t site,
                        uint32_t thr, float drop_scale) {
  constexpr int DPL = D / 32;
  constexpr int KS = D + 4;
  __shared__ __align__(16) float q_s[kTile][D];
  __shared__ __align__(16) float do_s[kTile][D];
  __shared__ __align__(16) float k_s[kStage][KS];
  __shared__ __align__(16) float v_s[kStage][KS];

  const int bh = blockIdx.x;
  const int b = bh / heads, h = bh - (bh / heads) * heads;
  const int q0 = blockIdx.y * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = warp * kRowsPerWarp;
  const T* q_g = q + b * vw.q.b + h * vw.q.h;
  const T* k_g = k + b * vw.k.b + h * vw.k.h;
  const T* v_g = v + b * vw.v.b + h * vw.v.h;
  const T* o_g = o + b * vw.o.b + h * vw.o.h;
  const T* do_g = dout + b * vw.dout.b + h * vw.dout.h;
  T* dq_g = dq + b * vw.dq.b + h * vw.dq.h;

  for (int e = threadIdx.x; e < kTile * D; e += kThreads) {
    const int r = e / D, c = e - (e / D) * D;
    const int row = q0 + r;
    const bool ok = row < seq;
    q_s[r][c] = ok ? to_float(q_g[row * vw.q.t + c]) : 0.f;
    do_s[r][c] = ok ? to_float(do_g[row * vw.dout.t + c]) : 0.f;
  }
  __syncthreads();

  float lse_r[kRowsPerWarp], d_r[kRowsPerWarp], acc[kRowsPerWarp][DPL];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int row = q0 + row0 + rr;
    float part = 0.f;
    if (row < seq) {
#pragma unroll
      for (int i = 0; i < DPL; ++i)
        part = fmaf(to_float(o_g[row * vw.o.t + lane + 32 * i]),
                    do_s[row0 + rr][lane + 32 * i], part);
    }
    d_r[rr] = warp_sum(part);
    lse_r[rr] = row < seq ? lse[static_cast<size_t>(bh) * seq + row] : 0.f;
    if (row < seq && lane == 0) dsum[static_cast<size_t>(bh) * seq + row] = d_r[rr];
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[rr][i] = 0.f;
  }

  for (int k0 = 0; k0 < t_keys; k0 += kStage) {
    __syncthreads();   // the previous tile is consumed
    for (int e = threadIdx.x; e < kStage * D; e += kThreads) {
      const int r = e / D, c = e - (e / D) * D;
      const int key = k0 + r;
      const bool ok = key < t_keys;
      k_s[r][c] = ok ? to_float(k_g[key * vw.k.t + c]) : 0.f;
      v_s[r][c] = ok ? to_float(v_g[key * vw.v.t + c]) : 0.f;
    }
    __syncthreads();

    // Scores and do . v: lane owns keys j*32 + lane of the tile, for all 4 rows at once.
    float s[kRowsPerWarp][kPerLane], dp[kRowsPerWarp][kPerLane];
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr)
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) s[rr][j] = dp[rr][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; c += 4) {
      float4 kv[kPerLane], vv[kPerLane];
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) {
        kv[j] = *reinterpret_cast<const float4*>(&k_s[j * 32 + lane][c]);
        vv[j] = *reinterpret_cast<const float4*>(&v_s[j * 32 + lane][c]);
      }
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr) {
        const float4 qv = *reinterpret_cast<const float4*>(&q_s[row0 + rr][c]);
        const float4 dv = *reinterpret_cast<const float4*>(&do_s[row0 + rr][c]);
#pragma unroll
        for (int j = 0; j < kPerLane; ++j) {
          s[rr][j] = dot4(qv, kv[j], s[rr][j]);
          dp[rr][j] = dot4(dv, vv[j], dp[rr][j]);
        }
      }
    }

    // ds = p (dp - D), with dp dropped as the forward dropped p.
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int row = q0 + row0 + rr;
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) {
        const int key = k0 + j * 32 + lane;
        const bool valid = row < seq && key < t_keys;
        const float p = valid ? expf(s[rr][j] * scale - lse_r[rr]) : 0.f;
        const float dpv =
            valid && kept(seed, site, thr, bh, seq, row, key) ? dp[rr][j] * drop_scale : 0.f;
        s[rr][j] = p * (dpv - d_r[rr]);
      }
    }

    // dq += ds k: lane owns columns lane + 32 i; ds arrives by shuffle from lane `src`.
    // j is unrolled so s[rr][j] stays in registers.
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
#pragma unroll 8
      for (int src = 0; src < 32; ++src) {
        const int kr = j * 32 + src;
        float kk[DPL];
#pragma unroll
        for (int i = 0; i < DPL; ++i) kk[i] = k_s[kr][lane + 32 * i];
#pragma unroll
        for (int rr = 0; rr < kRowsPerWarp; ++rr) {
          const float ds = __shfl_sync(kFull, s[rr][j], src);
#pragma unroll
          for (int i = 0; i < DPL; ++i) acc[rr][i] = fmaf(ds, kk[i], acc[rr][i]);
        }
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int row = q0 + row0 + rr;
    if (row >= seq) continue;
#pragma unroll
    for (int i = 0; i < DPL; ++i)
      store(dq_g + row * vw.dq.t + lane + 32 * i, acc[rr][i] * scale);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ dsum,
                          T* __restrict__ dk_out, T* __restrict__ dv_out, Views vw, int heads,
                          int seq, int t_keys, float scale, uint32_t seed, uint32_t site,
                          uint32_t thr, float drop_scale) {
  constexpr int DPL = D / 32;
  constexpr int QS = D + 4;
  __shared__ __align__(16) float k_s[kTile][D];
  __shared__ __align__(16) float v_s[kTile][D];
  __shared__ __align__(16) float q_s[kStage][QS];
  __shared__ __align__(16) float do_s[kStage][QS];
  __shared__ float lse_s[kStage];
  __shared__ float d_s[kStage];

  const int bh = blockIdx.x;
  const int b = bh / heads, h = bh - (bh / heads) * heads;
  const int key0 = blockIdx.y * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = warp * kRowsPerWarp;          // this warp's first key within the tile
  const T* q_g = q + b * vw.q.b + h * vw.q.h;
  const T* k_g = k + b * vw.k.b + h * vw.k.h;
  const T* v_g = v + b * vw.v.b + h * vw.v.h;
  const T* do_g = dout + b * vw.dout.b + h * vw.dout.h;
  T* dk_g = dk_out + b * vw.dk.b + h * vw.dk.h;
  T* dv_g = dv_out + b * vw.dv.b + h * vw.dv.h;

  for (int e = threadIdx.x; e < kTile * D; e += kThreads) {
    const int r = e / D, c = e - (e / D) * D;
    const int key = key0 + r;
    const bool ok = key < t_keys;
    k_s[r][c] = ok ? to_float(k_g[key * vw.k.t + c]) : 0.f;
    v_s[r][c] = ok ? to_float(v_g[key * vw.v.t + c]) : 0.f;
  }

  float dk[kRowsPerWarp][DPL], dv[kRowsPerWarp][DPL];
#pragma unroll
  for (int kk = 0; kk < kRowsPerWarp; ++kk)
#pragma unroll
    for (int i = 0; i < DPL; ++i) dk[kk][i] = dv[kk][i] = 0.f;

  for (int q0 = 0; q0 < seq; q0 += kStage) {
    __syncthreads();   // the previous tile is consumed (first pass: the key tile is staged)
    for (int e = threadIdx.x; e < kStage * D; e += kThreads) {
      const int r = e / D, c = e - (e / D) * D;
      const int row = q0 + r;
      const bool ok = row < seq;
      q_s[r][c] = ok ? to_float(q_g[row * vw.q.t + c]) : 0.f;
      do_s[r][c] = ok ? to_float(do_g[row * vw.dout.t + c]) : 0.f;
    }
    for (int r = threadIdx.x; r < kStage; r += kThreads) {
      const int row = q0 + r;
      lse_s[r] = row < seq ? lse[static_cast<size_t>(bh) * seq + row] : 0.f;
      d_s[r] = row < seq ? dsum[static_cast<size_t>(bh) * seq + row] : 0.f;
    }
    __syncthreads();

    // Scores and do . v: lane owns queries j*32 + lane of the tile, for all 4 keys at once.
    float s[kRowsPerWarp][kPerLane], dp[kRowsPerWarp][kPerLane];
#pragma unroll
    for (int kk = 0; kk < kRowsPerWarp; ++kk)
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) s[kk][j] = dp[kk][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; c += 4) {
      float4 qv[kPerLane], dov[kPerLane];
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) {
        qv[j] = *reinterpret_cast<const float4*>(&q_s[j * 32 + lane][c]);
        dov[j] = *reinterpret_cast<const float4*>(&do_s[j * 32 + lane][c]);
      }
#pragma unroll
      for (int kk = 0; kk < kRowsPerWarp; ++kk) {
        const float4 kv = *reinterpret_cast<const float4*>(&k_s[row0 + kk][c]);
        const float4 vv = *reinterpret_cast<const float4*>(&v_s[row0 + kk][c]);
#pragma unroll
        for (int j = 0; j < kPerLane; ++j) {
          s[kk][j] = dot4(qv[j], kv, s[kk][j]);
          dp[kk][j] = dot4(dov[j], vv, dp[kk][j]);
        }
      }
    }

    // pd = the dropped p (for dv); ds = p (dp - D) (for dk).
#pragma unroll
    for (int kk = 0; kk < kRowsPerWarp; ++kk) {
      const int key = key0 + row0 + kk;
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) {
        const int qr = j * 32 + lane;
        const int row = q0 + qr;
        const bool valid = row < seq && key < t_keys;
        const float p = valid ? expf(s[kk][j] * scale - lse_s[qr]) : 0.f;
        const bool keep = valid && kept(seed, site, thr, bh, seq, row, key);
        s[kk][j] = keep ? p * drop_scale : 0.f;
        dp[kk][j] = p * ((keep ? dp[kk][j] * drop_scale : 0.f) - d_s[qr]);
      }
    }

    // dv += pd do, dk += ds q: lane owns columns lane + 32 i; pd and ds arrive by shuffle
    // from lane `src` (j unrolled, so s and dp stay in registers).
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
#pragma unroll 8
      for (int src = 0; src < 32; ++src) {
        const int qr = j * 32 + src;
        float dov[DPL], qv[DPL];
#pragma unroll
        for (int i = 0; i < DPL; ++i) {
          dov[i] = do_s[qr][lane + 32 * i];
          qv[i] = q_s[qr][lane + 32 * i];
        }
#pragma unroll
        for (int kk = 0; kk < kRowsPerWarp; ++kk) {
          const float pd = __shfl_sync(kFull, s[kk][j], src);
          const float ds = __shfl_sync(kFull, dp[kk][j], src);
#pragma unroll
          for (int i = 0; i < DPL; ++i) {
            dv[kk][i] = fmaf(pd, dov[i], dv[kk][i]);
            dk[kk][i] = fmaf(ds, qv[i], dk[kk][i]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int kk = 0; kk < kRowsPerWarp; ++kk) {
    const int key = key0 + row0 + kk;
    if (key >= seq) continue;                  // keys in [t_keys, seq) get exact zeros
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      store(dk_g + key * vw.dk.t + lane + 32 * i, dk[kk][i] * scale);
      store(dv_g + key * vw.dv.t + lane + 32 * i, dv[kk][i]);
    }
  }
}

// wav2vec2-base's head width (768 hidden / 12 heads), the only one instantiated.
constexpr int kHeadDim = 64;

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
           const void* lse, void* dsum, void* dq, void* dk, void* dv, const Views& vw,
           int batch, int heads, int seq, int t_keys, float scale, uint32_t seed, uint32_t site,
           uint32_t thr, float drop_scale, cudaStream_t stream) {
  const dim3 grid(batch * heads, (seq + kTile - 1) / kTile);
  const T *qp = static_cast<const T*>(q), *kp = static_cast<const T*>(k),
          *vp = static_cast<const T*>(v), *dop = static_cast<const T*>(dout);
  attention_bwd_dq_kernel<T, kHeadDim><<<grid, kThreads, 0, stream>>>(
      qp, kp, vp, static_cast<const T*>(o), dop, static_cast<const float*>(lse),
      static_cast<float*>(dsum), static_cast<T*>(dq), vw, heads, seq, t_keys, scale, seed, site,
      thr, drop_scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_bwd_dkdv_kernel<T, kHeadDim><<<grid, kThreads, 0, stream>>>(
      qp, kp, vp, dop, static_cast<const float*>(lse), static_cast<const float*>(dsum),
      static_cast<T*>(dk), static_cast<T*>(dv), vw, heads, seq, t_keys, scale, seed, site, thr,
      drop_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry point, bound with ctypes. strides: 24 element strides, (b, h, t) of q, k, v, o,
// dout, dq, dk and dv in that order (d contiguous in each). dtype: 0 = float32,
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
  if (batch <= 0 || heads <= 0 || seq <= 0 || t_keys <= 0 || t_keys > seq ||
      head_dim != kHeadDim)
    return static_cast<int>(cudaErrorInvalidValue);
  View v8[8];
  for (int i = 0; i < 8; ++i)
    v8[i] = View{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const Views vw{v8[0], v8[1], v8[2], v8[3], v8[4], v8[5], v8[6], v8[7]};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(q, k, v, o, dout, lse, dsum, dq, dk, dv, vw, batch, heads, seq,
                           t_keys, scale, seed, site, thr, drop_scale, st);
    case 1:
      return launch<__nv_bfloat16>(q, k, v, o, dout, lse, dsum, dq, dk, dv, vw, batch, heads,
                                   seq, t_keys, scale, seed, site, thr, drop_scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

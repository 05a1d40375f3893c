// Attention forward for NVIDIA Hopper (sm_90a), with attention dropout: one kernel body for
// the packed-QKV (K3b) and the unpacked (K3a) routes.
//
// Replaces the TPU kernels wav2vec_heart_sounds_tpu/ops/pallas/attention.py::_packed_fwd
// (flash_attention_qkv, K3b) and ::_flash_fwd (flash_attention, K3a: the unpacked q/k/v of
// the encoder's W2VHS_NO_QKVFUSE=1 route). K3a computes exactly K3b's function, so both run
// this body. Computes, for every (batch b, head h):
//
//     p = softmax(q k^T / sqrt(d), keys >= t_keys masked)
//     out[b, h] = (keep ? p * scale : 0) v,   lse[b, h] = log-sum-exp of the scaled scores
//
// q, k, v and out are [B, H, T, d] views, each given by its base pointer and its element
// strides over (b, h, t) (d contiguous), read and written in place: heads h, H + h and
// 2H + h of one packed [B, 3H, T, d] tensor (K3b), three [B, H, T, d] tensors or the head
// views of [B, T, H, d] projections (K3a), with no slice or transpose copies. Scores,
// softmax and the PV sum are float32; out has the input dtype (float32 or bfloat16); lse
// (float32 [B, H, T], contiguous, written when its pointer is not null) is what the
// backward (attention_qkv_bwd.cu) recomputes the probabilities from. Dropout drops the
// normalised probabilities, as the JAX kernel (attention.py:125-131): the online softmax
// accumulates the kept e * v while l sums every e, the algebraically identical deferred
// form (:116-123). keep is Philox4x32-10 of (seed, site) at element index
// ((b*H + h)*T + q)*T + k (philox.cuh), whatever the strides: the index the backward and
// the plain versions use, so both routes draw the same masks; threshold 0 (rate 0, eval)
// skips it.
//
// What bounds it on this card: at wav2vec2-base's T ~ 199 and d = 64 one (b, h) pair is
// ~5 MFLOP against 76 KB of q/k/v (bf16), far too little work per byte and per launch for
// the tensor cores to matter; the kernel is bound by memory and latency (loads, shared
// memory traffic, the softmax's reductions), not by FLOPs. The tiling answers that:
//   * the grid is (b*h, query tiles of 16 rows), ~15k blocks at B=96, so every SM has many
//     blocks in flight to hide load latency;
//   * key/value tiles of 64 rows are staged once in shared memory as float32 and reused
//     by all 16 query rows of the block; a block (38 KB) stays under the 48 KB static
//     shared-memory limit, so several blocks share an SM;
//   * one warp owns 4 query rows at once: in the score step each lane takes one key of
//     the tile per 32 and reads K rows as float4 from a row padded to d + 4 floats (no
//     bank conflicts), reusing each K load for the 4 rows; in the PV step each lane owns
//     d / 32 output columns and the probabilities are broadcast with warp shuffles;
//   * an online softmax (running max and sum per row) walks the key tiles, so any T and
//     the ragged last tile need no padding, and the [T, T] probabilities never leave
//     registers.
// No wgmma or TMA yet: the first version is the simple one that is right. With dropout on,
// each lane draws one Philox call per (row, key) it owns: about as many integer
// operations again as the score step, paid only in training.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <cstdint>

#include "philox.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 4;
constexpr int kQueryTile = kWarps * kRowsPerWarp;   // query rows per block
constexpr int kThreads = kWarps * 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// Element strides of a [B, H, T, d] view over (b, h, t); d is contiguous.
struct View {
  long long b, h, t;
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// kTrain = false is the eval instantiation (no dropout, no lse): exactly the rate-0 kernel
// that came before training, so adding training costs eval nothing.
template <typename T, int D, bool kTrain>
__global__ void __launch_bounds__(kThreads)
attention_fwd_kernel(const T* __restrict__ q, View qs, const T* __restrict__ k, View ks,
                     const T* __restrict__ v, View vs, T* __restrict__ out, View os,
                     float* __restrict__ lse, int heads, int seq, int t_keys, float scale,
                     uint32_t seed, uint32_t site, uint32_t thr, float drop_scale) {
  constexpr int KT = 64;                  // keys per shared-memory tile
  constexpr int KPL = KT / 32;            // keys per lane in the score step
  constexpr int DPL = D / 32;             // output columns per lane in the PV step
  constexpr int KS = D + 4;               // padded K row: float4 reads without conflicts
  static_assert(D % 32 == 0, "head dim must be a multiple of 32");

  __shared__ __align__(16) float q_s[kQueryTile][D];
  __shared__ __align__(16) float k_s[KT][KS];
  __shared__ __align__(16) float v_s[KT][D];

  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int q0 = blockIdx.y * kQueryTile;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row0 = warp * kRowsPerWarp;   // this warp's first row within the tile

  const T* q_g = q + b * qs.b + h * qs.h;
  const T* k_g = k + b * ks.b + h * ks.h;
  const T* v_g = v + b * vs.b + h * vs.h;
  T* o_g = out + b * os.b + h * os.h;

  for (int e = threadIdx.x; e < kQueryTile * D; e += kThreads) {
    const int r = e / D, c = e - (e / D) * D;
    const int row = q0 + r;
    q_s[r][c] = row < seq ? to_float(q_g[row * qs.t + c]) : 0.f;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][DPL];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    m[rr] = -INFINITY;
    l[rr] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[rr][i] = 0.f;
  }

  for (int k0 = 0; k0 < t_keys; k0 += KT) {
    __syncthreads();   // the previous tile is consumed (first pass: q tile is staged)
    for (int e = threadIdx.x; e < KT * D; e += kThreads) {
      const int r = e / D, c = e - (e / D) * D;
      const int key = k0 + r;
      const bool ok = key < t_keys;
      k_s[r][c] = ok ? to_float(k_g[key * ks.t + c]) : 0.f;
      v_s[r][c] = ok ? to_float(v_g[key * vs.t + c]) : 0.f;
    }
    __syncthreads();

    // Scores: lane owns keys j*32 + lane of the tile, for all 4 rows at once.
    float s[kRowsPerWarp][KPL];
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr)
#pragma unroll
      for (int j = 0; j < KPL; ++j) s[rr][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; c += 4) {
      float4 kv[KPL];
#pragma unroll
      for (int j = 0; j < KPL; ++j)
        kv[j] = *reinterpret_cast<const float4*>(&k_s[j * 32 + lane][c]);
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr) {
        const float4 qv = *reinterpret_cast<const float4*>(&q_s[row0 + rr][c]);
#pragma unroll
        for (int j = 0; j < KPL; ++j) {
          float a = s[rr][j];
          a = fmaf(qv.x, kv[j].x, a);
          a = fmaf(qv.y, kv[j].y, a);
          a = fmaf(qv.z, kv[j].z, a);
          a = fmaf(qv.w, kv[j].w, a);
          s[rr][j] = a;
        }
      }
    }

    // Online softmax update. Key k0 < t_keys lies in this tile, so the tile max is finite.
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      float tile_max = -INFINITY;
#pragma unroll
      for (int j = 0; j < KPL; ++j) {
        const bool ok = k0 + j * 32 + lane < t_keys;
        s[rr][j] = ok ? s[rr][j] * scale : -INFINITY;
        tile_max = fmaxf(tile_max, s[rr][j]);
      }
      tile_max = warp_max(tile_max);
      const float m_new = fmaxf(m[rr], tile_max);
      const float corr = expf(m[rr] - m_new);   // 0 on the first tile (m = -inf)
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < KPL; ++j) {
        s[rr][j] = expf(s[rr][j] - m_new);      // masked keys give exactly 0
        psum += s[rr][j];
      }
      l[rr] = l[rr] * corr + warp_sum(psum);
      m[rr] = m_new;
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[rr][i] *= corr;
      if (kTrain && thr) {                      // dropout: l keeps every e, PV only the kept
        const unsigned long long row_index =
            (static_cast<unsigned long long>(bh) * seq + q0 + row0 + rr) * seq + k0 + lane;
#pragma unroll
        for (int j = 0; j < KPL; ++j)
          if (w2v::philox_bits(seed, site, row_index + j * 32) < thr) s[rr][j] = 0.f;
      }
    }

    // PV: lane owns columns lane + 32 i; probabilities arrive by shuffle from their lane.
#pragma unroll
    for (int kr = 0; kr < KT; ++kr) {
      float vv[DPL];
#pragma unroll
      for (int i = 0; i < DPL; ++i) vv[i] = v_s[kr][lane + 32 * i];
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr) {
        const float p = __shfl_sync(kFull, s[rr][kr / 32], kr % 32);
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[rr][i] = fmaf(p, vv[i], acc[rr][i]);
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int row = q0 + row0 + rr;
    if (row >= seq) continue;
    const float inv = (kTrain ? drop_scale : 1.f) / l[rr];
    if (kTrain && lse != nullptr && lane == 0)
      lse[static_cast<size_t>(bh) * seq + row] = m[rr] + logf(l[rr]);
#pragma unroll
    for (int i = 0; i < DPL; ++i)
      store(o_g + row * os.t + lane + 32 * i, acc[rr][i] * inv);
  }
}

// wav2vec2-base's head width (768 hidden / 12 heads), the only one instantiated.
constexpr int kHeadDim = 64;

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, void* lse, const View* s,
           int batch, int heads, int seq, int t_keys, float scale, uint32_t seed, uint32_t site,
           uint32_t thr, float drop_scale, cudaStream_t stream) {
  const dim3 grid(batch * heads, (seq + kQueryTile - 1) / kQueryTile);
  const T *qp = static_cast<const T*>(q), *kp = static_cast<const T*>(k),
          *vp = static_cast<const T*>(v);
  T* op = static_cast<T*>(out);
  if (lse == nullptr && thr == 0)
    attention_fwd_kernel<T, kHeadDim, false><<<grid, kThreads, 0, stream>>>(
        qp, s[0], kp, s[1], vp, s[2], op, s[3], nullptr, heads, seq, t_keys, scale, seed, site,
        thr, drop_scale);
  else
    attention_fwd_kernel<T, kHeadDim, true><<<grid, kThreads, 0, stream>>>(
        qp, s[0], kp, s[1], vp, s[2], op, s[3], static_cast<float*>(lse), heads, seq, t_keys,
        scale, seed, site, thr, drop_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry point, bound with ctypes. strides: 12 element strides, (b, h, t) of q, k, v and
// out in that order (d contiguous in each). dtype: 0 = float32, 1 = bfloat16. lse may be
// null (eval; with thr 0 too, the eval instantiation runs). thr = uint32(rate * (2^32 - 1))
// (0 = no dropout), drop_scale = 1 / (1 - rate). Returns the cudaError_t of the launch
// (0 = launched); the caller raises on anything else.
extern "C" int attention_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
                             const long long* strides, int batch, int heads, int seq,
                             int head_dim, int t_keys, float scale, uint32_t seed,
                             uint32_t site, uint32_t thr, float drop_scale, int dtype,
                             void* stream) {
  if (batch <= 0 || heads <= 0 || seq <= 0 || t_keys <= 0 || t_keys > seq ||
      head_dim != kHeadDim)
    return static_cast<int>(cudaErrorInvalidValue);
  View s[4];
  for (int i = 0; i < 4; ++i) s[i] = View{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(q, k, v, out, lse, s, batch, heads, seq, t_keys, scale, seed, site,
                           thr, drop_scale, st);
    case 1:
      return launch<__nv_bfloat16>(q, k, v, out, lse, s, batch, heads, seq, t_keys, scale, seed,
                                   site, thr, drop_scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

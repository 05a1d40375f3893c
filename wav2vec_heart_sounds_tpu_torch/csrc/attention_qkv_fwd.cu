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
// strides over (b, h, t) (d contiguous, rows 16-byte aligned), read and written in place:
// the thirds of a packed [B, 3H, T, d] tensor or of the head view of a [B, T, 3H, d]
// projection (K3b), or head views of [B, T, H, d] tensors (K3a), with no copies. Every
// stride runs the same instructions, so K3a and K3b agree bit for bit. Scores, softmax and
// the PV sum accumulate in float32; out has the input dtype (float32 or bfloat16); lse
// (float32 [B, H, T], contiguous, written when its pointer is not null) is what the
// backward (attention_qkv_bwd.cu) recomputes the probabilities from. Dropout drops the
// normalised probabilities, as the JAX kernel (attention.py:125-131): the online softmax
// accumulates the kept e * v while l sums every e, the algebraically identical deferred
// form (:116-123). keep is Philox4x32-10 of (seed, site) at element index
// ((b*H + h)*T + q)*T + k (philox.cuh), whatever the strides and the tiling; threshold 0
// (rate 0, eval) skips it.
//
// What bounds it on this card: at wav2vec2-base's T ~ 199 and d = 64 the bf16 products are
// 11.7 GFLOP at B = 96 (0.012 ms on the tensor cores), the exponentials 45.6 M (~0.011 ms
// on the special-function units) and the bytes 118 MB (0.035 ms): bound by bytes. With
// dropout the mask is the largest arithmetic cost: one Philox4x32-10 call (~80 integer
// instructions) per element would be ~0.25 ms. The design:
//   * FlashAttention-2's structure on mma.sync (mma_tile.cuh, attention_tile.cuh): one
//     block per (b*h, 64 queries), 4 warps of 16 query rows; K/V tiles of 64 keys staged
//     as bf16 in padded shared memory through a cp.async double buffer (never converted);
//     S = Q K^T with K as the "col" operand, the online softmax in the accumulator layout
//     (row max and sum over the quad by shuffles, masked keys at -inf), and the kept
//     probabilities rounded to bf16 in registers as the A fragments of P V, V read by
//     ldmatrix.trans. 46 KB of shared memory and 128 registers keep four blocks an SM.
//   * The mask: each lane draws one run of 32 consecutive keys of one row
//     (philox_keep_run, 9 calls for 32 elements) and the owners take their bits by four
//     shuffles a tile, ~1 call per 3.6 elements against 1 per element before.
//   * float32 keeps this body with the products as FMAs into the same layout (exact f32,
//     no TF32); its probabilities pass through a per-warp shared buffer.
// No wgmma or TMA: at d = 64 and T ~ 199 the tensor-core work is a third of the bytes
// bound, so mma.sync is not the limit; a later redesign may take them for the loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <cstdint>

#include "attention_tile.cuh"

namespace {

using namespace w2v::attn;

// kTrain = false is the eval instantiation (no dropout, no lse); D is the head width.
template <typename T, int D, bool kTrain>
__global__ void __launch_bounds__(kThreads, min_blocks<T>())
attention_fwd_kernel(const T* __restrict__ q, View qs, const T* __restrict__ k, View ks,
                     const T* __restrict__ v, View vs, T* __restrict__ out, View os,
                     float* __restrict__ lse, int heads, int seq, int t_keys, float scale,
                     uint32_t seed, uint32_t site, uint32_t thr, float drop_scale) {
  using Tl = Tile<T, D>;
  constexpr int S = Tl::S;
  extern __shared__ __align__(16) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);
  T* kv_s = q_s + Tl::ELEMS;                               // [stage][K, V]
  float* p_s = reinterpret_cast<float*>(kv_s + 4 * Tl::ELEMS);

  const int bh = blockIdx.x;
  const int b = bh / heads, h = bh - (bh / heads) * heads;
  const int q0 = blockIdx.y * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t2 = 2 * (lane & 3);
  const int wrow = q0 + warp * 16;                         // the warp's first query
  const bool active = wrow < seq;                          // warp-uniform
  const T* k_g = k + b * ks.b + h * ks.h;
  const T* v_g = v + b * vs.b + h * vs.h;
  float* pbuf = p_s + warp * 16 * (kTile + 4);

  stage<T, D>(q_s, q + b * qs.b + h * qs.h, qs.t, q0, seq);
  w2v::cp_async_commit();
  stage<T, D>(kv_s, k_g, ks.t, 0, t_keys);
  stage<T, D>(kv_s + Tl::ELEMS, v_g, vs.t, 0, t_keys);
  w2v::cp_async_commit();

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[n][i] = 0.f;

  const int tiles = (t_keys + kTile - 1) / kTile;
  for (int it = 0; it < tiles; ++it) {
    const int k0 = it * kTile;
    if (it + 1 < tiles) {
      T* next = kv_s + ((it + 1) & 1) * 2 * Tl::ELEMS;
      stage<T, D>(next, k_g, ks.t, k0 + kTile, t_keys);
      stage<T, D>(next + Tl::ELEMS, v_g, vs.t, k0 + kTile, t_keys);
      w2v::cp_async_commit();
      w2v::cp_async_wait<1>();
    } else {
      w2v::cp_async_wait<0>();
    }
    __syncthreads();
    const T* k_t = kv_s + (it & 1) * 2 * Tl::ELEMS;
    const T* v_t = k_t + Tl::ELEMS;
    if (active) {
      float s[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[n][i] = 0.f;
      mma_abt<8, D>(s, q_s + warp * 16 * S, k_t, lane);

      // Online softmax; a tile holds key k0 < t_keys, so its row max is finite.
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const bool ok = k0 + n * 8 + t2 + (i & 1) < t_keys;
          s[n][i] = ok ? s[n][i] * scale : -INFINITY;
          mx[i >> 1] = fmaxf(mx[i >> 1], s[n][i]);
        }
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m[r], quad_max(mx[r]));
        corr[r] = expf(m[r] - m_new);                      // 0 on the first tile (m = -inf)
        m[r] = m_new;
        l[r] *= corr[r];
      }
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) o[n][i] *= corr[i >> 1];
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[n][i] = expf(s[n][i] - m[i >> 1]);             // masked keys give exactly 0
          l[i >> 1] += s[n][i];                            // l sums every e, kept or not
        }
      if (kTrain && thr) {                                 // PV takes only the kept e
        const uint32_t runs = draw_row_runs(
            seed, site, thr, (static_cast<unsigned long long>(bh) * seq + wrow) * seq + k0,
            seq, lane);
        uint32_t keep[2][2];
        row_keep(runs, lane, 0, keep[0]);
        row_keep(runs, lane, 1, keep[1]);
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (!((keep[n >> 2][i >> 1] >> ((n & 3) * 8 + t2 + (i & 1))) & 1u)) s[n][i] = 0.f;
      }
      mma_pv<kTile, D>(o, s, v_t, pbuf, lane);
    }
    __syncthreads();                                       // the stage is free for reuse
  }

  if (!active) return;
  T* o_g = out + b * os.b + h * os.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wrow + (lane >> 2) + 8 * r;
    const float total = quad_sum(l[r]);
    if (row >= seq) continue;
    const float inv = (kTrain ? drop_scale : 1.f) / total;
    if (kTrain && lse != nullptr && (lane & 3) == 0)
      lse[static_cast<size_t>(bh) * seq + row] = m[r] + logf(total);
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      store2(o_g + row * os.t + n * 8 + t2, o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
  }
}

template <typename T, int D>
constexpr int smem_bytes() {
  return 5 * Tile<T, D>::ELEMS * static_cast<int>(sizeof(T)) +
         p_buffer_floats<T, kTile>() * static_cast<int>(sizeof(float));
}

template <typename T, int D, bool kTrain>
int launch_one(const dim3& grid, const T* q, const T* k, const T* v, T* out, float* lse,
               const View* s, int heads, int seq, int t_keys, float scale, uint32_t seed,
               uint32_t site, uint32_t thr, float drop_scale, cudaStream_t stream) {
  // Above 48 KB at some widths: set at every launch, as the attribute is the device's.
  const cudaError_t set = cudaFuncSetAttribute(
      attention_fwd_kernel<T, D, kTrain>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes<T, D>());
  if (set != cudaSuccess) return static_cast<int>(set);
  attention_fwd_kernel<T, D, kTrain><<<grid, kThreads, smem_bytes<T, D>(), stream>>>(
      q, s[0], k, s[1], v, s[2], out, s[3], lse, heads, seq, t_keys, scale, seed, site, thr,
      drop_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, void* lse, const View* s,
           int batch, int heads, int seq, int t_keys, float scale, uint32_t seed, uint32_t site,
           uint32_t thr, float drop_scale, cudaStream_t stream) {
  const dim3 grid(batch * heads, (seq + kRows - 1) / kRows);
  const T *qp = static_cast<const T*>(q), *kp = static_cast<const T*>(k),
          *vp = static_cast<const T*>(v);
  T* op = static_cast<T*>(out);
  if (lse == nullptr && thr == 0)
    return launch_one<T, D, false>(grid, qp, kp, vp, op, nullptr, s, heads, seq, t_keys, scale,
                                seed, site, thr, drop_scale, stream);
  return launch_one<T, D, true>(grid, qp, kp, vp, op, static_cast<float*>(lse), s, heads, seq,
                             t_keys, scale, seed, site, thr, drop_scale, stream);
}

}  // namespace

// C entry point, bound with ctypes. strides: 12 element strides, (b, h, t) of q, k, v and
// out in that order (d contiguous in each). head_dim: 16, 32, 64 or 128. dtype: 0 = float32,
// 1 = bfloat16. lse may be
// null (eval; with thr 0 too, the eval instantiation runs). thr = uint32(rate * (2^32 - 1))
// (0 = no dropout), drop_scale = 1 / (1 - rate). Returns the cudaError_t of the launch
// (0 = launched); the caller raises on anything else.
extern "C" int attention_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
                             const long long* strides, int batch, int heads, int seq,
                             int head_dim, int t_keys, float scale, uint32_t seed,
                             uint32_t site, uint32_t thr, float drop_scale, int dtype,
                             void* stream) {
  if (batch <= 0 || heads <= 0 || seq <= 0 || t_keys <= 0 || t_keys > seq)
    return static_cast<int>(cudaErrorInvalidValue);
  View s[4];
  for (int i = 0; i < 4; ++i) s[i] = View{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = static_cast<int>(cudaErrorInvalidValue);
  on_head_dim(head_dim, [&](auto dim) {
    constexpr int D = decltype(dim)::value;
    if (dtype == 0)
      err = launch<float, D>(q, k, v, out, lse, s, batch, heads, seq, t_keys, scale, seed, site,
                             thr, drop_scale, st);
    if (dtype == 1)
      err = launch<__nv_bfloat16, D>(q, k, v, out, lse, s, batch, heads, seq, t_keys, scale,
                                     seed, site, thr, drop_scale, st);
  });
  return err;
}

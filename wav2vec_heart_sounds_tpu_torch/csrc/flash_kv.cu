// Long-sequence attention with a small head dim (the beamformer's delay predictor) for
// NVIDIA Hopper (sm_90a): an online-softmax forward that saves the row log-sum-exp, and
// the split backward (one dq pass, one dk/dv pass).
//
// Replaces the TPU kernel wav2vec_heart_sounds_tpu/ops/pallas/flash_kv.py::
// flash_attention_kv (_flash_kv_fwd :210; _flash_kv_bwd: the split dq :273 and dkv :284
// kernels, the TPU package's own oracle for its fused backward :258). q, k and v are
// float32 [B, T, H, 8] (the flax attention_fn layout, read in place); for each (b, h):
//
//     o = softmax(q k^T / sqrt(8)) v,   lse = log-sum-exp of the scaled scores ([B, H, T])
//     delta_i = g_i . o_i,   p = exp(q k^T / sqrt(8) - lse),   ds = p (g v^T - delta)
//     dq = ds k / sqrt(8),   dk = ds^T q / sqrt(8),   dv = p^T g
//
// No mask, bias or dropout: the delay predictor has none (the caller raises on them).
//
// What bounds it on this card: at the vest shapes (B = 16, T = 8250, H = 4, d = 8) one
// layer's forward is B H T^2 = 4.36 G scores, each 8 products for q.k, 8 for p.v, one
// exponential and a few adds: ~140 GFLOP of float32 FMA work and 4.36 G exponentials,
// against 34 MB of q/k/v. Nothing of size T x T may touch device memory (17 GB a layer),
// and at d = 8 a score is too little work for the tensor cores' tiles to pay, so the
// kernels are float32 SIMT, bound by the FMA pipes and the exponential unit:
//   * one thread owns one query row (the forward and dq) or one key row (dk/dv): at d = 8
//     its q (or k, v) and its accumulators are 8-16 registers, and the online softmax
//     needs no reduction across threads;
//   * the other side streams through shared memory in tiles of 128 rows with cp.async
//     double buffering (one (b, h) holds 528 KB of K/V, more than a block's 227 KB); every
//     thread reads the same staged row at the same time, a shared-memory broadcast;
//   * scores are scaled by log2(e) / sqrt(8) up front so every exponential is one exp2f;
//     the forward rescales its accumulators once per 16 keys, not per key;
//   * the grid is (B*H, row tiles of 128): 4160 blocks at the vest shapes. The K/V of all
//     (b, h) (34 MB) stay in the 50 MB L2 while 65 blocks sweep each.
// The backward is the split form: no atomics, float32 partials never leave a thread. It
// costs 7 score-shaped dot products per (query, key) pair (q.k and g.v twice, plus ds k,
// ds^T q and p^T g) where the TPU's default fused pass takes 5 with dq held resident.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int D = 8;             // head width: the delay predictor's 32 / 4
constexpr int kRows = 128;       // rows a block owns (threads)
constexpr int kStage = 128;      // rows per staged tile of the other side
constexpr int kChunk = 16;       // forward keys per online-softmax rescale
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = valid ? 16 : 0;               // 0: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Row i of head h of batch b in a [B, T, H, D] tensor.
__device__ __forceinline__ size_t row_offset(int b, int i, int h, int T, int H) {
  return ((static_cast<size_t>(b) * T + i) * H + h) * D;
}

__device__ __forceinline__ void load_row(float (&r)[D], const float* p) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 c = *reinterpret_cast<const float4*>(p + 4);
  r[0] = a.x; r[1] = a.y; r[2] = a.z; r[3] = a.w;
  r[4] = c.x; r[5] = c.y; r[6] = c.z; r[7] = c.w;
}

__device__ __forceinline__ void store_row(float* p, const float (&r)[D], float scale) {
  *reinterpret_cast<float4*>(p) = make_float4(r[0] * scale, r[1] * scale, r[2] * scale,
                                              r[3] * scale);
  *reinterpret_cast<float4*>(p + 4) = make_float4(r[4] * scale, r[5] * scale, r[6] * scale,
                                                  r[7] * scale);
}

__device__ __forceinline__ float dot(const float (&a)[D], const float* b) {
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < D; ++c) s = fmaf(a[c], b[c], s);
  return s;
}

// Stage rows [j0, j0 + kStage) of head (b, h) of two [B, T, H, D] tensors: two 16-byte
// copies per row and tensor, rows past T zero-filled.
__device__ __forceinline__ void stage_pair(float (*xs)[D], float (*ys)[D], const float* x,
                                           const float* y, int b, int h, int j0, int T,
                                           int H) {
  for (int e = threadIdx.x; e < kStage * 2; e += kRows) {
    const int r = e >> 1, half = (e & 1) * 4;
    const int j = j0 + r;
    const bool ok = j < T;
    const size_t off = row_offset(b, ok ? j : 0, h, T, H) + half;
    cp_async16(&xs[r][half], x + off, ok);
    cp_async16(&ys[r][half], y + off, ok);
  }
}

__global__ void __launch_bounds__(kRows)
flash_kv_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ o,
                    float* __restrict__ lse, int H, int T, float score_scale) {
  __shared__ __align__(16) float ks[2][kStage][D];
  __shared__ __align__(16) float vs[2][kStage][D];
  const int bh = blockIdx.x, b = bh / H, h = bh - (bh / H) * H;
  const int row = blockIdx.y * kRows + threadIdx.x;
  const bool live = row < T;

  float qr[D], acc[D];
  if (live) load_row(qr, q + row_offset(b, row, h, T, H));
#pragma unroll
  for (int c = 0; c < D; ++c) {
    qr[c] = live ? qr[c] * score_scale : 0.f;   // scores come out in log2 units
    acc[c] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  const int tiles = (T + kStage - 1) / kStage;
  stage_pair(ks[0], vs[0], k, v, b, h, 0, T, H);
  cp_async_commit();
  for (int tile = 0; tile < tiles; ++tile) {
    const int buf = tile & 1;
    if (tile + 1 < tiles) {
      stage_pair(ks[buf ^ 1], vs[buf ^ 1], k, v, b, h, (tile + 1) * kStage, T, H);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int n = min(kStage, T - tile * kStage);
    for (int j0 = 0; j0 < n; j0 += kChunk) {
      float s[kChunk];
      float cmax = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        s[jj] = j0 + jj < n ? dot(qr, ks[buf][j0 + jj]) : -INFINITY;
        cmax = fmaxf(cmax, s[jj]);
      }
      const float m_new = fmaxf(m, cmax);       // finite: key j0 < n is live
      const float corr = exp2f(m - m_new);      // 0 on the first chunk (m = -inf)
      l *= corr;
#pragma unroll
      for (int c = 0; c < D; ++c) acc[c] *= corr;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const float p = exp2f(s[jj] - m_new);   // masked keys give exactly 0
        l += p;
        const float* vr = vs[buf][j0 + jj];
#pragma unroll
        for (int c = 0; c < D; ++c) acc[c] = fmaf(p, vr[c], acc[c]);
      }
      m = m_new;
    }
    __syncthreads();                            // this buffer is refilled two tiles on
  }
  if (!live) return;
  store_row(o + row_offset(b, row, h, T, H), acc, 1.f / l);
  lse[static_cast<size_t>(bh) * T + row] = (m + log2f(l)) * kLn2;
}

// dq: one thread per query row. Writes delta = g . o for the dk/dv kernel.
__global__ void __launch_bounds__(kRows)
flash_kv_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ o,
                   const float* __restrict__ lse, const float* __restrict__ g,
                   float* __restrict__ dq, float* __restrict__ delta, int H, int T,
                   float score_scale, float scale) {
  __shared__ __align__(16) float ks[2][kStage][D];
  __shared__ __align__(16) float vs[2][kStage][D];
  const int bh = blockIdx.x, b = bh / H, h = bh - (bh / H) * H;
  const int row = blockIdx.y * kRows + threadIdx.x;
  const bool live = row < T;

  float qr[D], gr[D], acc[D];
  float lse2 = 0.f, dl = 0.f;
  if (live) {
    const size_t off = row_offset(b, row, h, T, H);
    float orow[D];
    load_row(qr, q + off);
    load_row(gr, g + off);
    load_row(orow, o + off);
    dl = dot(gr, orow);
    delta[static_cast<size_t>(bh) * T + row] = dl;
    lse2 = lse[static_cast<size_t>(bh) * T + row] * kLog2e;
  }
#pragma unroll
  for (int c = 0; c < D; ++c) {
    qr[c] = live ? qr[c] * score_scale : 0.f;
    gr[c] = live ? gr[c] : 0.f;
    acc[c] = 0.f;
  }

  const int tiles = (T + kStage - 1) / kStage;
  stage_pair(ks[0], vs[0], k, v, b, h, 0, T, H);
  cp_async_commit();
  for (int tile = 0; tile < tiles; ++tile) {
    const int buf = tile & 1;
    if (tile + 1 < tiles) {
      stage_pair(ks[buf ^ 1], vs[buf ^ 1], k, v, b, h, (tile + 1) * kStage, T, H);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int n = min(kStage, T - tile * kStage);
    for (int j = 0; j < n; ++j) {
      const float* kr = ks[buf][j];
      const float p = exp2f(dot(qr, kr) - lse2);
      const float ds = p * (dot(gr, vs[buf][j]) - dl);
#pragma unroll
      for (int c = 0; c < D; ++c) acc[c] = fmaf(ds, kr[c], acc[c]);
    }
    __syncthreads();
  }
  if (live) store_row(dq + row_offset(b, row, h, T, H), acc, scale);
}

// dk, dv: one thread per key row; queries, cotangents, lse and delta stream through.
__global__ void __launch_bounds__(kRows)
flash_kv_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ g,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    float* __restrict__ dk, float* __restrict__ dv, int H, int T,
                    float score_scale, float scale) {
  __shared__ __align__(16) float qs[2][kStage][D];
  __shared__ __align__(16) float gs[2][kStage][D];
  __shared__ float ls[2][kStage];
  __shared__ float es[2][kStage];
  const int bh = blockIdx.x, b = bh / H, h = bh - (bh / H) * H;
  const int row = blockIdx.y * kRows + threadIdx.x;
  const bool live = row < T;
  const float* lse_bh = lse + static_cast<size_t>(bh) * T;
  const float* delta_bh = delta + static_cast<size_t>(bh) * T;

  float kr[D], vr[D], dka[D], dva[D];
  if (live) {
    const size_t off = row_offset(b, row, h, T, H);
    load_row(kr, k + off);
    load_row(vr, v + off);
  }
#pragma unroll
  for (int c = 0; c < D; ++c) {
    kr[c] = live ? kr[c] * score_scale : 0.f;
    vr[c] = live ? vr[c] : 0.f;
    dka[c] = 0.f;
    dva[c] = 0.f;
  }

  auto stage = [&](int buf, int i0) {
    stage_pair(qs[buf], gs[buf], q, g, b, h, i0, T, H);
    for (int r = threadIdx.x; r < kStage; r += kRows) {
      const bool ok = i0 + r < T;
      cp_async4(&ls[buf][r], lse_bh + (ok ? i0 + r : 0), ok);
      cp_async4(&es[buf][r], delta_bh + (ok ? i0 + r : 0), ok);
    }
  };

  const int tiles = (T + kStage - 1) / kStage;
  stage(0, 0);
  cp_async_commit();
  for (int tile = 0; tile < tiles; ++tile) {
    const int buf = tile & 1;
    if (tile + 1 < tiles) {
      stage(buf ^ 1, (tile + 1) * kStage);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int n = min(kStage, T - tile * kStage);
    for (int i = 0; i < n; ++i) {
      const float* qi = qs[buf][i];
      const float* gi = gs[buf][i];
      const float p = exp2f(dot(kr, qi) - ls[buf][i] * kLog2e);
      const float ds = p * (dot(vr, gi) - es[buf][i]);
#pragma unroll
      for (int c = 0; c < D; ++c) {
        dva[c] = fmaf(p, gi[c], dva[c]);
        dka[c] = fmaf(ds, qi[c], dka[c]);
      }
    }
    __syncthreads();
  }
  if (!live) return;
  const size_t off = row_offset(b, row, h, T, H);
  store_row(dk + off, dka, scale);
  store_row(dv + off, dva, 1.f);
}

bool bad_shape(int batch, int heads, int T, int head_dim) {
  return batch <= 0 || heads <= 0 || T <= 0 || head_dim != D ||
         static_cast<long long>(batch) * heads > 2147483647LL || (T + kRows - 1) / kRows > 65535;
}

dim3 grid(int batch, int heads, int T) { return dim3(batch * heads, (T + kRows - 1) / kRows); }

}  // namespace

// C entry points, bound with ctypes. q, k, v, o, g, dq, dk, dv: float32 [B, T, H, 8],
// contiguous and 16-byte aligned; lse, delta: float32 [B, H, T]. scale = 1 / sqrt(8).
// Each returns the cudaError_t of its launch (0 = launched).
extern "C" int flash_kv_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                            int batch, int T, int heads, int head_dim, float scale,
                            void* stream) {
  if (bad_shape(batch, heads, T, head_dim)) return static_cast<int>(cudaErrorInvalidValue);
  flash_kv_fwd_kernel<<<grid(batch, heads, T), kRows, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), static_cast<float*>(lse), heads, T, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int flash_kv_dq(const void* q, const void* k, const void* v, const void* o,
                           const void* lse, const void* g, void* dq, void* delta, int batch,
                           int T, int heads, int head_dim, float scale, void* stream) {
  if (bad_shape(batch, heads, T, head_dim)) return static_cast<int>(cudaErrorInvalidValue);
  flash_kv_dq_kernel<<<grid(batch, heads, T), kRows, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(o), static_cast<const float*>(lse),
      static_cast<const float*>(g), static_cast<float*>(dq), static_cast<float*>(delta), heads,
      T, scale * kLog2e, scale);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int flash_kv_dkv(const void* q, const void* k, const void* v, const void* g,
                            const void* lse, const void* delta, void* dk, void* dv, int batch,
                            int T, int heads, int head_dim, float scale, void* stream) {
  if (bad_shape(batch, heads, T, head_dim)) return static_cast<int>(cudaErrorInvalidValue);
  flash_kv_dkv_kernel<<<grid(batch, heads, T), kRows, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(g), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dk), static_cast<float*>(dv), heads,
      T, scale * kLog2e, scale);
  return static_cast<int>(cudaGetLastError());
}

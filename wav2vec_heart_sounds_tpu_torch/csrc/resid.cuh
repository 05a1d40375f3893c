// Device code of the residual tail LayerNorm(x + dropout(h)) (K2), shared by resid.cu and
// by the FFN sublayer ffn_mega.cu: its backward adds the column sums of dh (the
// output-dense bias gradient) to the same row pass, and its bfloat16 forward ends with the
// row LayerNorm alone (ln_rows_kernel).
//
// Contract (the plain version in ops/kernels/resid.py):
//   forward:  s = round_T(x + keep ? h * scale : 0)   (the sum rounded to the compute dtype)
//             out = (s - mean) * rsqrt(var + eps) * gamma + beta, float32 statistics over
//             the row (var = E[s^2] - E[s]^2, clamped at 0); writes out and s.
//   backward: from s and g: ds = rstd * (g*gamma - mean(g*gamma) - shat * mean(g*gamma*shat)),
//             dx = ds, dh = keep ? ds * scale : 0, and one partial row per block of the sums
//             over its rows of g * shat (dgamma), g (dbeta) and, with kDhSums, the rounded dh
//             (the bias gradient of the product that made h). Partials, not atomics, so every
//             run and the comparison with the plain version reproduce.
// Rows are any width up to 1024 columns (wav2vec2-large's hidden size) that is a whole
// number of 16-byte runs: a multiple of 8 columns in bfloat16, of 4 in float32, and 1280
// (XLS-R 1B's). 768 columns (wav2vec2-base's) and 1280 take unguarded instantiations of their
// own width; every other width the guarded one.
//
// Pre-norm form (kStream, resid_prenorm_bwd and K4's pre-norm backward): the forward is the
// same, with s the residual stream and out the next sublayer's input; the backward also takes
// gs, the stream's own gradient, and its ds is the LayerNorm's gradient plus gs (float32),
// so dx = round(ds) and dh = keep ? ds * scale : 0.
//
// What bounds it: bytes. The forward reads h and x and writes out and s, the backward reads g
// and s and writes dx and dh: 4 x 29 MB a pass at [96*199, 768] bf16, ~35 us at 3.35 TB/s.
// Philox (one call per four elements) and the row statistics are ~2-4x below that. So the
// design keeps bytes in flight while warps reduce:
// - a persistent grid (one or two blocks an SM, the wrapper's count from the occupancy API):
//   block b walks tiles b, b + grid, ... of R consecutive rows;
// - eight warps, one row each per tile: a lane reads runs of 16 bytes (8 bf16 or 4 f32) at
//   N (lane + 32 i) of the row, takes each run's mask from philox_keep_aligned (the element's
//   row-major index, as before: the same bits), and writes 16-byte stores. gamma and beta sit
//   in shared memory for the block's life;
// - the backward streams each tile of g and s, one contiguous range of R * cols * size bytes
//   per input, with a 1D bulk copy (cp.async.bulk, no tensor map, issued by thread 0) into an
//   S-slot ring in shared memory: `full` barriers completed by the copies' byte counts,
//   `empty` barriers arrived at by the warps, so the next S - 1 tiles' copies are in flight
//   while a tile is reduced. It reads each row three times (statistics, the two row sums,
//   the outputs), which the ring serves from shared memory. The forward reads each row once
//   into registers, straight from global memory with 16-byte loads;
// - the backward's column sums are per-lane float32 registers over all rows a block takes,
//   summed over its warps in a fixed order into one partial row per block at the end: the
//   partials are [blocks, cols] with blocks ~132-264, not [1024, cols].
// The configuration (R, S, which passes use the ring, bulk stores, blocks an SM) is fixed when
// the library is built (the W2V_RESID_* macros below); scripts/torch_kernel_check.py --resid
// builds resid.cu again with other values for its ablation. Measured on the H100 (bf16
// [19104, 768], rate 0.1, device time): with the ring the forward took 0.0498-0.0502 ms and
// without it 0.0484-0.0485, the backward 0.0575-0.0577 with the ring and 0.0600-0.0603
// without; 2 or 3 slots, 16-row tiles, bulk stores or three blocks an SM were slower in both.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "gelu.cuh"
#include "mbarrier.cuh"
#include "philox.cuh"

// The build's configuration (the defaults are what the port runs).
#ifndef W2V_RESID_ROWS
#define W2V_RESID_ROWS 8          // R: rows a tile
#endif
#ifndef W2V_RESID_STAGES
#define W2V_RESID_STAGES 4        // S: ring slots in bfloat16 (float32 takes 2: 48 KB each)
#endif
#ifndef W2V_RESID_FWD_RING
#define W2V_RESID_FWD_RING 0      // the forward's rows through the ring (else 16-byte loads)
#endif
#ifndef W2V_RESID_BWD_RING
#define W2V_RESID_BWD_RING 1      // the backward's
#endif
#ifndef W2V_RESID_BULK_STORE
#define W2V_RESID_BULK_STORE 0    // a ring pass's outputs staged in place, written by bulk stores
#endif
#ifndef W2V_RESID_MIN_BLOCKS
#define W2V_RESID_MIN_BLOCKS 2    // blocks an SM the register budget must allow
#endif

namespace w2v {

constexpr int kResidFullCols = 768;                        // the unguarded instantiation's rows
constexpr int kResidMaxCols = 1024;                        // the widest row (guarded)
constexpr int kResidWideCols = 1280;                       // a second unguarded width (XLS-R 1B)
constexpr int kResidWarps = 8;                             // a row each per tile
constexpr int kResidThreads = kResidWarps * 32;
constexpr int kResidBarHeader = 128;                       // dynamic smem: the barriers first

// An instance's row width: kCols columns exactly, or 0 for the guarded instance (up to
// kResidMaxCols). Its gamma and beta sit in shared memory for this many columns each.
template <int kCols>
__host__ __device__ constexpr int resid_vec_cols() {
  return kCols > kResidMaxCols ? kCols : kResidMaxCols;
}
template <int kCols>
__host__ __device__ constexpr int resid_vec_bytes() {      // gamma and beta, float32
  return 2 * resid_vec_cols<kCols>() * 4;
}
// Blocks an SM an instance's register budget must allow: the wide rows' sums take one.
template <int kCols>
__host__ __device__ constexpr int resid_min_blocks() {
  return kCols > kResidMaxCols ? 1 : W2V_RESID_MIN_BLOCKS;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Rows of 16-byte runs (Run16<T>, gelu.cuh), up to kResidMaxCols columns.
template <typename T>
inline bool resid_bad_shape(int rows, int cols, int blocks) {
  return rows <= 0 || cols <= 0 || cols % (16 / static_cast<int>(sizeof(T))) ||
         (cols > kResidMaxCols && cols != kResidWideCols) || blocks <= 0;
}

// Passes of 32 runs of N columns that a lane makes over a row: kCols in an unguarded
// instantiation, up to kResidMaxCols in the guarded one (kCols = 0).
template <int N, int kCols>
__host__ __device__ constexpr int resid_passes() {
  return (kCols ? kCols : kResidMaxCols) / (32 * N);
}

// The keep bits of the run of N elements at row-major index `index` (a multiple of N): one
// Philox call per four elements, none at rate 0.
template <int N>
__device__ __forceinline__ uint32_t run_keep(uint32_t seed, uint32_t site, size_t index,
                                             uint32_t thr) {
  return thr ? philox_keep_aligned<N>(seed, site, static_cast<unsigned long long>(index), thr)
             : (1u << N) - 1u;
}

// gamma and beta in shared memory in the order the lanes read them: the 4-column quarter h
// of the run `run` of N columns sits at float4 slot ((run / 32) (N / 4) + h) 32 + run % 32,
// so the lanes of a pass read consecutive 16-byte slots (no bank conflict); in float32 that
// is the plain order.
template <int N>
__device__ __forceinline__ int vec_slot(int col) {
  const int run = col / N, h = (col % N) / 4;
  return (((run >> 5) * (N / 4) + h) * 32 + (run & 31)) * 4 + col % 4;
}

template <int N>
__device__ __forceinline__ void load_vec(const float* v, int pass, int lane, float (&out)[N]) {
#pragma unroll
  for (int h = 0; h < N / 4; ++h) {
    const float4 q = reinterpret_cast<const float4*>(v)[(pass * (N / 4) + h) * 32 + lane];
    out[4 * h] = q.x;
    out[4 * h + 1] = q.y;
    out[4 * h + 2] = q.z;
    out[4 * h + 3] = q.w;
  }
}

constexpr int kResidRows = W2V_RESID_ROWS;
template <typename T>
constexpr int kResidStages = sizeof(T) == 2 ? W2V_RESID_STAGES : 2;
constexpr bool kResidFwdRing = W2V_RESID_FWD_RING;
constexpr bool kResidBwdRing = W2V_RESID_BWD_RING;
constexpr bool kResidBulkStore = W2V_RESID_BULK_STORE;

// The ring and the block's vectors in dynamic shared memory: barriers, then gamma and beta
// (float32, in vec_slot order, V columns each), then S slots of two [R, cols] tiles (h and x,
// or g and s).
template <typename T, int V = kResidMaxCols>
struct ResidSmem {
  unsigned char* base;
  int cols;
  static constexpr int R = kResidRows, S = kResidStages<T>;
  __device__ __forceinline__ uint64_t* full(int s) const {
    return reinterpret_cast<uint64_t*>(base) + s;
  }
  __device__ __forceinline__ uint64_t* empty(int s) const { return full(S) + s; }
  __device__ __forceinline__ float* gamma() const {
    return reinterpret_cast<float*>(base + kResidBarHeader);
  }
  __device__ __forceinline__ float* beta() const { return gamma() + V; }
  __device__ __forceinline__ unsigned char* after_vectors() const {
    return base + kResidBarHeader + 2 * V * 4;
  }
  __device__ __forceinline__ T* tile(int s, int which) const {
    return reinterpret_cast<T*>(after_vectors()) + (static_cast<size_t>(2 * s + which) * R) * cols;
  }
};

// The block's tiles and, with kRing, their passage through the ring. The block takes tiles
// blockIdx.x + k gridDim.x, k < count; tile k sits in slot k % S. Thread 0 issues the copies:
// tiles 0 .. S - 2 up front, then tile k + S - 1 as the block starts tile k, once every warp
// has released that slot (its tile k - 1): the copies of the next S - 1 tiles are in flight
// while a tile is reduced.
template <typename T, bool kRing, int V = kResidMaxCols>
struct ResidRing {
  static constexpr int R = kResidRows, S = kResidStages<T>;
  const ResidSmem<T, V>& sm;
  const T* a;
  const T* b;
  int rows, cols, count;

  __device__ __forceinline__ ResidRing(const ResidSmem<T, V>& sm_, const T* a_, const T* b_,
                                       int rows_, int cols_)
      : sm(sm_), a(a_), b(b_), rows(rows_), cols(cols_) {
    const int tiles = (rows + R - 1) / R;
    count = tiles > static_cast<int>(blockIdx.x)
                ? (tiles - 1 - static_cast<int>(blockIdx.x)) / static_cast<int>(gridDim.x) + 1
                : 0;
  }
  __device__ __forceinline__ int row0(int k) const {
    return (static_cast<int>(blockIdx.x) + k * static_cast<int>(gridDim.x)) * R;
  }
  __device__ __forceinline__ int nrows(int k) const {
    return rows - row0(k) < R ? rows - row0(k) : R;
  }
  // Row r of tile k of input `which` (0: a, 1: b): in its ring slot, or in global memory.
  __device__ __forceinline__ T* row(int k, int which, int r) const {
    if constexpr (kRing) return sm.tile(k % S, which) + static_cast<size_t>(r) * cols;
    return const_cast<T*>(which ? b : a) + static_cast<size_t>(row0(k) + r) * cols;
  }
  __device__ __forceinline__ void issue(int k) const {
    const int s = k % S;
    if (k >= S) mbar_wait(sm.empty(s), ((k / S) - 1) & 1);   // its previous tile released
    const uint32_t bytes = static_cast<uint32_t>(nrows(k) * cols * sizeof(T));
    const size_t first = static_cast<size_t>(row0(k)) * cols;
    mbar_expect_tx(sm.full(s), 2 * bytes);
    bulk_load(sm.tile(s, 0), a + first, bytes, sm.full(s));
    bulk_load(sm.tile(s, 1), b + first, bytes, sm.full(s));
  }
  __device__ __forceinline__ void prologue() const {
    if constexpr (kRing)
      if (threadIdx.x == 0)
        for (int k = 0; k < S - 1 && k < count; ++k) issue(k);
  }
  // Tile k's rows in shared memory: the next copy issued, then the wait for tile k.
  __device__ __forceinline__ void acquire(int k) const {
    if constexpr (kRing) {
      if (threadIdx.x == 0 && k + S - 1 < count) issue(k + S - 1);
      mbar_wait(sm.full(k % S), (k / S) & 1);
    }
  }
  __device__ __forceinline__ void release(int k) const {
    if constexpr (kRing) {
      __syncwarp();
      if ((threadIdx.x & 31) == 0) mbar_arrive(sm.empty(k % S));
    }
  }
};

// Block set-up: the ring's barriers, and gamma (and beta) into shared memory.
template <typename T, bool kRing, int V>
__device__ __forceinline__ void resid_setup(const ResidSmem<T, V>& sm, const float* gamma,
                                            const float* beta, int cols) {
  if (kRing && threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < ResidSmem<T, V>::S; ++s) {
      mbar_init(sm.full(s), 1);
      mbar_init(sm.empty(s), kResidWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  constexpr int N = Run16<T>::N;
  for (int c = threadIdx.x; c < cols; c += kResidThreads) {
    sm.gamma()[vec_slot<N>(c)] = gamma[c];
    if (beta != nullptr) sm.beta()[vec_slot<N>(c)] = beta[c];
  }
  __syncthreads();
}

// Forward. kCols: rows of kCols columns (every lane has a run in every pass, no guard), or 0
// for the guarded rows. With bulk stores, s and out are staged in place of h and x.
template <typename T, int kCols>
__global__ void __launch_bounds__(kResidThreads, resid_min_blocks<kCols>())
resid_fwd_kernel(const T* __restrict__ h, const T* __restrict__ x,
                 const float* __restrict__ gamma, const float* __restrict__ beta,
                 T* __restrict__ out, T* __restrict__ s_out, int rows, int cols, float eps,
                 uint32_t seed, uint32_t site, uint32_t thr, float scale) {
  constexpr bool kRing = kResidFwdRing, kBulkStore = kResidBulkStore && kRing;
  constexpr bool kFull = kCols != 0;
  constexpr int VC = resid_vec_cols<kCols>();
  using V = Run16<T>;
  constexpr int N = V::N;
  constexpr int P = resid_passes<N, kCols>();
  extern __shared__ __align__(16) unsigned char resid_smem[];
  const ResidSmem<T, VC> sm{resid_smem, cols};
  resid_setup<T, kRing>(sm, gamma, beta, cols);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int runs = kFull ? 32 * P : cols / N;
  const float* gs = sm.gamma();
  const float* bs = sm.beta();
  const ResidRing<T, kRing, VC> ring(sm, h, x, rows, cols);
  ring.prologue();
  for (int k = 0; k < ring.count; ++k) {
    ring.acquire(k);
    const int r0 = ring.row0(k), nr = ring.nrows(k);
    for (int r = warp; r < nr; r += kResidWarps) {
      const size_t base = static_cast<size_t>(r0 + r) * cols;
      T* hrow = ring.row(k, 0, r);
      T* xrow = ring.row(k, 1, r);
      float sv[P][N];
      float sum = 0.f, sq = 0.f;
#pragma unroll
      for (int i = 0; i < P; ++i) {
        const int run = lane + 32 * i;
        if (!kFull && run >= runs) break;
        const int col = N * run;
        uint4 hr, xr;
        if constexpr (kRing) {
          hr = *reinterpret_cast<const uint4*>(hrow + col);
          xr = *reinterpret_cast<const uint4*>(xrow + col);
        } else {
          hr = __ldg(reinterpret_cast<const uint4*>(hrow + col));
          xr = __ldg(reinterpret_cast<const uint4*>(xrow + col));
        }
        float hv[N], xv[N];
        V::unpack(hr, hv);
        V::unpack(xr, xv);
        const uint32_t keep = run_keep<N>(seed, site, base + col, thr);
#pragma unroll
        for (int j = 0; j < N; ++j) {
          // __fmul_rn: never contracted into an FMA with the add, so s rounds as the plain
          // version's separate multiply and add do.
          const float d = (keep >> j) & 1u ? __fmul_rn(hv[j], scale) : 0.f;
          const float s = round_to<T>(xv[j] + d);
          sv[i][j] = s;
          sum += s;
          sq += s * s;
        }
        if constexpr (kBulkStore)
          *reinterpret_cast<uint4*>(hrow + col) = V::pack(sv[i]);
        else
          *reinterpret_cast<uint4*>(s_out + base + col) = V::pack(sv[i]);
      }
      const float mean = warp_sum(sum) / cols;
      const float var = fmaxf(warp_sum(sq) / cols - mean * mean, 0.f);
      const float rstd = rsqrtf(var + eps);
#pragma unroll
      for (int i = 0; i < P; ++i) {
        const int run = lane + 32 * i;
        if (!kFull && run >= runs) break;
        const int col = N * run;
        float o[N], gv[N], bv[N];
        load_vec<N>(gs, i, lane, gv);
        load_vec<N>(bs, i, lane, bv);
#pragma unroll
        for (int j = 0; j < N; ++j) o[j] = (sv[i][j] - mean) * rstd * gv[j] + bv[j];
        if constexpr (kBulkStore)
          *reinterpret_cast<uint4*>(xrow + col) = V::pack(o);
        else
          *reinterpret_cast<uint4*>(out + base + col) = V::pack(o);
      }
      if constexpr (kBulkStore) {
        fence_proxy_async();
        __syncwarp();
        if (lane == 0) {
          const uint32_t bytes = static_cast<uint32_t>(cols * sizeof(T));
          bulk_store(s_out + base, hrow, bytes);
          bulk_store(out + base, xrow, bytes);
          bulk_commit();
          bulk_wait_read();
        }
      }
    }
    ring.release(k);
  }
}

// Backward; kCols as in the forward. kStream: the pre-norm form, gs (the stream's gradient)
// added to ds. With bulk stores, dx and dh are staged in place of g and s.
template <typename T, bool kDhSums, int kCols, bool kStream = false>
__global__ void __launch_bounds__(kResidThreads, resid_min_blocks<kCols>())
resid_bwd_kernel(const T* __restrict__ g, const T* __restrict__ s,
                 const float* __restrict__ gamma, T* __restrict__ dh, T* __restrict__ dx,
                 float* __restrict__ dgamma_part, float* __restrict__ dbeta_part,
                 float* __restrict__ dh_part, int rows, int cols, float eps, uint32_t seed,
                 uint32_t site, uint32_t thr, float scale, const T* __restrict__ g_stream) {
  constexpr bool kRing = kResidBwdRing, kBulkStore = kResidBulkStore && kRing;
  constexpr bool kFull = kCols != 0;
  constexpr int VC = resid_vec_cols<kCols>();
  using V = Run16<T>;
  constexpr int N = V::N;
  constexpr int P = resid_passes<N, kCols>();
  constexpr int kSums = kDhSums ? 3 : 2;
  extern __shared__ __align__(16) unsigned char resid_smem[];
  const ResidSmem<T, VC> sm{resid_smem, cols};
  resid_setup<T, kRing>(sm, gamma, nullptr, cols);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int runs = kFull ? 32 * P : cols / N;
  const float* gm = sm.gamma();
  float acc[kSums][P][N];           // sums of g, g * shat (and the rounded dh) by column
#pragma unroll
  for (int a = 0; a < kSums; ++a)
#pragma unroll
    for (int i = 0; i < P; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j) acc[a][i][j] = 0.f;

  const ResidRing<T, kRing, VC> ring(sm, g, s, rows, cols);
  ring.prologue();
  for (int k = 0; k < ring.count; ++k) {
    ring.acquire(k);
    const int r0 = ring.row0(k), nr = ring.nrows(k);
    for (int r = warp; r < nr; r += kResidWarps) {
      const size_t base = static_cast<size_t>(r0 + r) * cols;
      T* grow = ring.row(k, 0, r);
      T* srow = ring.row(k, 1, r);
      auto load = [&](const T* row, int col) -> uint4 {
        if constexpr (kRing) return *reinterpret_cast<const uint4*>(row + col);
        else return __ldg(reinterpret_cast<const uint4*>(row + col));
      };
      float sum = 0.f, sq = 0.f;
#pragma unroll
      for (int i = 0; i < P; ++i) {
        const int run = lane + 32 * i;
        if (!kFull && run >= runs) break;
        float sv[N];
        V::unpack(load(srow, N * run), sv);
#pragma unroll
        for (int j = 0; j < N; ++j) {
          sum += sv[j];
          sq += sv[j] * sv[j];
        }
      }
      const float mean = warp_sum(sum) / cols;
      const float var = fmaxf(warp_sum(sq) / cols - mean * mean, 0.f);
      const float rstd = rsqrtf(var + eps);
      float a = 0.f, b = 0.f;               // sums of g*gamma and g*gamma*shat
#pragma unroll
      for (int i = 0; i < P; ++i) {
        const int run = lane + 32 * i;
        if (!kFull && run >= runs) break;
        const int col = N * run;
        float sv[N], gv[N], wv[N];
        V::unpack(load(srow, col), sv);
        V::unpack(load(grow, col), gv);
        load_vec<N>(gm, i, lane, wv);
#pragma unroll
        for (int j = 0; j < N; ++j) {
          const float shat = (sv[j] - mean) * rstd;
          const float gs = gv[j] * wv[j];
          a += gs;
          b += gs * shat;
          acc[0][i][j] += gv[j];
          acc[1][i][j] += gv[j] * shat;
        }
      }
      const float mean_gs = warp_sum(a) / cols;
      const float mean_gss = warp_sum(b) / cols;
#pragma unroll
      for (int i = 0; i < P; ++i) {
        const int run = lane + 32 * i;
        if (!kFull && run >= runs) break;
        const int col = N * run;
        float sv[N], gv[N], wv[N], dsv[N], dhv[N], gsv[N];
        V::unpack(load(srow, col), sv);
        V::unpack(load(grow, col), gv);
        load_vec<N>(gm, i, lane, wv);
        if constexpr (kStream) {
          const uint4 raw = __ldg(reinterpret_cast<const uint4*>(g_stream + base + col));
          V::unpack(raw, gsv);
        }
        const uint32_t keep = run_keep<N>(seed, site, base + col, thr);
#pragma unroll
        for (int j = 0; j < N; ++j) {
          const float shat = (sv[j] - mean) * rstd;
          const float gs = gv[j] * wv[j];
          dsv[j] = rstd * (gs - mean_gs - shat * mean_gss);
          if constexpr (kStream) dsv[j] += gsv[j];
          dhv[j] = (keep >> j) & 1u ? dsv[j] * scale : 0.f;
          if (kDhSums) acc[kSums - 1][i][j] += round_to<T>(dhv[j]);
        }
        if constexpr (kBulkStore) {
          *reinterpret_cast<uint4*>(grow + col) = V::pack(dsv);
          *reinterpret_cast<uint4*>(srow + col) = V::pack(dhv);
        } else {
          *reinterpret_cast<uint4*>(dx + base + col) = V::pack(dsv);
          *reinterpret_cast<uint4*>(dh + base + col) = V::pack(dhv);
        }
      }
      if constexpr (kBulkStore) {
        fence_proxy_async();
        __syncwarp();
        if (lane == 0) {
          const uint32_t bytes = static_cast<uint32_t>(cols * sizeof(T));
          bulk_store(dx + base, grow, bytes);
          bulk_store(dh + base, srow, bytes);
          bulk_commit();
          bulk_wait_read();
        }
      }
    }
    ring.release(k);
  }

  // One partial row per block: the warps' sums added in warp order, through [8, cols] floats
  // of shared memory after the last tile (the ring's first slot, idle once every warp is past
  // its last tile; without a ring the launch reserves them).
  float* red = reinterpret_cast<float*>(sm.after_vectors());
  float* parts[3] = {dbeta_part, dgamma_part, dh_part};
  __syncthreads();
#pragma unroll
  for (int a = 0; a < kSums; ++a) {
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const int run = lane + 32 * i;
      if (!kFull && run >= runs) break;
      float* dst = red + warp * cols + N * run;
#pragma unroll
      for (int q = 0; q < N; q += 4)
        *reinterpret_cast<float4*>(dst + q) =
            make_float4(acc[a][i][q], acc[a][i][q + 1], acc[a][i][q + 2], acc[a][i][q + 3]);
    }
    __syncthreads();
    for (int c = threadIdx.x; c < cols; c += kResidThreads) {
      float p = 0.f;
#pragma unroll
      for (int w = 0; w < kResidWarps; ++w) p += red[w * cols + c];
      parts[a][static_cast<size_t>(blockIdx.x) * cols + c] = p;
    }
    __syncthreads();
  }
}

// ---- host: the launches ------------------------------------------------------------------

// Dynamic shared memory of a launch: barriers and vectors, then the ring's slots (a ring pass)
// and the backward's [8, cols] reduction, which reuses the first slot.
template <typename T>
inline int resid_smem(bool ring, bool backward, int cols) {
  const int slots =
      ring ? 2 * kResidStages<T> * kResidRows * cols * static_cast<int>(sizeof(T)) : 0;
  const int red = backward ? kResidWarps * cols * 4 : 0;
  const int vec = cols == kResidWideCols ? resid_vec_bytes<kResidWideCols>()
                                         : resid_vec_bytes<0>();
  return kResidBarHeader + vec + (slots > red ? slots : red);
}

// The grid of a persistent launch of `kernel`: as many blocks as fit on the `sms` SMs (by the
// occupancy API at `smem` bytes, at most 4 an SM), at most one per tile.
template <class K>
inline int resid_grid(K kernel, int smem, int sms, int rows) {
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) !=
      cudaSuccess)
    return -1;
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kResidThreads, smem) !=
      cudaSuccess)
    return -1;
  per_sm = per_sm < 1 ? 1 : (per_sm > 4 ? 4 : per_sm);
  const int tiles = (rows + kResidRows - 1) / kResidRows;
  return tiles < sms * per_sm ? tiles : sms * per_sm;
}

template <class K, class... Args>
inline cudaError_t resid_launch(K kernel, int smem, int blocks, cudaStream_t st, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kResidThreads, smem, st>>>(args...);
  return cudaGetLastError();
}

// The forward's and the backward's launches: the unguarded instantiations for rows of
// kResidFullCols and kResidWideCols columns, the guarded one for every other width.
template <typename T>
struct ResidFwd {
  static auto kernel(int cols) {
    return cols == kResidFullCols   ? &resid_fwd_kernel<T, kResidFullCols>
           : cols == kResidWideCols ? &resid_fwd_kernel<T, kResidWideCols>
                                    : &resid_fwd_kernel<T, 0>;
  }
  static int smem(int cols) { return resid_smem<T>(kResidFwdRing, false, cols); }
  static int grid(int rows, int cols, int sms) {
    return resid_grid(kernel(cols), smem(cols), sms, rows);
  }
  template <class... Args>
  static cudaError_t launch(int cols, int blocks, cudaStream_t st, Args... args) {
    return resid_launch(kernel(cols), smem(cols), blocks, st, args...);
  }
};

template <typename T, bool kDhSums, bool kStream = false>
struct ResidBwd {
  static auto kernel(int cols) {
    return cols == kResidFullCols   ? &resid_bwd_kernel<T, kDhSums, kResidFullCols, kStream>
           : cols == kResidWideCols ? &resid_bwd_kernel<T, kDhSums, kResidWideCols, kStream>
                                    : &resid_bwd_kernel<T, kDhSums, 0, kStream>;
  }
  static int smem(int cols) { return resid_smem<T>(kResidBwdRing, true, cols); }
  static int grid(int rows, int cols, int sms) {
    return resid_grid(kernel(cols), smem(cols), sms, rows);
  }
  template <class... Args>
  static cudaError_t launch(int cols, int blocks, cudaStream_t st, Args... args) {
    return resid_launch(kernel(cols), smem(cols), blocks, st, args...);
  }
};

// The row LayerNorm alone, out = (s - mean) * rsqrt(var + eps) * gamma + beta over rows of s
// (the K4 forward's last pass, after its (B) epilogue formed s): the statistics of
// resid_fwd_kernel (float32, var = E[s^2] - E[s]^2 clamped at 0, warp sums in a fixed
// order). One warp a row; a lane reads runs of 16 bytes at N (lane + 32 i), so a row of up to
// kResidMaxCols columns, a whole number of runs, is read once into registers. kCols as in
// resid_fwd_kernel: rows of kCols columns, no guard, or 0 for the guarded rows.
constexpr int kLnWarps = 4;
constexpr int kLnThreads = kLnWarps * 32;

template <typename T, int kCols>
__global__ void __launch_bounds__(kLnThreads)
ln_rows_kernel(const T* __restrict__ s, const float* __restrict__ gamma,
               const float* __restrict__ beta, T* __restrict__ out, int rows, int cols,
               float eps) {
  constexpr bool kFull = kCols != 0;
  using V = Run16<T>;
  constexpr int N = V::N;
  constexpr int P = resid_passes<N, kCols>();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int runs = cols / N;
  for (int row = blockIdx.x * kLnWarps + warp; row < rows;
       row += gridDim.x * kLnWarps) {
    const size_t base = static_cast<size_t>(row) * cols;
    float v[P][N];
    float sum = 0.f, sq = 0.f;
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const int run = lane + 32 * i;
      if (!kFull && run >= runs) break;
      // One 16-byte load into a register first (unpacking through a reference to global
      // memory splits it into 4-byte loads).
      const uint4 raw = *reinterpret_cast<const uint4*>(s + base + N * run);
      V::unpack(raw, v[i]);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        sum += v[i][j];
        sq += v[i][j] * v[i][j];
      }
    }
    const float mean = warp_sum(sum) / cols;
    const float var = fmaxf(warp_sum(sq) / cols - mean * mean, 0.f);
    const float rstd = rsqrtf(var + eps);
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const int run = lane + 32 * i;
      if (!kFull && run >= runs) break;
      const int col = N * run;
      float o[N];
#pragma unroll
      for (int j = 0; j < N; ++j)
        o[j] = (v[i][j] - mean) * rstd * gamma[col + j] + beta[col + j];
      *reinterpret_cast<uint4*>(out + base + col) = V::pack(o);
    }
  }
}

// The row LayerNorm's instance for rows of `cols` columns (as ResidFwd picks).
template <typename T>
inline auto ln_rows_for(int cols) {
  return cols == kResidFullCols   ? &ln_rows_kernel<T, kResidFullCols>
         : cols == kResidWideCols ? &ln_rows_kernel<T, kResidWideCols>
                                  : &ln_rows_kernel<T, 0>;
}

}  // namespace w2v

// Long-sequence attention with a small head dim (the beamformer's delay predictor) for
// NVIDIA Hopper (sm_90a): an online-softmax forward that saves the row log-sum-exp, and the
// fused one-pass backward, every product on the tensor cores at float32 accuracy.
//
// Replaces the TPU kernel wav2vec_heart_sounds_tpu/ops/pallas/flash_kv.py::
// flash_attention_kv (_flash_kv_fwd :210; _flash_kv_bwd: the fused pass _bwd_fused_kernel
// :138, called at :258, the TPU package's default backward). q, k and v are float32
// [B, T, H, 8] (the flax attention_fn layout, read in place); for each (b, h):
//
//     o = softmax(q k^T / sqrt(8)) v,   lse = log-sum-exp of the scaled scores ([B, H, T])
//     delta_i = g_i . o_i,   p = exp(q k^T / sqrt(8) - lse),   ds = p (g v^T - delta)
//     dq = ds k / sqrt(8),   dk = ds^T q / sqrt(8),   dv = p^T g
//
// No mask, bias or dropout: the delay predictor has none (the caller raises on them).
//
// What bounds it on this card: at the vest shapes (B = 16, T = 8250, H = 4, d = 8) one
// layer has B H T^2 = 4.36 G (query, key) pairs. Nothing of size T x T may touch device
// memory (17 GB a layer). Each pair costs one exponential, 16 products forward and 40
// backward (2 d FLOPs per score-shaped product: 2 forward, 5 backward). d = 8 is exactly
// the k of mma.m16n8k8 in TF32, so the products run on the tensor cores. One TF32 product
// keeps ~11 bits, which misses float32's bars, so each product is 3xTF32: hi = x truncated
// to TF32 (one AND: cvt.rna.tf32.f32 is a five-instruction sequence here), lo = x - hi,
// a b ~ lo_a hi_b + hi_a lo_b + hi_a hi_b (tests/test_torch_flash_kv.py models it). That is
// 96 (forward) and 240 (backward) tensor FLOPs a pair: 6 and 15 mma.sync per 16 x 8 tile of
// pairs. The 4.36 G exponentials take 1.04 ms on the special-function units (16 a clock an
// SM), the bound of both halves at the data-sheet rates. On the card the mma.sync stream
// sets the pace instead: leaving out two thirds of it takes a third off either half, while
// leaving out the exponentials takes under a tenth (scripts/torch_k6_ablation.py). So every
// product is issued once (the backward is the fused pass), operands are split once when
// staged, fragments are read from shared memory with 16-byte loads and reused across two
// m16 tiles, and sums that the tensor cores would truncate are carried in float32.
//
// Forward: a block owns 256 queries of one (b, h) (8 warps x 2 m16 tiles); K and V stream
// through shared memory in tiles of 32 keys, fetched into registers one tile ahead, split
// into hi/lo once and stored in fragment order, one thread a fragment slot (one 16-byte
// store; one 16-byte read a lane per 8 keys, shared by the warp's two tiles). The q k^T
// accumulator is reused as the A operand of p v with no shuffles: the C layout gives lane
// (g, t) the columns {2t, 2t + 1}, the TF32 A layout wants {t, t + 4}, so A's columns are
// relabelled t -> key 2t, t + 4 -> key 2t + 1 and V's rows are staged in that order. Scores
// carry log2(e) / sqrt(8) (folded into q) so each exponential is one ex2; they start from a
// staged bias (0, or -inf for a key past T), so the ragged last tile needs no branch; the
// row maximum is taken once per tile with two quad shuffles.
//
// Backward, the fused pass (5 products and 1 exponential a pair): a pre-pass writes
// delta = rowsum(g o). The main kernel runs one block per (b, h, 512 keys): 16 warps, each
// owning 32 keys whose K and V fragments stay in registers. It walks every tile of 64
// queries (Q, G, -lse and -delta staged as above; the score and dp products start from -lse
// and -delta, so p = ex2(s^T) and ds = p dp^T) and computes s^T = k q^T, p^T,
// dv += p^T g, dp^T = v g^T, ds^T, dk += ds^T q once each; dk and dv are summed per tile on
// the tensor cores and across tiles in float32. dq = ds k needs ds with the queries as
// rows, the transpose of the accumulator layout, so each warp stages its ds^T through shared
// memory (unsplit) and reads it back as the A operand, split there; the 16 warps' dq
// contributions are summed in warp order through shared memory, and each block writes one
// float32 partial [n_key_blocks, B, H, T, 8] (17 at T = 8250, 287 MB). A last kernel sums
// the partials in key-block order and applies the scale. No atomics: the backward gives the
// same bits run after run.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int D = 8;                        // head width: the delay predictor's 32 / 4
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

constexpr int kFwdWarps = 8;
constexpr int kFwdBlocks = 2;               // blocks an SM (registers: at most 128 a thread)
constexpr int kFwdThreads = 32 * kFwdWarps;
constexpr int kFwdMt = 2;                   // m16 query tiles a forward warp owns
constexpr int kFwdRows = 16 * kFwdMt * kFwdWarps;   // queries a forward block owns
constexpr int kKeyTile = 32;                // keys per staged forward tile
constexpr int kKeyFrags = kKeyTile / 8;     // 8-key fragments per tile
constexpr int kFwdItems = 8 * kKeyTile / kFwdThreads;  // fragment slots a thread stages
static_assert(kFwdItems * kFwdThreads == 8 * kKeyTile, "a tile's slots must fill the block");

constexpr int kBwdWarps = 16;
constexpr int kBwdBlocks = 1;               // blocks an SM (registers: at most 128 a thread)
constexpr int kWarpKeys = 32;               // keys a backward warp owns (two m16 tiles)
constexpr int kKeyBlock = kBwdWarps * kWarpKeys;   // keys a backward block owns
constexpr int kQueryTile = 64;              // queries per staged backward tile

__device__ __forceinline__ size_t row_offset(int b, int i, int h, int T, int H) {
  return ((static_cast<size_t>(b) * T + i) * H + h) * D;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// x = hi + lo with hi = x truncated to TF32 (one AND; cvt.rna.tf32.f32 is a five-instruction
// sequence on this card) and lo = x - hi exact; the tensor cores read lo's top 19 bits.
__device__ __forceinline__ void split(float x, float& hi, float& lo) {
  hi = __uint_as_float(__float_as_uint(x) & 0xffffe000u);
  lo = x - hi;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const float (&a)[4], float b0, float b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(__float_as_uint(a[0])), "r"(__float_as_uint(a[1])), "r"(__float_as_uint(a[2])),
        "r"(__float_as_uint(a[3])), "r"(__float_as_uint(b0)), "r"(__float_as_uint(b1)));
}

// c += a b at float32 accuracy (3xTF32); b is a fragment {hi b0, hi b1, lo b0, lo b1}.
__device__ __forceinline__ void mma3(float (&c)[4], const float (&ahi)[4], const float (&alo)[4],
                                     const float4& b) {
  mma_tf32(c, alo, b.x, b.y);
  mma_tf32(c, ahi, b.z, b.w);
  mma_tf32(c, ahi, b.x, b.y);
}

// An m16n8 accumulator (c0 = (g, 2t), c1 = (g, 2t + 1), c2 = (g + 8, 2t), c3 = (g + 8, 2t + 1))
// as the split A operand of the next product, its columns relabelled (A column t = column
// 2t, A column t + 4 = column 2t + 1): a = {c0, c2, c1, c3}.
__device__ __forceinline__ void split_as_a(const float (&c)[4], float (&hi)[4], float (&lo)[4]) {
  split(c[0], hi[0], lo[0]);
  split(c[2], hi[1], lo[1]);
  split(c[1], hi[2], lo[2]);
  split(c[3], hi[3], lo[3]);
}

// The two B layouts of an m16n8k8 fragment of 8 rows (from row0) x 8 columns of a
// [B, T, H, 8] tensor, as {hi b0, hi b1, lo b0, lo b1} for lane (g, t):
//   rows:    the rows are n, the columns k: b0 = (row g, column t), b1 = (g, t + 4);
//   relabel: the rows are k in relabelled order, the columns n: b0 = (2t, g), b1 = (2t + 1, g).
// A staging thread fetches one lane's two values (0 past T) ...
__device__ __forceinline__ float2 fetch_slot(const float* x, bool relabel, int b, int row0, int h,
                                             int T, int H, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int r0 = row0 + (relabel ? 2 * t : g), r1 = row0 + (relabel ? 2 * t + 1 : g);
  const int c0 = relabel ? g : t, c1 = relabel ? g : t + 4;
  return make_float2(r0 < T ? __ldg(x + row_offset(b, r0, h, T, H) + c0) : 0.f,
                     r1 < T ? __ldg(x + row_offset(b, r1, h, T, H) + c1) : 0.f);
}

// ... and stores them split, one 16-byte store a lane.
__device__ __forceinline__ void store_slot(float4* frag, float2 x, float scale) {
  float4 f;
  split(x.x * scale, f.x, f.z);
  split(x.y * scale, f.y, f.w);
  *frag = f;
}

// ---------------------------------------------------------------------------------------
// Forward.

struct FwdStage {
  float4 k[kKeyFrags][32];      // B of s = q k^T: K[key g][t], K[key g][t + 4]
  float4 v[kKeyFrags][32];      // B of o += p v, keys relabelled: V[key 2t][g], V[key 2t + 1][g]
  float bias[kKeyTile];         // the scores' starting value: 0, or -inf for a key past T
};

// Slot e of a tile: e < 4 kKeyTile is fragment e / 32 of K (rows), lane e % 32; the next
// 4 kKeyTile the same of V (relabel). One thread a slot.
__device__ __forceinline__ void fetch_kv(float2 (&f)[kFwdItems], const float* k,
                                         const float* v, int b, int h, int j0, int T, int H) {
#pragma unroll
  for (int it = 0; it < kFwdItems; ++it) {
    const int e = threadIdx.x + it * kFwdThreads, ev = e % (4 * kKeyTile);
    f[it] = fetch_slot(e < 4 * kKeyTile ? k : v, e >= 4 * kKeyTile, b, j0 + 8 * (ev >> 5), h,
                       T, H, e & 31);
  }
}

__device__ __forceinline__ void stage_kv(FwdStage& s, const float2 (&f)[kFwdItems], int j0,
                                         int T) {
#pragma unroll
  for (int it = 0; it < kFwdItems; ++it) {
    const int e = threadIdx.x + it * kFwdThreads;
    store_slot(&s.k[0][0] + e, f[it], 1.f);      // s.v follows s.k
  }
  const int i = threadIdx.x;
  if (i < kKeyTile) s.bias[i] = j0 + i < T ? 0.f : -INFINITY;
}

__global__ void __launch_bounds__(kFwdThreads, kFwdBlocks)
flash_kv_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ o,
                    float* __restrict__ lse, int H, int T, float score_scale) {
  __shared__ FwdStage stage[2];
  const int bh = blockIdx.x, b = bh / H, h = bh - (bh / H) * H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row_base = blockIdx.y * kFwdRows + warp * 16 * kFwdMt + g;

  // Per m16 tile mt (rows row_base + 16 mt + g, + 8): the A fragment of the scaled queries
  // (a0 = (g, t), a1 = (g + 8, t), a2 = (g, t + 4), a3 = (g + 8, t + 4)), the output
  // accumulator, and the two rows' running maximum and sum.
  float qhi[kFwdMt][4], qlo[kFwdMt][4], acc[kFwdMt][4] = {}, m[kFwdMt][2], l[kFwdMt][2] = {};
#pragma unroll
  for (int mt = 0; mt < kFwdMt; ++mt) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int row = row_base + 16 * mt + 8 * (c & 1), dim = t + 4 * (c >> 1);
      const float x = row < T ? q[row_offset(b, row, h, T, H) + dim] : 0.f;
      split(x * score_scale, qhi[mt][c], qlo[mt][c]);
    }
    m[mt][0] = m[mt][1] = -INFINITY;
  }

  const int tiles = (T + kKeyTile - 1) / kKeyTile;
  float2 next[kFwdItems];
  fetch_kv(next, k, v, b, h, 0, T, H);
  stage_kv(stage[0], next, 0, T);
  __syncthreads();
  for (int tile = 0; tile < tiles; ++tile) {
    const FwdStage& s = stage[tile & 1];
    const bool more = tile + 1 < tiles;
    if (more) fetch_kv(next, k, v, b, h, (tile + 1) * kKeyTile, T, H);

    // Scores in log2 units, starting from the bias so that keys past T score -inf; each K
    // fragment read once for the warp's m16 tiles.
    float sc[kFwdMt][kKeyFrags][4];
#pragma unroll
    for (int n = 0; n < kKeyFrags; ++n) {
      const float2 bias = *reinterpret_cast<const float2*>(&s.bias[8 * n + 2 * t]);
      const float4 kf = s.k[n][lane];
#pragma unroll
      for (int mt = 0; mt < kFwdMt; ++mt) {
        sc[mt][n][0] = sc[mt][n][2] = bias.x;
        sc[mt][n][1] = sc[mt][n][3] = bias.y;
        mma3(sc[mt][n], qhi[mt], qlo[mt], kf);
      }
    }
    float corr[kFwdMt][2];
#pragma unroll
    for (int mt = 0; mt < kFwdMt; ++mt) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = m[mt][r];
#pragma unroll
        for (int n = 0; n < kKeyFrags; ++n) mx = fmaxf(mx, fmaxf(sc[mt][n][2 * r], sc[mt][n][2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        corr[mt][r] = ex2(m[mt][r] - mx);         // 0 on the first tile (m = -inf)
        m[mt][r] = mx;                            // finite: every tile has a key
      }
    }
    // The tile's p v starts from zero and is added to the rescaled accumulator in float32:
    // the tensor cores' accumulation truncates, which over a whole row would bias o.
    float pv[kFwdMt][4] = {}, ls[kFwdMt][2] = {};
#pragma unroll
    for (int n = 0; n < kKeyFrags; ++n) {
      const float4 vf = s.v[n][lane];
#pragma unroll
      for (int mt = 0; mt < kFwdMt; ++mt) {
        float p[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) p[c] = ex2(sc[mt][n][c] - m[mt][c >> 1]);
        ls[mt][0] += p[0] + p[1];
        ls[mt][1] += p[2] + p[3];
        float ahi[4], alo[4];
        split_as_a(p, ahi, alo);
        mma3(pv[mt], ahi, alo, vf);
      }
    }
#pragma unroll
    for (int mt = 0; mt < kFwdMt; ++mt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mt][c] = fmaf(acc[mt][c], corr[mt][c >> 1], pv[mt][c]);
      l[mt][0] = fmaf(l[mt][0], corr[mt][0], ls[mt][0]);
      l[mt][1] = fmaf(l[mt][1], corr[mt][1], ls[mt][1]);
    }
    if (more) stage_kv(stage[(tile + 1) & 1], next, (tile + 1) * kKeyTile, T);
    __syncthreads();
  }
  float* lse_bh = lse + static_cast<size_t>(bh) * T;
#pragma unroll
  for (int mt = 0; mt < kFwdMt; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float sum = l[mt][r];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const int row = row_base + 16 * mt + 8 * r;
      if (row >= T) continue;
      *reinterpret_cast<float2*>(o + row_offset(b, row, h, T, H) + 2 * t) =
          make_float2(acc[mt][2 * r] / sum, acc[mt][2 * r + 1] / sum);
      if (t == 0) lse_bh[row] = (m[mt][r] + log2f(sum)) * kLn2;
    }
  }
}

// ---------------------------------------------------------------------------------------
// Backward.

// delta = rowsum(g o), [B, H, T]: one thread a row.
__global__ void flash_kv_delta_kernel(const float* __restrict__ o, const float* __restrict__ g,
                                      float* __restrict__ delta, int H, int T, int rows) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const int bh = r / T, i = r - bh * T;
  const size_t off = row_offset(bh / H, i, bh % H, T, H);
  const float4 o0 = __ldg(reinterpret_cast<const float4*>(o + off));
  const float4 o1 = __ldg(reinterpret_cast<const float4*>(o + off + 4));
  const float4 g0 = __ldg(reinterpret_cast<const float4*>(g + off));
  const float4 g1 = __ldg(reinterpret_cast<const float4*>(g + off + 4));
  delta[r] = g0.x * o0.x + g0.y * o0.y + g0.z * o0.z + g0.w * o0.w + g1.x * o1.x +
             g1.y * o1.y + g1.z * o1.z + g1.w * o1.w;
}

enum { QS, QD, GS, GD };            // the four fragment arrays of a staged query tile

struct BwdStage {
  // QS: B of s^T = k q^T (scaled queries), rows; QD: B of dk += ds^T q, relabel;
  // GS: B of dp^T = v g^T, rows; GD: B of dv += p^T g, relabel.
  float4 frag[4][kQueryTile / 8][32];
  float nlse2[kQueryTile];        // -lse in log2 units; -inf past T, so p = 0 there
  float ndelta[kQueryTile];       // -delta
};

// Word of (row, column) in a warp's ds^T (32 keys x 16 queries): rows of 32 words, the
// columns XOR-swizzled by 8 h(row & 7), h = [0, 1, 2, 3, 1, 0, 3, 2], so that both the
// 8-byte stores (lane (g, t): rows g, columns 2t) and the 4-byte reads (rows 2t, columns g)
// touch 32 banks.
__device__ __forceinline__ int ds_at(int row, int col) {
  const int r = row & 7;
  return row * 32 + (col ^ (8 * ((r & 3) ^ (r >> 2))));
}

struct BwdSmem {
  BwdStage stage[2];
  float ds[kBwdWarps][kWarpKeys * 32];                 // each warp's ds^T (ds_at)
  float red[2][kBwdWarps][kQueryTile * D];             // each warp's dq contribution
};

// Slot e of a tile (e < 16 kQueryTile): array e / (4 kQueryTile), fragment e / 32 of it,
// lane e % 32; one thread a slot. Threads below kQueryTile also fetch one query's lse and
// delta.
constexpr int kQgItems = 16 * kQueryTile / (32 * kBwdWarps);
static_assert(kQgItems * 32 * kBwdWarps == 16 * kQueryTile, "a tile's slots must fill the block");

struct QgFetch {
  float2 slot[kQgItems];
  float2 lse_delta;
};

__device__ __forceinline__ QgFetch fetch_qg(const float* q, const float* g, const float* lse,
                                            const float* delta, int b, int h, int bh, int i0,
                                            int T, int H) {
  QgFetch f;
#pragma unroll
  for (int it = 0; it < kQgItems; ++it) {
    const int e = threadIdx.x + it * 32 * kBwdWarps, arr = e / (4 * kQueryTile);
    const int row0 = i0 + 8 * ((e >> 5) % (kQueryTile / 8));
    f.slot[it] = fetch_slot(arr < GS ? q : g, arr == QD || arr == GD, b, row0, h, T, H, e & 31);
  }
  const int r = i0 + threadIdx.x;
  f.lse_delta = make_float2(-INFINITY, 0.f);
  if (threadIdx.x < kQueryTile && r < T) {
    const size_t at = static_cast<size_t>(bh) * T + r;
    f.lse_delta = make_float2(-lse[at] * kLog2e, -delta[at]);
  }
  return f;
}

__device__ __forceinline__ void stage_qg(BwdStage& s, const QgFetch& f, float score_scale) {
#pragma unroll
  for (int it = 0; it < kQgItems; ++it) {
    const int e = threadIdx.x + it * 32 * kBwdWarps;
    store_slot(&s.frag[0][0][0] + e, f.slot[it], e < 4 * kQueryTile ? score_scale : 1.f);
  }
  if (threadIdx.x < kQueryTile) {
    s.nlse2[threadIdx.x] = f.lse_delta.x;
    s.ndelta[threadIdx.x] = f.lse_delta.y;
  }
}

__global__ void __launch_bounds__(32 * kBwdWarps, kBwdBlocks)
flash_kv_bwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ g,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    float* __restrict__ dk, float* __restrict__ dv,
                    float* __restrict__ dq_part, int H, int T, float score_scale,
                    float scale) {
  extern __shared__ float4 smem_raw[];
  BwdSmem& sm = *reinterpret_cast<BwdSmem*>(smem_raw);
  const int bh = blockIdx.x, b = bh / H, h = bh - (bh / H) * H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gl = lane >> 2, t = lane & 3;
  const int key0 = blockIdx.y * kKeyBlock + warp * kWarpKeys;
  const bool live = key0 < T;                 // a warp wholly past T only adds zeros to dq

  // K and V as A operands (rows keys 16 mt + g, + 8; columns dims t, t + 4), and K as the B
  // operand of dq = ds k (rows keys 8 ks + 2t, + 1 relabelled; column dim g). Keys past T
  // are zero: their dk, dv are not stored and their dq terms vanish.
  float khi[2][4], klo[2][4], vhi[2][4], vlo[2][4];
  float4 kb[4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int key = key0 + 16 * mt + gl + 8 * (c & 1), dim = t + 4 * (c >> 1);
      const size_t off = row_offset(b, key < T ? key : 0, h, T, H) + dim;
      split(key < T ? k[off] : 0.f, khi[mt][c], klo[mt][c]);
      split(key < T ? v[off] : 0.f, vhi[mt][c], vlo[mt][c]);
    }
  }
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    float x[2];
#pragma unroll
    for (int w = 0; w < 2; ++w) {
      const int key = key0 + 8 * ks + 2 * t + w;
      x[w] = key < T ? k[row_offset(b, key, h, T, H) + gl] : 0.f;
    }
    split(x[0], kb[ks].x, kb[ks].z);
    split(x[1], kb[ks].y, kb[ks].w);
  }
  float dka[2][4] = {}, dva[2][4] = {};

  float* dq_bh = dq_part + (static_cast<size_t>(blockIdx.y) * gridDim.x + bh) * T * D;
  const int tiles = (T + kQueryTile - 1) / kQueryTile;
  stage_qg(sm.stage[0], fetch_qg(q, g, lse, delta, b, h, bh, 0, T, H), score_scale);
  __syncthreads();
  for (int it = 0; it < tiles; ++it) {
    const int buf = it & 1;
    const BwdStage& s = sm.stage[buf];
    const bool more = it + 1 < tiles;
    QgFetch next;
    if (more) next = fetch_qg(q, g, lse, delta, b, h, bh, (it + 1) * kQueryTile, T, H);
    float* red = sm.red[buf][warp];
    if (live) {
      float* dsw = sm.ds[warp];
      // This tile's dk, dv start from zero and are added to the running sums in float32:
      // the tensor cores' accumulation truncates.
      float dkt[2][4] = {}, dvt[2][4] = {};
#pragma unroll
      for (int half = 0; half < kQueryTile / 16; ++half) {      // 16 queries at a time
#pragma unroll
        for (int nn = 0; nn < 2; ++nn) {
          const int n = 2 * half + nn;
          const float4 qs = s.frag[QS][n][lane], qd = s.frag[QD][n][lane];
          const float4 gs = s.frag[GS][n][lane], gd = s.frag[GD][n][lane];
          const float2 ls = *reinterpret_cast<const float2*>(&s.nlse2[8 * n + 2 * t]);
          const float2 de = *reinterpret_cast<const float2*>(&s.ndelta[8 * n + 2 * t]);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            // C layout: (key g, query 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1). The
            // products start from -lse and -delta, so p = ex2(s^T) and ds = p dp^T.
            float st[4] = {ls.x, ls.y, ls.x, ls.y};
            mma3(st, khi[mt], klo[mt], qs);
            const float p[4] = {ex2(st[0]), ex2(st[1]), ex2(st[2]), ex2(st[3])};
            float ahi[4], alo[4];
            split_as_a(p, ahi, alo);
            mma3(dvt[mt], ahi, alo, gd);
            float dp[4] = {de.x, de.y, de.x, de.y};
            mma3(dp, vhi[mt], vlo[mt], gs);
            const float ds[4] = {p[0] * dp[0], p[1] * dp[1], p[2] * dp[2], p[3] * dp[3]};
            split_as_a(ds, ahi, alo);
            mma3(dkt[mt], ahi, alo, qd);
            // ds^T, unsplit: rows (keys) 16 mt + g, + 8; columns (queries of this half)
            // 8 nn + 2t, + 1.
            *reinterpret_cast<float2*>(dsw + ds_at(16 * mt + gl, 8 * nn + 2 * t)) =
                make_float2(ds[0], ds[1]);
            *reinterpret_cast<float2*>(dsw + ds_at(16 * mt + gl + 8, 8 * nn + 2 * t)) =
                make_float2(ds[2], ds[3]);
          }
        }
        __syncwarp();
        // dq of queries 16 half + (g, g + 8) from this warp's 32 keys: A = ds, read from
        // ds^T with the keys relabelled (A column t = key 8 ks + 2t, t + 4 = key 8 ks + 2t + 1)
        // and split here. The three products of 3xTF32 go to three sums, so that three
        // chains of four are in flight rather than one of twelve.
        float dqa[3][4] = {};
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          const int r = 8 * ks + 2 * t;
          const float a[4] = {dsw[ds_at(r, gl)], dsw[ds_at(r, gl + 8)], dsw[ds_at(r + 1, gl)],
                              dsw[ds_at(r + 1, gl + 8)]};
          float ah[4], al[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) split(a[c], ah[c], al[c]);
          mma_tf32(dqa[0], al, kb[ks].x, kb[ks].y);
          mma_tf32(dqa[1], ah, kb[ks].z, kb[ks].w);
          mma_tf32(dqa[2], ah, kb[ks].x, kb[ks].y);
        }
        float dq[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) dq[c] = dqa[2][c] + (dqa[0][c] + dqa[1][c]);
        // C layout: (query g, dims 2t, 2t + 1), (query g + 8, ...).
        *reinterpret_cast<float2*>(red + (16 * half + gl) * D + 2 * t) = make_float2(dq[0], dq[1]);
        *reinterpret_cast<float2*>(red + (16 * half + gl + 8) * D + 2 * t) =
            make_float2(dq[2], dq[3]);
        __syncwarp();
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          dka[mt][c] += dkt[mt][c];
          dva[mt][c] += dvt[mt][c];
        }
      }
    } else {
#pragma unroll
      for (int e = 4 * lane; e < kQueryTile * D; e += 128) {
        *reinterpret_cast<float4*>(red + e) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    if (more) stage_qg(sm.stage[buf ^ 1], next, score_scale);
    __syncthreads();
    // The block's dq partial of this tile: the warps' contributions summed in warp order.
    for (int e = threadIdx.x; e < kQueryTile * D; e += 32 * kBwdWarps) {
      if (it * kQueryTile + e / D < T) {
        float sum = 0.f;
#pragma unroll
        for (int w = 0; w < kBwdWarps; ++w) sum += sm.red[buf][w][e];
        dq_bh[static_cast<size_t>(it) * kQueryTile * D + e] = sum;
      }
    }
  }
  if (!live) return;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = key0 + 16 * mt + gl + 8 * r;
      if (key >= T) continue;
      const size_t off = row_offset(b, key, h, T, H) + 2 * t;
      *reinterpret_cast<float2*>(dk + off) =
          make_float2(dka[mt][2 * r] * scale, dka[mt][2 * r + 1] * scale);
      *reinterpret_cast<float2*>(dv + off) = make_float2(dva[mt][2 * r], dva[mt][2 * r + 1]);
    }
  }
}

// dq = scale * (sum of the key blocks' partials, in key-block order); one thread per four
// values, reading each partial contiguously.
__global__ void flash_kv_dq_reduce_kernel(const float4* __restrict__ part, float* __restrict__ dq,
                                          int H, int T, int n_blocks, size_t quads,
                                          float scale) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= quads) return;
  float4 s = part[idx];
  for (int j = 1; j < n_blocks; ++j) {
    const float4 x = part[j * quads + idx];
    s.x += x.x;
    s.y += x.y;
    s.z += x.z;
    s.w += x.w;
  }
  const size_t row = idx >> 1;                       // (b h) T + i
  const int bh = static_cast<int>(row / T), i = static_cast<int>(row - static_cast<size_t>(bh) * T);
  *reinterpret_cast<float4*>(dq + row_offset(bh / H, i, bh % H, T, H) + 4 * (idx & 1)) =
      make_float4(s.x * scale, s.y * scale, s.z * scale, s.w * scale);
}

bool bad_shape(int batch, int heads, int T, int head_dim) {
  return batch <= 0 || heads <= 0 || T <= 0 || head_dim != D ||
         static_cast<long long>(batch) * heads > 2147483647LL ||
         (T + kFwdRows - 1) / kFwdRows > 65535 ||
         static_cast<long long>(batch) * heads * T > 2147483647LL;
}

}  // namespace

// C entry points, bound with ctypes. q, k, v, o, g, dq, dk, dv: float32 [B, T, H, 8],
// contiguous and 16-byte aligned; lse, delta: float32 [B, H, T]; dq_part: float32
// [ceil(T / 512), B, H, T, 8] scratch. scale = 1 / sqrt(8). Each returns the cudaError_t
// of its launches (0 = launched).
extern "C" int flash_kv_key_block() { return kKeyBlock; }

extern "C" int flash_kv_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                            int batch, int T, int heads, int head_dim, float scale,
                            void* stream) {
  if (bad_shape(batch, heads, T, head_dim)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(batch * heads, (T + kFwdRows - 1) / kFwdRows);
  flash_kv_fwd_kernel<<<grid, kFwdThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), static_cast<float*>(lse), heads, T, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int flash_kv_bwd(const void* q, const void* k, const void* v, const void* o,
                            const void* lse, const void* g, void* dq, void* dk, void* dv,
                            void* delta, void* dq_part, int batch, int T, int heads,
                            int head_dim, float scale, void* stream) {
  if (bad_shape(batch, heads, T, head_dim)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows = batch * heads * T, n_blocks = (T + kKeyBlock - 1) / kKeyBlock;
  flash_kv_delta_kernel<<<(rows + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(o), static_cast<const float*>(g), static_cast<float*>(delta),
      heads, T, rows);
  cudaError_t err = cudaFuncSetAttribute(flash_kv_bwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(sizeof(BwdSmem)));
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_kv_bwd_kernel<<<dim3(batch * heads, n_blocks), 32 * kBwdWarps, sizeof(BwdSmem), st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(g), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dk), static_cast<float*>(dv),
      static_cast<float*>(dq_part), heads, T, scale * kLog2e, scale);
  const size_t quads = static_cast<size_t>(rows) * 2;
  flash_kv_dq_reduce_kernel<<<static_cast<unsigned>((quads + 255) / 256), 256, 0, st>>>(
      static_cast<const float4*>(dq_part), static_cast<float*>(dq), heads, T, n_blocks, quads,
      scale);
  return static_cast<int>(cudaGetLastError());
}

// Hopper GEMM machinery shared by the bfloat16 bodies of ffn_mega.cu and conv_gelu.cu: TMA
// tile loads into an mbarrier ring, one producer warp, two consumer groups on wgmma that take
// turns (ping-pong), and the host side that encodes the tensor maps.
//
// The product is A B^T in 128 x 128 output tiles, A [rows, K] row-major (K-major) or [K, rows]
// (M-major, read with wgmma's transpose-A bit) and B either [N, K] (K-major, nn.Linear's
// [out, in]) or [K, N] (N-major, read with wgmma's transpose-B bit). Which tiles a block
// walks, how many k steps each takes and where each k step's boxes start come from a
// schedule (GemmGrid below is the plain row-major product); a convolution's schedule reads
// one operand at shifted rows per k step.
// K runs in steps of 64 bf16 = 128 bytes, the width of the 128-byte swizzle that the tensor
// maps apply and the wgmma descriptors name. One block an SM walks over the tiles
// (persistent: tile t = blockIdx.x + i gridDim.x, columns fastest). Warp 16 is the
// producer: its first lane streams every k step of the block's tiles, in order, through a
// ring of kGemmStages slots (one `full` barrier per slot, completed by the TMA transaction count;
// one `empty` barrier per slot, arrived at by the 8 warps that read it). Consumer group g
// (threads 256 g .. 256 g + 255, two warpgroups) takes the block's tiles i = g, g + 2, ...;
// its warpgroup w owns rows 64 w .. 64 w + 63, one m64n128k16 product per 16 of k with
// float32 sums in registers. The groups' mainloops take turns in tile order (a `turn`
// barrier completes once per finished tile), so one group's epilogue, staged through its
// own shared tile, runs on 8 warps while the other group's products run: here the epilogue
// (dropout masks, GELU, 16-byte stores) costs about as much as the products, and its speed
// grows with the warps that run it. The turns also keep every wait on a slot at most one
// phase ahead of its barrier, which a parity wait needs. One producer warp rather than a
// warpgroup keeps 544 threads an SM within the register file without `setmaxnreg`. TMA
// fills rows past the matrix with zeros, so a ragged row count needs guards only in the
// epilogue, and the columns past N (or K) are zeros: a width that is not a multiple of a
// tile needs guards only on the epilogue's columns.
#pragma once

#include <cuda.h>              // CUtensorMap and its enums: types only, the build needs no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "mbarrier.cuh"

namespace w2v {

constexpr int kGemmGroup = 256;                // a consumer group: two warpgroups
constexpr int kGemmConsumers = 2 * kGemmGroup;  // threads 0 .. 511
constexpr int kGemmThreads = kGemmConsumers + 32;   // + the producer warp
constexpr int kGemmBM = 128, kGemmBN = 128;    // an output tile, one warpgroup's
constexpr int kGemmBK = 64;                    // bf16 per k step: one 128-byte swizzle row
constexpr int kGemmStages = 4;                 // ring slots of 32 KB
constexpr int kGemmAcc = kGemmBN / 2;          // float32 sums a consumer thread holds
constexpr int kStageLd = kGemmBN + 8;          // staging row: the 16-byte pad spreads banks
// Runs of 8 columns a group thread takes from its staged tile: 16 threads cover a row.
constexpr int kGemmRuns = kGemmBM * kGemmBN / 8 / kGemmGroup;

// The calling consumer thread's index in its group, and its run j: row and column in the
// staged tile.
__device__ __forceinline__ int group_thread() { return threadIdx.x % kGemmGroup; }
__device__ __forceinline__ int run_row(int j) { return group_thread() / 16 + 16 * j; }
__device__ __forceinline__ int run_col() { return (threadIdx.x % 16) * 8; }

// Shared memory of a block: the ring of (A, B) tile pairs, 1024-byte aligned for the
// swizzle; per consumer group a bf16 staging tile [128][kStageLd] and 8 KB of float32
// scratch; then the full and empty barrier of each slot and the turn barrier. kTransB: B is
// N-major; kTransA: A is M-major (boxes of 64 k rows x 64 rows of the product, one a
// warpgroup).
template <bool kTransB_, bool kTransA_ = false>
struct WgmmaTiling {
  static constexpr int STAGES = kGemmStages;
  static constexpr bool kTransB = kTransB_;
  static constexpr bool kTransA = kTransA_;
  static constexpr int A_BYTES = kGemmBM * kGemmBK * 2;
  static constexpr int STAGE_BYTES = A_BYTES + kGemmBN * kGemmBK * 2;
  static constexpr int RING_BYTES = STAGES * STAGE_BYTES;
  static constexpr int STAGING_BYTES = kGemmBM * kStageLd * 2;
  static constexpr int SCRATCH_BYTES = 8192;
  static constexpr int BARRIERS = RING_BYTES + 2 * (STAGING_BYTES + SCRATCH_BYTES);
  static constexpr int SMEM = BARRIERS + (2 * STAGES + 1) * 8 + 1024;   // + alignment slack
  static_assert(SMEM <= 232448, "one block's shared memory");
};

// ---- host: tensor maps ------------------------------------------------------------------

using TensorMapEncode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                     const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                     const cuuint32_t*, CUtensorMapInterleave,
                                     CUtensorMapSwizzle, CUtensorMapL2promotion,
                                     CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime's entry-point query (null if
// it is missing).
inline TensorMapEncode tensor_map_encoder() {
  static const TensorMapEncode fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<TensorMapEncode>(p)
               : nullptr;
  }();
  return fn;
}

// The map of a dense row-major bf16 matrix [rows, cols], read in boxes of box_rows x 64
// columns with the 128-byte swizzle; loads past the edges fill zeros. The caller guarantees
// a 16-byte aligned base and cols a multiple of 8 (a 16-byte row stride). False if the
// encoding fails.
inline bool tensor_map(CUtensorMap* map, const void* base, int rows, int cols, int box_rows) {
  const TensorMapEncode encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kGemmBK), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t steps[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides,
                box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// ---- device: barriers, copies, products -------------------------------------------------

// One box of `map` at (column c0, row c1) into shared memory, counted on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins the accumulators in place around the asynchronous products: the compiler may not
// move their reads or writes across this point.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle. K-major tiles (rows of 128 bytes):
// lbo 16 (unused), sbo 1024 (8 rows); a k step of 16 adds 32 bytes to the start. M- or
// N-major tiles (boxes of 64 k rows x 64 columns): lbo is the stride between 64-column
// boxes, sbo 1024 (8 k rows); a k step of 16 adds 16 rows = 2048 bytes.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | 1ull << 62;
}

template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(kTransA), "n"(kTransB));
}

// The block's shared memory (see WgmmaTiling).
template <class G>
struct GemmSmem {
  unsigned char* base;
  __device__ __forceinline__ explicit GemmSmem(unsigned char* raw)
      : base(raw + ((1024u - (smem_u32(raw) & 1023u)) & 1023u)) {}
  __device__ __forceinline__ unsigned char* a(int s) const { return base + s * G::STAGE_BYTES; }
  __device__ __forceinline__ unsigned char* b(int s) const { return a(s) + G::A_BYTES; }
  __device__ __forceinline__ __nv_bfloat16* staging(int g) const {
    return reinterpret_cast<__nv_bfloat16*>(base + G::RING_BYTES + g * G::STAGING_BYTES);
  }
  __device__ __forceinline__ float* scratch(int g) const {
    return reinterpret_cast<float*>(base + G::RING_BYTES + 2 * G::STAGING_BYTES +
                                    g * G::SCRATCH_BYTES);
  }
  __device__ __forceinline__ uint64_t* full(int s) const {
    return reinterpret_cast<uint64_t*>(base + G::BARRIERS) + s;
  }
  __device__ __forceinline__ uint64_t* empty(int s) const { return full(G::STAGES) + s; }
  __device__ __forceinline__ uint64_t* turn() const { return full(2 * G::STAGES); }
};

// Named barrier over the 256 threads of consumer group g (the producer warp has left).
__device__ __forceinline__ void group_sync(int g) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(1 + g) : "memory");
}

// A schedule says which tiles there are, how many k steps (of kGemmBK) each takes, where
// each k step's boxes start, and which warpgroups multiply in it: a(t, kt) and b(t, kt) give
// (column, row) of A's and B's first box in their tensor maps (an M- or N-major operand's
// second 64-column box starts 64 columns on); mma(t, kt, wg) is false where warpgroup wg
// (rows 64 wg .. 64 wg + 63 of the tile) skips the step's products. GemmGrid is the plain
// product A B^T of [rows, K] and [cols, K] (or [K, cols]): tile t is row tile t / col_tiles
// and column tile t % col_tiles, every tile takes all of K in both warpgroups (the last column
// tile and k step may reach past cols and k: TMA fills zeros there).
template <bool kTransB>
struct GemmGrid {
  int col_tiles, tiles, k_tiles;
  __device__ __forceinline__ GemmGrid(int rows, int cols, int k)
      : col_tiles((cols + kGemmBN - 1) / kGemmBN),
        tiles((rows + kGemmBM - 1) / kGemmBM * col_tiles), k_tiles((k + kGemmBK - 1) / kGemmBK) {}
  __device__ __forceinline__ int steps(int) const { return k_tiles; }
  __device__ __forceinline__ bool mma(int, int, int) const { return true; }
  __device__ __forceinline__ int m0(int t) const { return (t / col_tiles) * kGemmBM; }
  __device__ __forceinline__ int n0(int t) const { return (t % col_tiles) * kGemmBN; }
  __device__ __forceinline__ int2 a(int t, int kt) const { return make_int2(kt * kGemmBK, m0(t)); }
  __device__ __forceinline__ int2 b(int t, int kt) const {
    return kTransB ? make_int2(n0(t), kt * kGemmBK) : make_int2(kt * kGemmBK, n0(t));
  }
};

// The producer lane: every k step of the block's tiles through the ring, in order.
template <class G, class S>
__device__ __forceinline__ void gemm_produce(const GemmSmem<G>& sm, const CUtensorMap* ma,
                                             const CUtensorMap* mb, const S& sched) {
  int pos = 0;
  for (int t = blockIdx.x; t < sched.tiles; t += gridDim.x) {
    const int k_tiles = sched.steps(t);
    for (int kt = 0; kt < k_tiles; ++kt, ++pos) {
      const int s = pos % G::STAGES;
      mbar_wait(sm.empty(s), ((pos / G::STAGES) & 1) ^ 1);   // passes at once in round 0
      mbar_expect_tx(sm.full(s), G::STAGE_BYTES);
      const int2 a = sched.a(t, kt), b = sched.b(t, kt);
      if constexpr (G::kTransA) {
#pragma unroll
        for (int c = 0; c < kGemmBM / 64; ++c)
          tma_load(sm.a(s) + c * (kGemmBK * 128), ma, sm.full(s), a.x + 64 * c, a.y);
      } else {
        tma_load(sm.a(s), ma, sm.full(s), a.x, a.y);
      }
      if constexpr (G::kTransB) {
#pragma unroll
        for (int c = 0; c < kGemmBN / 64; ++c)
          tma_load(sm.b(s) + c * (kGemmBK * 128), mb, sm.full(s), b.x + 64 * c, b.y);
      } else {
        tma_load(sm.b(s), mb, sm.full(s), b.x, b.y);
      }
    }
  }
}

// acc = the calling warpgroup's 64 rows of a tile whose k_tiles k steps start at ring
// position pos0, summed over the steps kt where mma(kt), every product retired and every slot
// released on return. wgmma's accumulator layout: warp w of the warpgroup holds rows
// 16 w + lane / 4 and + 8; register 4 j + e holds column 8 j + 2 (lane % 4) + (e & 1), the
// second row for e >= 2.
template <class G, class Mma>
__device__ __forceinline__ void gemm_consume(float (&acc)[kGemmAcc], const GemmSmem<G>& sm,
                                             int pos0, int k_tiles, Mma&& mma) {
  const bool leader = (threadIdx.x & 31) == 0;
  // The warpgroup's part of A, 8 KB either way: K-major, its 64 rows of 128 bytes; M-major,
  // its box of 64 k rows x 64 columns.
  const uint32_t a_rows = (group_thread() / 128) * 64 * 128;
#pragma unroll
  for (int e = 0; e < kGemmAcc; ++e) acc[e] = 0.f;
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int pos = pos0 + kt, s = pos % G::STAGES;
    mbar_wait(sm.full(s), (pos / G::STAGES) & 1);
    if (mma(kt)) {
      const uint32_t sa = smem_u32(sm.a(s)) + a_rows, sb = smem_u32(sm.b(s));
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kGemmBK / 16; ++kk) {
        const uint64_t da = G::kTransA ? desc_sw128(sa + kk * 2048, kGemmBK * 128, 1024)
                                       : desc_sw128(sa + kk * 32, 16, 1024);
        const uint64_t db = G::kTransB ? desc_sw128(sb + kk * 2048, kGemmBK * 128, 1024)
                                       : desc_sw128(sb + kk * 32, 16, 1024);
        wgmma_m64n128k16<G::kTransA ? 1 : 0, G::kTransB ? 1 : 0>(acc, da, db);
      }
      wgmma_commit();
      fence_acc(acc);
      wgmma_wait<1>();                           // the previous k step's products retired
    } else {
      wgmma_wait<0>();                           // so are this warpgroup's last ones
    }
    fence_acc(acc);
    if (kt > 0 && leader) mbar_arrive(sm.empty((pos - 1) % G::STAGES));
  }
  wgmma_wait<0>();
  fence_acc(acc);
  if (leader) mbar_arrive(sm.empty((pos0 + k_tiles - 1) % G::STAGES));
}

// The whole product over a schedule (every tile takes at least one k step). All threads of
// the block call it; after each tile t, the consumer group that computed it calls
// epi(acc, g, t) with its warpgroups' sums.
template <class G, class S, class Epi>
__device__ __forceinline__ void gemm_run(const GemmSmem<G>& sm, const CUtensorMap* ma,
                                         const CUtensorMap* mb, const S& sched, Epi&& epi) {
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < G::STAGES; ++s) {
      mbar_init(sm.full(s), 1);
      mbar_init(sm.empty(s), 8);
    }
    mbar_init(sm.turn(), 8);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= kGemmConsumers) {
    if (threadIdx.x == kGemmConsumers) gemm_produce(sm, ma, mb, sched);
    return;
  }
  const int g = threadIdx.x / kGemmGroup, wg = group_thread() / 128;
  const int block = blockIdx.x, grid = gridDim.x;
  // Ring position of the group's next tile: the k steps of every earlier tile of the block.
  int pos = g == 0 || block >= sched.tiles ? 0 : sched.steps(block);
  float acc[kGemmAcc];
  for (int i = g; block + i * grid < sched.tiles; i += 2) {
    const int t = block + i * grid, next = t + grid;
    const int k_tiles = sched.steps(t);
    if (i > 0) mbar_wait(sm.turn(), (i - 1) & 1);   // tile i - 1's mainloop has finished
    gemm_consume(acc, sm, pos, k_tiles, [&](int kt) { return sched.mma(t, kt, wg); });
    if ((threadIdx.x & 31) == 0) mbar_arrive(sm.turn());
    epi(acc, g, t);
    pos += k_tiles + (next < sched.tiles ? sched.steps(next) : 0);   // and the other group's
  }
}

// The plain product A B^T: after each tile, the consumer group that computed it calls
// epi(acc, g, m0, n0, row tile) with its warpgroups' sums.
template <class G, class Epi>
__device__ __forceinline__ void gemm_tiles(const GemmSmem<G>& sm, const CUtensorMap* ma,
                                           const CUtensorMap* mb, int rows, int cols, int k,
                                           Epi&& epi) {
  const GemmGrid<G::kTransB> sched(rows, cols, k);
  gemm_run(sm, ma, mb, sched, [&](const float (&acc)[kGemmAcc], int g, int t) {
    epi(acc, g, sched.m0(t), sched.n0(t), t / sched.col_tiles);
  });
}

// The persistent grid: one block an SM, no more blocks than tiles.
inline int gemm_grid(int rows, int cols) {
  int device = 0, sms = 132;
  if (cudaGetDevice(&device) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int tiles = (rows + kGemmBM - 1) / kGemmBM * ((cols + kGemmBN - 1) / kGemmBN);
  return tiles < sms ? tiles : sms;
}

}  // namespace w2v

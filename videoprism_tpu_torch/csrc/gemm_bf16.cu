// Tiled bf16 GEMM with fp32 accumulation and the block kernels' fused
// epilogues, on Hopper's warpgroup MMA (wgmma) fed by the tensor memory
// accelerator (TMA).
//
// Replaces the four matrix products inside K1 (_attn_block_kernel: fused
// QKV, output projection) and K2 (_ffn_block_kernel: W1, W2) of
// videoprism_tpu/ops/pallas/transformer_block.py, and the per-chunk output
// products of K8a/K8b (_attn_chunk_kernel, _ffn_chunk_kernel), with their
// epilogues, in this fp32 order:
//   kEpiQkv      (acc + bias) * query_scale on the q columns, cast;
//   kEpiActKeep  act(acc + b1) * keep, cast;              (exact-erf GELU)
//   kEpiResidual (acc [+ bias]) [* keep] + residual in fp32, cast.
// A is read with its own row pitch (lda), so a chunk's K-slice of a wider
// activation (K8a's ctx columns of one head group, K8b's F-slice of a) is
// multiplied in place.
//
// Bound: tensor-core FLOPs.  At the base model's shapes (K = 768 or 3072,
// N = 768..3072, M = B * 4096) every product does hundreds of FLOPs per byte
// of device memory, above the card's ~295 FLOP/byte ridge; wgmma is the only
// instruction that reaches the tensor cores' full rate.
// Design: persistent blocks, one per SM, walking output tiles of 128 x 128,
// 64 deep per stage.  One producer warp issues TMA loads of the A tile
// ([128, 64], K-major) and of the B tile ([64, 128] as two boxes of
// [64, 64], N-major: the weights stay [K, N], read by wgmma's transpose-B
// mode) into a ring of six shared-memory stages with 128-byte swizzle,
// completion reported to an mbarrier per stage.  Two consumer warpgroups
// take the block's tiles in turn (ping-pong), each multiplying a whole
// 128 x 128 tile with wgmma.mma_async m64n128k16 from shared memory into
// fp32 registers, keeping one k-tile's products in flight while releasing
// the stage before it: while one runs its epilogue the other multiplies,
// and the producer runs ahead into the next tiles.  setmaxnreg moves
// registers from the producer to the consumers.  TMA zero-fills the ragged
// M, N and K edges (the 16-byte row pitch and alignment the wrapper checks
// are what TMA needs), so the loop masks nothing.  The epilogue runs on the
// accumulator registers: bias per column, keep per row, the q scale, GELU
// and the residual read as bf16 pairs (all of a row block's loads issued
// before use), and the output goes out as bf16 pairs once, guarded at the
// edges.  Measured on an H100 80GB HBM3 at 700 W (chip_smoke.py [gemm]):
// the base encoder's four products at B = 8 with their epilogues run at
// 269-532 TFLOP/s, the deep one (K = 3072) fastest: at K = 768 a tile's
// twelve k-steps leave its start-up and the exact-erf GELU epilogue (W1)
// exposed.  PERF.md says what was tried beyond this.
// The tensor maps are encoded on the host per launch (tma_wgmma.cuh).
#include "tma_wgmma.cuh"

namespace vp {
namespace {

constexpr int BM = 128, BN = 128;       // output tile of one consumer warpgroup
constexpr int BK = 64;                   // depth per stage: one 128-byte row
constexpr int kThreads = 384;            // producer + 2 consumer warpgroups
constexpr int kBox = BK * 128;           // bytes of one [64 rows, 64] bf16 box
constexpr int kTileA = BM * BK * 2;      // bytes: [128, 64]
constexpr int kStage = kTileA + BK * BN * 2;
constexpr int kStages = 6;
// 1 KB of slack to align the ring to the swizzle's 1024-byte period, then
// the ring, then a full and an empty barrier per stage.
constexpr size_t kSmem = 1024 + size_t(kStages) * kStage + 2 * kStages * 8;

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous products.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 128] += A[64 x 16] (K-major) @ B[16 x 128] (N-major, transposed
// mode); the accumulator layout of lane l of warp w is that of mma.sync:
// d[4j + 2h + e] is row 16w + l / 4 + 8h, column 8j + 2 (l % 4) + e.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t desc_a,
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ uint32_t ldg_u32(const bf16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}
__device__ __forceinline__ float2 bf16x2_to_float2(uint32_t w) {
  return __bfloat1622float2(*reinterpret_cast<const bf162*>(&w));
}

__device__ __forceinline__ float activate(float v, int act) {
  if (act == kActGelu) return 0.5f * v * (1.f + erff(v * 0.7071067811865476f));
  if (act == kActRelu) return fmaxf(v, 0.f);
  return v;
}

struct Epi {
  const bf16* bias;
  const bf16* pads;
  const bf16* residual;
  bf16* out;
  int M, N, K, epilogue, act;
  float col_scale;
  int scaled_cols;
};

__global__ void __launch_bounds__(kThreads, 1)
    gemm_bf16_kernel(const __grid_constant__ CUtensorMap map_a,
                     const __grid_constant__ CUtensorMap map_b, const Epi p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * kStage);
  uint64_t* empty = full + kStages;
  const int wg = threadIdx.x / 128;
  const int tiles_n = (p.N + BN - 1) / BN;
  const int tiles = (p.M + BM - 1) / BM * tiles_n;
  const int ktiles = (p.K + BK - 1) / BK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);  // one arrival per warp of the consuming warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The block's tiles are i = 0, 1, .. (tile blockIdx.x + i * gridDim.x, =
  // m block * tiles_n + n block); the producer loads them in order and
  // consumer warpgroup i % 2 multiplies tile i.  Both count k-tiles across
  // tiles in `it` (tile i's k-tile kt is it = i * ktiles + kt): use it of
  // the ring is stage it % kStages, its (it / kStages)-th fill.
  if (wg == 0) {  // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = tile / tiles_n * BM, n0 = tile % tiles_n * BN;
        for (int kt = 0; kt < ktiles; ++kt, ++it) {
          const int s = it % kStages;
          if (it >= kStages) mbar_wait(&empty[s], (it / kStages - 1) & 1);
          unsigned char* stage = ring + s * kStage;
          mbar_expect_tx(&full[s], kStage);
          tma_load(stage, &map_a, &full[s], kt * BK, m0);
          tma_load(stage + kTileA, &map_b, &full[s], n0, kt * BK);
          tma_load(stage + kTileA + kBox, &map_b, &full[s], n0 + 64, kt * BK);
        }
      }
    }
    return;
  }

  // Consumers, ping-pong: while one warpgroup runs its tile's epilogue the
  // other multiplies the next tile, so the tensor cores do not wait for
  // the epilogue.  The main loops take turns in tile order (warpgroup c
  // waits on named barrier 1 + c, which the other arrives at when its
  // main loop is done): so a consumer never waits on a stage's barrier
  // more than one fill ahead, where its phase parity would be ambiguous.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int cw = wg - 1;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, c2 = 2 * (lane % 4);
  float acc[2][64];  // rows 64 * mh + 16 * warp + g (+ 8) of the tile
  for (int i = cw, tile = blockIdx.x + cw * gridDim.x; tile < tiles;
       i += 2, tile += 2 * gridDim.x) {
    const int m0 = tile / tiles_n * BM, n0 = tile % tiles_n * BN;
#pragma unroll
    for (int mh = 0; mh < 2; ++mh)
#pragma unroll
      for (int e = 0; e < 64; ++e) acc[mh][e] = 0.f;

    if (i > 0) consumer_sync(1 + cw);
    for (int kt = 0, it = i * ktiles; kt < ktiles; ++kt, ++it) {
      const int s = it % kStages;
      mbar_wait(&full[s], (it / kStages) & 1);
      // A: 128 rows of 128 bytes, 8-row groups 1024 bytes apart; a 16-deep
      // step is 32 bytes along the row.  B: two [64 K rows, 64 N] boxes of
      // 8 KB side by side (LBO, the next 64 columns), 8-row groups 1024
      // bytes apart (SBO); a 16-deep step is 16 rows.
      const uint32_t a_base = smem_u32(ring + s * kStage);
      const uint32_t b_base = a_base + kTileA;
#pragma unroll
      for (int mh = 0; mh < 2; ++mh) fence_acc(acc[mh]);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < BK / 16; ++k) {
        const uint64_t db = sw128_desc(b_base + 2048 * k, kBox, 1024);
#pragma unroll
        for (int mh = 0; mh < 2; ++mh)
          wgmma_m64n128k16(acc[mh], sw128_desc(a_base + mh * 64 * 128 + 32 * k, 16, 1024), db);
      }
      wgmma_commit();
#pragma unroll
      for (int mh = 0; mh < 2; ++mh) fence_acc(acc[mh]);
      wgmma_wait<1>();  // the previous k-tile is multiplied: release its stage
      __syncwarp();
      if (kt > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % kStages]);
    }
    if (tile + gridDim.x < tiles) consumer_arrive(2 - cw);  // tile i + 1 may start
    wgmma_wait<0>();
#pragma unroll
    for (int mh = 0; mh < 2; ++mh) fence_acc(acc[mh]);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[((i + 1) * ktiles - 1) % kStages]);

    // The epilogue, 64 rows at a time: every load it needs there (bias
    // pairs, the rows' keep and residual pairs) is issued before any is
    // used, so their latencies overlap.
    uint32_t bias[16];
#pragma unroll
    for (int jn = 0; jn < 16; ++jn) {
      const int col = n0 + 8 * jn + c2;  // N is even: col + 1 < N too
      bias[jn] = p.bias && col < p.N ? ldg_u32(p.bias + col) : 0u;
    }
#pragma unroll
    for (int mh = 0; mh < 2; ++mh) {
      int rows[2];
      float keep[2];
      uint32_t res[2][16];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        rows[h] = m0 + 64 * mh + 16 * warp + g + 8 * h;
        keep[h] = p.pads && rows[h] < p.M ? 1.f - __bfloat162float(p.pads[rows[h]]) : 1.f;
#pragma unroll
        for (int jn = 0; jn < 16; ++jn) {
          const int col = n0 + 8 * jn + c2;
          res[h][jn] = p.epilogue == kEpiResidual && rows[h] < p.M && col < p.N
                           ? ldg_u32(p.residual + static_cast<size_t>(rows[h]) * p.N + col)
                           : 0u;
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (rows[h] >= p.M) continue;
        bf16* out = p.out + static_cast<size_t>(rows[h]) * p.N;
#pragma unroll
        for (int jn = 0; jn < 16; ++jn) {
          const int col = n0 + 8 * jn + c2;
          if (col >= p.N) continue;
          float v[2] = {acc[mh][4 * jn + 2 * h], acc[mh][4 * jn + 2 * h + 1]};
          if (p.bias) {
            const float2 b = bf16x2_to_float2(bias[jn]);
            v[0] += b.x;
            v[1] += b.y;
          }
          if (p.epilogue == kEpiQkv) {
#pragma unroll
            for (int e = 0; e < 2; ++e)
              if (col + e < p.scaled_cols) v[e] *= p.col_scale;
          } else if (p.epilogue == kEpiActKeep) {
#pragma unroll
            for (int e = 0; e < 2; ++e) v[e] = activate(v[e], p.act) * keep[h];
          } else {
            const float2 r = bf16x2_to_float2(res[h][jn]);
            v[0] = (p.pads ? v[0] * keep[h] : v[0]) + r.x;
            v[1] = (p.pads ? v[1] * keep[h] : v[1]) + r.y;
          }
          *reinterpret_cast<bf162*>(out + col) = __floats2bfloat162_rn(v[0], v[1]);
        }
      }
    }
  }
}

}  // namespace

cudaError_t launch_gemm_bf16(const bf16* a, const bf16* b, const bf16* bias, const bf16* pads,
                             const bf16* residual, bf16* out, int M, int N, int K, int lda,
                             int epilogue, int activation, float col_scale, int scaled_cols,
                             cudaStream_t stream) {
  if (M <= 0 || N <= 0 || K <= 0 || N % 8 || K % 8 || lda % 8 || lda < K ||
      reinterpret_cast<uintptr_t>(a) % 16 || reinterpret_cast<uintptr_t>(b) % 16)
    return cudaErrorInvalidValue;
  CUtensorMap map_a, map_b;
  constexpr auto kBf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  if (!tensor_map(&map_a, kBf16, a, K, M, 2L * lda, BK, BM) ||
      !tensor_map(&map_b, kBf16, b, N, K, 2L * N, BK, BK))
    return cudaErrorInvalidValue;
  cudaError_t err = set_max_dynamic_smem<gemm_bf16_kernel>(kSmem);
  if (err != cudaSuccess) return err;
  const Epi p{bias, pads, residual, out, M, N, K, epilogue, activation, col_scale, scaled_cols};
  const long tiles = static_cast<long>((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  const int grid = static_cast<int>(tiles < sm_count() ? tiles : sm_count());
  gemm_bf16_kernel<<<grid, kThreads, kSmem, stream>>>(map_a, map_b, p);
  return cudaGetLastError();
}

}  // namespace vp

// The product stage alone, for measurement (chip_smoke.py [gemm]).
extern "C" int vp_gemm_bf16(const void* a, const void* b, const void* bias, const void* pads,
                            const void* residual, void* out, int M, int N, int K, int lda,
                            int epilogue, int activation, float col_scale, int scaled_cols,
                            void* stream) {
  using vp::bf16;
  return vp::launch_gemm_bf16(
      static_cast<const bf16*>(a), static_cast<const bf16*>(b), static_cast<const bf16*>(bias),
      static_cast<const bf16*>(pads), static_cast<const bf16*>(residual), static_cast<bf16*>(out),
      M, N, K, lda, epilogue, activation, col_scale, scaled_cols,
      static_cast<cudaStream_t>(stream));
}

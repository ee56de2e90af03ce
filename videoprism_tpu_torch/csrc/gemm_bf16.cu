// Tiled bf16 GEMM with fp32 accumulation and the block kernels' fused
// epilogues, on Hopper's warpgroup MMA (wgmma) fed by the tensor memory
// accelerator (TMA).
//
// Replaces the four matrix products inside K1 (_attn_block_kernel: fused
// QKV, output projection) and K2 (_ffn_block_kernel: W1, W2) of
// videoprism_tpu/ops/pallas/transformer_block.py, and the chained output
// products of K8a/K8b (_attn_chunk_kernel, _ffn_chunk_kernel), with their
// epilogues, in this fp32 order:
//   kEpiQkv      (acc + bias) * query_scale on the q columns, cast;
//   kEpiActKeep  act(acc + b1) * keep, cast;              (exact-erf GELU)
//   kEpiResidual (acc [+ bias]) [* keep] + residual, cast;
//   kEpiChain    the residual epilogue over `chunks` K-slices, cast after
//                each: y = x, then per slice c
//                  y = cast((acc_c [+ bias if c == 0]) [* keep] + y),
//                the bits of `chunks` kEpiResidual launches chained
//                through memory (K8a's head groups, K8b's F-slices).
// Every step is rounded on its own (__fadd_rn, __fmul_rn), so a product
// and the same product composed from separate launches are the same bits.
// A is read with its own row pitch (lda).
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
// completion reported to an mbarrier per stage.  Both tensor maps are 3-D,
// A as [M, chunks, kc] and B as [chunks, kc, N], so a k-tile that runs
// past a slice's kc columns reads zeros there (TMA zero-fills out of
// bounds) and never the next slice's: a chained product walks its slices'
// k-tiles as its separate launches would, whatever kc is.  Two consumer
// warpgroups take the block's tiles in turn (ping-pong), each multiplying
// a whole 128 x 128 tile with wgmma.mma_async m64n128k16 from shared memory
// into fp32 registers, keeping one k-tile's products in flight while
// releasing the stage before it: while one runs its epilogue the other
// multiplies, and the producer runs ahead into the next tiles.  setmaxnreg
// moves registers from the producer to the consumers.  TMA zero-fills the
// ragged M, N and K edges, so the loop masks nothing.
// The epilogue, its activation and the presence of the bias and the pads
// are template constants: the tile's unrolled 64 copies of the epilogue
// hold one arm, not all of them (a run-time switch inside the unrolled
// loop cost the int8 GEMM 2-2.7x).  The bias of the tile's 128 columns is
// staged in shared memory once per tile; the bf16 outputs go through a
// per-warpgroup staging of 64 rows, their 16-byte units XOR-swizzled by
// row so that the accumulator layout's pair stores (eight rows by four
// column pairs a warp) hit 32 banks, and out in 16-byte stores, whole rows
// at a time.  kEpiResidual's residual is prefetched into that staging by
// cp.async when the tile starts (its loads overlap the products).
// kEpiChain keeps its running output y in registers as packed bf16 pairs,
// 64 beside the 128 fp32 accumulators, loaded from x when the tile starts;
// at the end of each slice the consumer folds the accumulator into y and
// zeroes it, and only the last fold is stored: one launch and one pass
// over the residual where the chain of launches made `chunks`.
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
constexpr int kWgRows = 64;              // rows of a warpgroup's output staging
constexpr int kStaging = kWgRows * BN * 2;
constexpr int kSmemMax = 232448;         // an H100 block's dynamic shared memory
// After 1 KB of slack that aligns the ring to the swizzle's 1024-byte
// period: the ring, each consumer warpgroup's staging and its tile's bias,
// then a full and an empty barrier per stage; as many stages as fit.
constexpr int kFixed = 1024 + 2 * kStaging + 2 * BN * 2;
constexpr int kStages = (kSmemMax - kFixed) / (kStage + 16) < 6
                            ? (kSmemMax - kFixed) / (kStage + 16)
                            : 6;
static_assert(kStages >= 4, "the ring needs at least four stages");
constexpr int kOffStaging = kStages * kStage;
constexpr int kOffBias = kOffStaging + 2 * kStaging;
constexpr int kOffBars = kOffBias + 2 * BN * 2;
constexpr size_t kSmem = 1024 + kOffBars + 2 * kStages * 8;

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

// Named barrier `id` over one consumer warpgroup (128 threads).
__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ uint32_t ldg_u32(const bf16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}
__device__ __forceinline__ float2 bf16x2_to_float2(uint32_t w) {
  return __bfloat1622float2(*reinterpret_cast<const bf162*>(&w));
}
__device__ __forceinline__ uint32_t float2_to_bf16x2(float a, float b) {
  const bf162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

template <int kAct>
__device__ __forceinline__ float activate(float v) {
  if constexpr (kAct == kActGelu) return 0.5f * v * (1.f + erff(v * 0.7071067811865476f));
  else return fmaxf(v, 0.f);
}

// Byte offset of 16-byte unit u (columns 8u..8u+7) of row r in a
// warpgroup's staging: rows of 256 bytes, units XOR-swizzled by r % 8.
__device__ __forceinline__ int staged(int r, int u) { return r * (BN * 2) + ((u ^ (r & 7)) << 4); }

struct Epi {
  const bf16* bias;
  const bf16* pads;
  const bf16* residual;
  bf16* out;
  int M, N, chunks, kc;  // K = chunks * kc
  float col_scale;
  int scaled_cols;
};

template <int kEpi, int kAct, bool kPads, bool kBias>
__global__ void __launch_bounds__(kThreads, 1)
    gemm_bf16_kernel(const __grid_constant__ CUtensorMap map_a,
                     const __grid_constant__ CUtensorMap map_b, const __grid_constant__ Epi p) {
  constexpr bool kChain = kEpi == kEpiChain;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kOffBars);
  uint64_t* empty = full + kStages;
  const int wg = threadIdx.x / 128;
  const int tiles_n = (p.N + BN - 1) / BN;
  const int tiles = (p.M + BM - 1) / BM * tiles_n;
  const int ktc = (p.kc + BK - 1) / BK, KT = p.chunks * ktc;  // k-tiles a slice, a tile
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);  // one arrival per warp of the consuming warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The block's tiles are i = 0, 1, .. (tile blockIdx.x + i * gridDim.x, =
  // m block * tiles_n + n block); the producer loads their k-tiles (slice
  // by slice) in order and consumer warpgroup i % 2 multiplies tile i.  The
  // ring's stage and round are kept as counters: step it of the walk is
  // stage it % kStages, its (it / kStages)-th fill.
  if (wg == 0) {  // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int s = 0, round = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = tile / tiles_n * BM, n0 = tile % tiles_n * BN;
        for (int c = 0; c < p.chunks; ++c) {
          for (int kt = 0; kt < ktc; ++kt) {
            if (round > 0) mbar_wait(&empty[s], (round - 1) & 1);
            unsigned char* stage = ring + s * kStage;
            mbar_expect_tx(&full[s], kStage);
            tma_load3(stage, &map_a, &full[s], kt * BK, c, m0);
            tma_load3(stage + kTileA, &map_b, &full[s], n0, kt * BK, c);
            tma_load3(stage + kTileA + kBox, &map_b, &full[s], n0 + 64, kt * BK, c);
            if (++s == kStages) {
              s = 0;
              ++round;
            }
          }
        }
      }
    }
    return;
  }

  // Consumers, ping-pong: while one warpgroup runs its tile's epilogue the
  // other multiplies the next tile, so the tensor cores do not wait for
  // the epilogue.  The main loops (all of a tile's slices) take turns in
  // tile order (warpgroup c waits on named barrier 1 + c, which the other
  // arrives at when its main loop is done): so a consumer never waits on a
  // stage's barrier more than one fill ahead, where its phase parity would
  // be ambiguous.  Named barrier 3 + c syncs warpgroup c alone.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int cw = wg - 1;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c2 = 2 * (lane % 4);
  unsigned char* staging = ring + kOffStaging + cw * kStaging;
  bf16* tile_bias = reinterpret_cast<bf16*>(ring + kOffBias) + cw * BN;
  float acc[2][64];             // rows 64 * mh + 16 * warp + g (+ 8 h) of the tile
  uint32_t y[kChain ? 64 : 1];  // kEpiChain: y[32 mh + 2 jn + h], the pair of acc[mh][4 jn + 2 h]
  float keep[2][2];
  for (int i = cw, tile = blockIdx.x + cw * gridDim.x; tile < tiles;
       i += 2, tile += 2 * gridDim.x) {
    const int m0 = tile / tiles_n * BM, n0 = tile % tiles_n * BN;
    // 64 rows of the residual into the staging, 16 bytes a copy (rows and
    // columns past the output read as zeros): the first 64 before the
    // tile's products, so that the loads overlap them.
    auto fetch_residual = [&](int r0) {
      for (int idx = tid; idx < kWgRows * 16; idx += 128) {
        const int r = idx / 16, u = idx % 16, row = r0 + r, col = n0 + 8 * u;
        const bool ok = row < p.M && col < p.N;
        cp_async16(staging + staged(r, u),
                   ok ? p.residual + static_cast<size_t>(row) * p.N + col : p.residual, ok);
      }
      cp_async_commit();
    };
    if constexpr (kEpi == kEpiResidual) fetch_residual(m0);
    if constexpr (kBias) {  // the previous tile's epilogue ended at a warpgroup sync
      const int col = n0 + tid;
      tile_bias[tid] = col < p.N ? p.bias[col] : __float2bfloat16(0.f);
    }
#pragma unroll
    for (int mh = 0; mh < 2; ++mh)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + 64 * mh + 16 * warp + g + 8 * h;
        keep[mh][h] =
            kPads && row < p.M ? 1.f - __bfloat162float(p.pads[row]) : 1.f;
        if constexpr (kChain) {  // y = x: loads in flight during the products
#pragma unroll
          for (int jn = 0; jn < 16; ++jn) {
            const int col = n0 + 8 * jn + c2;  // N is a multiple of 8: col + 1 < N too
            y[32 * mh + 2 * jn + h] =
                row < p.M && col < p.N
                    ? ldg_u32(p.residual + static_cast<size_t>(row) * p.N + col)
                    : 0u;
          }
        }
      }
    if constexpr (kBias) warpgroup_sync(3 + cw);  // the bias is staged

    if (i > 0) consumer_sync(1 + cw);
    int s = i * KT % kStages, round = i * KT / kStages;
    for (int c = 0; c < p.chunks; ++c) {
#pragma unroll
      for (int mh = 0; mh < 2; ++mh)
#pragma unroll
        for (int e = 0; e < 64; ++e) acc[mh][e] = 0.f;
      int prev = -1;  // the stage of the k-tile still being multiplied
      for (int kt = 0; kt < ktc; ++kt) {
        mbar_wait(&full[s], round & 1);
        // A: 128 rows of 128 bytes, 8-row groups 1024 bytes apart; a
        // 16-deep step is 32 bytes along the row.  B: two [64 K rows, 64 N]
        // boxes of 8 KB side by side (LBO, the next 64 columns), 8-row
        // groups 1024 bytes apart (SBO); a 16-deep step is 16 rows.
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
            wgmma_m64n128k16(acc[mh], sw128_desc(a_base + mh * 64 * 128 + 32 * k, 16, 1024),
                             db);
        }
        wgmma_commit();
#pragma unroll
        for (int mh = 0; mh < 2; ++mh) fence_acc(acc[mh]);
        wgmma_wait<1>();  // the previous k-tile is multiplied: release its stage
        __syncwarp();
        if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
        prev = s;
        if (++s == kStages) {
          s = 0;
          ++round;
        }
      }
      if (c == p.chunks - 1 && tile + gridDim.x < tiles)
        consumer_arrive(2 - cw);  // tile i + 1 may start
      wgmma_wait<0>();
#pragma unroll
      for (int mh = 0; mh < 2; ++mh) fence_acc(acc[mh]);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[prev]);
      if constexpr (kChain) {  // fold slice c into y
#pragma unroll
        for (int jn = 0; jn < 16; ++jn) {
          float2 b = make_float2(0.f, 0.f);
          if (kBias && c == 0)
            b = bf16x2_to_float2(*reinterpret_cast<const uint32_t*>(tile_bias + 8 * jn + c2));
#pragma unroll
          for (int mh = 0; mh < 2; ++mh)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              float v0 = acc[mh][4 * jn + 2 * h], v1 = acc[mh][4 * jn + 2 * h + 1];
              if (kBias && c == 0) {
                v0 = __fadd_rn(v0, b.x);
                v1 = __fadd_rn(v1, b.y);
              }
              if constexpr (kPads) {
                v0 = __fmul_rn(v0, keep[mh][h]);
                v1 = __fmul_rn(v1, keep[mh][h]);
              }
              uint32_t& yy = y[32 * mh + 2 * jn + h];
              const float2 r = bf16x2_to_float2(yy);
              yy = float2_to_bf16x2(__fadd_rn(v0, r.x), __fadd_rn(v1, r.y));
            }
        }
      }
    }

    // The epilogue, 64 rows at a time: each thread's bf16 pairs go to the
    // warpgroup's staging (kEpiResidual reads its residual pair there
    // first), then the warpgroup writes the 64 rows out in 16-byte stores.
#pragma unroll
    for (int mh = 0; mh < 2; ++mh) {
      if constexpr (kEpi == kEpiResidual) {
        if (mh > 0) fetch_residual(m0 + 64);
        cp_async_wait<0>();
        warpgroup_sync(3 + cw);
      }
#pragma unroll
      for (int jn = 0; jn < 16; ++jn) {
        const int col = n0 + 8 * jn + c2;
        float2 b = make_float2(0.f, 0.f);
        if constexpr (kBias && !kChain)
          b = bf16x2_to_float2(*reinterpret_cast<const uint32_t*>(tile_bias + 8 * jn + c2));
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t* at = reinterpret_cast<uint32_t*>(staging + staged(16 * warp + g + 8 * h, jn) +
                                                     2 * c2);
          if constexpr (kChain) {
            *at = y[32 * mh + 2 * jn + h];
          } else {
            float v[2] = {acc[mh][4 * jn + 2 * h], acc[mh][4 * jn + 2 * h + 1]};
            const float bb[2] = {b.x, b.y};
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              if constexpr (kBias) v[e] = __fadd_rn(v[e], bb[e]);
              if constexpr (kEpi == kEpiQkv) {
                if (col + e < p.scaled_cols) v[e] = __fmul_rn(v[e], p.col_scale);
              } else if constexpr (kEpi == kEpiActKeep) {
                v[e] = activate<kAct>(v[e]);
                if constexpr (kPads) v[e] = __fmul_rn(v[e], keep[mh][h]);
              } else if constexpr (kPads) {
                v[e] = __fmul_rn(v[e], keep[mh][h]);
              }
            }
            if constexpr (kEpi == kEpiResidual) {
              const float2 r = bf16x2_to_float2(*at);
              v[0] = __fadd_rn(v[0], r.x);
              v[1] = __fadd_rn(v[1], r.y);
            }
            *at = float2_to_bf16x2(v[0], v[1]);
          }
        }
      }
      warpgroup_sync(3 + cw);  // every pair is staged
      for (int idx = tid; idx < kWgRows * 16; idx += 128) {
        const int r = idx / 16, u = idx % 16;
        const int row = m0 + 64 * mh + r, col = n0 + 8 * u;
        if (row < p.M && col < p.N)
          *reinterpret_cast<uint4*>(p.out + static_cast<size_t>(row) * p.N + col) =
              *reinterpret_cast<const uint4*>(staging + staged(r, u));
      }
      warpgroup_sync(3 + cw);  // the staging is free for the next rows
    }
  }
}

template <int kEpi, int kAct, bool kPads, bool kBias>
cudaError_t launch(const CUtensorMap& map_a, const CUtensorMap& map_b, const Epi& p, int grid,
                   cudaStream_t stream) {
  cudaError_t err = set_max_dynamic_smem<gemm_bf16_kernel<kEpi, kAct, kPads, kBias>>(kSmem);
  if (err != cudaSuccess) return err;
  gemm_bf16_kernel<kEpi, kAct, kPads, kBias><<<grid, kThreads, kSmem, stream>>>(map_a, map_b, p);
  return cudaGetLastError();
}

// The instantiation for the arguments: the epilogue, its activation
// (kEpiActKeep: GELU or ReLU) and whether pads (not read by kEpiQkv) and
// bias are given.
template <int kEpi, int kAct>
cudaError_t launch_with(const CUtensorMap& map_a, const CUtensorMap& map_b, const Epi& p,
                        int grid, cudaStream_t stream) {
  constexpr bool kReadsPads = kEpi != kEpiQkv;
  if (kReadsPads && p.pads && p.bias)
    return launch<kEpi, kAct, kReadsPads, true>(map_a, map_b, p, grid, stream);
  if (kReadsPads && p.pads)
    return launch<kEpi, kAct, kReadsPads, false>(map_a, map_b, p, grid, stream);
  if (p.bias) return launch<kEpi, kAct, false, true>(map_a, map_b, p, grid, stream);
  return launch<kEpi, kAct, false, false>(map_a, map_b, p, grid, stream);
}

}  // namespace

cudaError_t launch_gemm_bf16(const bf16* a, const bf16* b, const bf16* bias, const bf16* pads,
                             const bf16* residual, bf16* out, int M, int N, int K, int lda,
                             int epilogue, int activation, float col_scale, int scaled_cols,
                             int chunks, cudaStream_t stream) {
  const bool residual_epi = epilogue == kEpiResidual || epilogue == kEpiChain;
  if (M <= 0 || N <= 0 || K <= 0 || chunks < 1 || K % chunks || (K / chunks) % 8 || N % 8 ||
      lda % 8 || lda < K || (chunks > 1 && epilogue != kEpiChain) || (residual_epi && !residual) ||
      reinterpret_cast<uintptr_t>(a) % 16 || reinterpret_cast<uintptr_t>(b) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16 || reinterpret_cast<uintptr_t>(residual) % 16)
    return cudaErrorInvalidValue;
  const int kc = K / chunks;
  CUtensorMap map_a, map_b;
  constexpr auto kBf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  if (!tensor_map3(&map_a, kBf16, a, kc, chunks, M, 2L * kc, 2L * lda, BK, BM) ||
      !tensor_map3(&map_b, kBf16, b, N, kc, chunks, 2L * N, 2L * kc * N, 64, 1, BK))
    return cudaErrorInvalidValue;
  const Epi p{bias, pads, residual, out, M, N, chunks, kc, col_scale, scaled_cols};
  const long tiles = static_cast<long>((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  const int grid = static_cast<int>(tiles < sm_count() ? tiles : sm_count());
  switch (epilogue) {
    case kEpiQkv: return launch_with<kEpiQkv, kActNone>(map_a, map_b, p, grid, stream);
    case kEpiActKeep:
      if (activation == kActGelu)
        return launch_with<kEpiActKeep, kActGelu>(map_a, map_b, p, grid, stream);
      if (activation == kActRelu)
        return launch_with<kEpiActKeep, kActRelu>(map_a, map_b, p, grid, stream);
      return cudaErrorInvalidValue;
    case kEpiResidual: return launch_with<kEpiResidual, kActNone>(map_a, map_b, p, grid, stream);
    case kEpiChain: return launch_with<kEpiChain, kActNone>(map_a, map_b, p, grid, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace vp

// The product stage alone, for measurement and for composing the chained
// blocks from separate launches (chip_smoke.py [gemm], [kernels]).
extern "C" int vp_gemm_bf16(const void* a, const void* b, const void* bias, const void* pads,
                            const void* residual, void* out, int M, int N, int K, int lda,
                            int epilogue, int activation, float col_scale, int scaled_cols,
                            int chunks, void* stream) {
  using vp::bf16;
  return vp::launch_gemm_bf16(
      static_cast<const bf16*>(a), static_cast<const bf16*>(b), static_cast<const bf16*>(bias),
      static_cast<const bf16*>(pads), static_cast<const bf16*>(residual), static_cast<bf16*>(out),
      M, N, K, lda, epilogue, activation, col_scale, scaled_cols, chunks,
      static_cast<cudaStream_t>(stream));
}

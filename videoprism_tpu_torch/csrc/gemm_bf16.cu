// Tiled bf16 GEMM with fp32 accumulation and the block kernels' fused
// epilogues.
//
// Replaces the four matrix products inside K1 (_attn_block_kernel: fused
// QKV, output projection) and K2 (_ffn_block_kernel: W1, W2) of
// videoprism_tpu/ops/pallas/transformer_block.py, and the per-chunk output
// products of K8a/K8b (_attn_chunk_kernel, _ffn_chunk_kernel), with their
// epilogues:
//   kEpiQkv      (acc + bias) * query_scale on the q columns, cast;
//   kEpiActKeep  act(acc + b1) * keep, cast;              (exact-erf GELU)
//   kEpiResidual (acc [+ bias]) [* keep] + residual in fp32, cast.
// A is read with its own row pitch (lda), so a chunk's K-slice of a wider
// activation (K8a's ctx columns of one head group, K8b's F-slice of a) is
// multiplied in place.
//
// Bound: tensor-core FLOPs.  At the base model's shapes (K = 768 or 3072,
// N = 768..3072, M = B * 4096) every product does hundreds of FLOPs per byte
// of device memory, above the card's ~295 FLOP/byte ridge.  With wmma the
// next limit is shared-memory traffic per MMA.
// Design: 128x128x32 block tiles, 4 warps of 64x64 each computed with
// nvcuda::wmma 16x16x16 bf16 fragments into fp32 accumulators (8 fragment
// loads per 16 MMAs), and a four-stage cp.async pipeline so three K-slices
// load while one multiplies (75 KB of shared memory, two blocks per SM).
// Shared-memory rows are padded by 16 bytes to spread banks.  Measured
// without the epilogue on an H100 80GB HBM3 at 700 W, M = 32768: 8 warps of
// 64x32 ran 156-191 TFLOP/s with 3-4 stages, this layout 222-246.
// The epilogue stages each 16x16 accumulator through shared memory and
// writes 16-byte bf16 vectors, reading bias, paddings and the residual once
// per element: the activations between the products never make an extra
// trip to device memory.  Ragged M, N and K edges are masked (zero-filled
// loads, guarded stores).  wgmma/TMA, which reach the card's full rate, are
// left to later work.
#include <mma.h>

#include "common.cuh"

namespace vp {
namespace {

using namespace nvcuda;

constexpr int BM = 128, BN = 128, BK = 32;
constexpr int A_LD = BK + 8;   // bf16 elements per shared A row
constexpr int B_LD = BN + 8;   // bf16 elements per shared B row
constexpr int WARPS_N = 2;
constexpr int WM = 64, WN = 64;
constexpr int FM = WM / 16, FN = WN / 16;
constexpr int kThreads = 128;
constexpr int kStages = 4;
constexpr int kStageElems = BM * A_LD + BK * B_LD;
constexpr size_t kSmemBytes = sizeof(bf16) * kStages * kStageElems;

__device__ __forceinline__ float activate(float v, int act) {
  if (act == kActGelu) return 0.5f * v * (1.f + erff(v * 0.7071067811865476f));
  if (act == kActRelu) return fmaxf(v, 0.f);
  return v;
}

__global__ void __launch_bounds__(kThreads)
gemm_bf16_kernel(const bf16* __restrict__ a, const bf16* __restrict__ b,
                 const bf16* __restrict__ bias, const bf16* __restrict__ pads,
                 const bf16* __restrict__ residual, bf16* __restrict__ out, int M, int N, int K,
                 int lda, int epilogue, int act, float col_scale, int scaled_cols) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int warp_m = warp / WARPS_N, warp_n = warp % WARPS_N;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  auto load_tile = [&](int kt, int stage) {
    bf16* As = smem + stage * kStageElems;
    bf16* Bs = As + BM * A_LD;
    const int k0 = kt * BK;
#pragma unroll
    for (int i = 0; i < BM * BK / 8 / kThreads; ++i) {  // A: 128 rows x 4 chunks
      int c = tid + i * kThreads;
      int r = c / 4, col = (c % 4) * 8;
      bool ok = (m0 + r < M) && (k0 + col < K);
      const bf16* src = ok ? a + static_cast<size_t>(m0 + r) * lda + k0 + col : a;
      cp_async16(As + r * A_LD + col, src, ok);
    }
#pragma unroll
    for (int i = 0; i < BK * BN / 8 / kThreads; ++i) {  // B: 32 rows x 16 chunks
      int c = tid + i * kThreads;
      int r = c / 16, col = (c % 16) * 8;
      bool ok = (k0 + r < K) && (n0 + col < N);
      const bf16* src = ok ? b + static_cast<size_t>(k0 + r) * N + n0 + col : b;
      cp_async16(Bs + r * B_LD + col, src, ok);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int ktiles = (K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ktiles) load_tile(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile kt landed; everyone is done with tile kt - 1
    const int next = kt + kStages - 1;
    if (next < ktiles) load_tile(next, next % kStages);
    cp_async_commit();
    const bf16* As = smem + (kt % kStages) * kStageElems;
    const bf16* Bs = As + BM * A_LD;
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(fa[i], As + (warp_m * WM + i * 16) * A_LD + ks, A_LD);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(fb[j], Bs + ks * B_LD + warp_n * WN + j * 16, B_LD);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // Epilogue: each warp stages one 16x16 tile at a time in its own 1 KB of
  // the (now idle) pipeline buffer; each lane finishes 8 columns of a row.
  float* stage = reinterpret_cast<float*>(smem) + warp * 256;
  const int r = lane / 2, c8 = (lane % 2) * 8;
#pragma unroll
  for (int i = 0; i < FM; ++i) {
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      wmma::store_matrix_sync(stage, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int row = m0 + warp_m * WM + i * 16 + r;
      const int col = n0 + warp_n * WN + j * 16 + c8;
      if (row < M && col < N) {
        float v[8], bv[8] = {};
        if (bias) unpack8(*reinterpret_cast<const uint4*>(bias + col), bv);
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = stage[r * 16 + c8 + e] + bv[e];
        const float keep = pads ? 1.f - __bfloat162float(pads[row]) : 1.f;
        const size_t off = static_cast<size_t>(row) * N + col;
        if (epilogue == kEpiQkv) {
#pragma unroll
          for (int e = 0; e < 8; ++e)
            if (col + e < scaled_cols) v[e] *= col_scale;
        } else if (epilogue == kEpiActKeep) {
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] = activate(v[e], act) * keep;
        } else {
          float rv[8];
          unpack8(*reinterpret_cast<const uint4*>(residual + off), rv);
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] = (pads ? v[e] * keep : v[e]) + rv[e];
        }
        *reinterpret_cast<uint4*>(out + off) = pack8(v);
      }
      __syncwarp();
    }
  }
}

}  // namespace

cudaError_t launch_gemm_bf16(const bf16* a, const bf16* b, const bf16* bias, const bf16* pads,
                             const bf16* residual, bf16* out, int M, int N, int K, int lda,
                             int epilogue, int activation, float col_scale, int scaled_cols,
                             cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(gemm_bf16_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return err;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  gemm_bf16_kernel<<<grid, kThreads, kSmemBytes, stream>>>(a, b, bias, pads, residual, out, M, N, K,
                                                  lda, epilogue, activation, col_scale,
                                                  scaled_cols);
  return cudaGetLastError();
}

}  // namespace vp

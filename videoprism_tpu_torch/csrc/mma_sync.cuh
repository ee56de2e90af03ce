// Warp-level bf16 tensor-core helpers shared by K5 (flash_attention.cu) and
// K7 (flash_attention_bwd.cu): ldmatrix loads, mma.sync m16n8k16 with fp32
// accumulators, and the two tile products both kernels are built from.
//
// Fragment layout of mma.sync m16n8k16 (g = lane / 4, c = lane % 4): the
// accumulator holds rows g and g + 8 at columns 2c and 2c + 1; so element e
// of n-tile j of a 16 x 64 result is (row g + 8 * (e / 2), column 8j + 2c +
// e % 2).  Two neighbouring n-tiles of such a result are exactly the A
// operand (16 rows x 16 deep) of a following product, so a 16 x 64 block
// of logits never leaves registers.
#pragma once

#include "common.cuh"

namespace vp {

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Four 8x8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8, and receives row l / 4, columns 2 * (l % 4)
// and +1 of each matrix (transposed with .trans).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c[16x8] += a[16x16] @ b[16x8], bf16 operands, fp32 accumulators.
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  bf162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// The A operand fragments of a warp's 16 rows of a [rows, 16 * HT] bf16
// tile in shared memory (row stride ld), one per 16-deep slice.
template <int HT>
__device__ __forceinline__ void load_rows(uint32_t (&af)[HT][4], const bf16* rows, int ld,
                                          int lane) {
#pragma unroll
  for (int kk = 0; kk < HT; ++kk)
    ldsm_x4(af[kk], rows + (lane % 16) * ld + kk * 16 + (lane / 16) * 8);
}

// sc = a @ tile^T: a warp's 16 rows (fragments af) against the 64 rows of a
// [64, 16 * HT] bf16 tile in shared memory -> a 16 x 64 fp32 block.  K5
// and K7 compute every logit with this one sequence of instructions, so
// the same q and k tiles give bit-identical logits in both.
template <int HT>
__device__ __forceinline__ void tile_logits(float (&sc)[8][4], const uint32_t (&af)[HT][4],
                                            const bf16* tile, int ld, int lane) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HT; ++kk) {
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      uint32_t kf[4];
      const int m = lane / 8;
      ldsm_x4(kf, tile + (p * 16 + lane % 8 + 8 * (m >> 1)) * ld + kk * 16 + 8 * (m & 1));
      mma16816(sc[2 * p], af[kk], kf[0], kf[1]);
      mma16816(sc[2 * p + 1], af[kk], kf[2], kf[3]);
    }
  }
}

// acc += bf16(x) @ tile: a 16 x 64 fp32 block in accumulator layout, cast to
// bf16 in registers, times a [64, 16 * HT] bf16 tile in shared memory (row
// stride ld) -> 16 x 16 * HT in fp32 accumulators.
template <int HT>
__device__ __forceinline__ void mma_block_tile(float (&acc)[2 * HT][4], const float (&x)[8][4],
                                               const bf16* tile, int ld, int lane) {
#pragma unroll
  for (int p = 0; p < 4; ++p) {  // 16 rows of the tile: n-tiles 2p and 2p + 1 of x
    const uint32_t a[4] = {pack_bf16x2(x[2 * p][0], x[2 * p][1]),
                           pack_bf16x2(x[2 * p][2], x[2 * p][3]),
                           pack_bf16x2(x[2 * p + 1][0], x[2 * p + 1][1]),
                           pack_bf16x2(x[2 * p + 1][2], x[2 * p + 1][3])};
#pragma unroll
    for (int hp = 0; hp < HT; ++hp) {
      uint32_t vf[4];
      const int m = lane / 8;
      ldsm_x4_trans(vf, tile + (p * 16 + lane % 8 + 8 * (m & 1)) * ld + hp * 16 + 8 * (m >> 1));
      mma16816(acc[2 * hp], a, vf[0], vf[1]);
      mma16816(acc[2 * hp + 1], a, vf[2], vf[3]);
    }
  }
}

// Writes a warp's 16 x 16 * HT fp32 accumulators as bf16 rows row0 and
// row0 + 8 of a [rows, 16 * HT] matrix, rows at or past `rows` skipped.
template <int HT>
__device__ __forceinline__ void store_rows(bf16* out, const float (&acc)[2 * HT][4], int row0,
                                           int rows, int lane) {
  constexpr int H = 16 * HT;
  const int c2 = 2 * (lane % 4);
#pragma unroll
  for (int i = 0; i < 2 * HT; ++i) {
    const int col = i * 8 + c2;
    if (row0 < rows)
      *reinterpret_cast<bf162*>(out + static_cast<size_t>(row0) * H + col) =
          __floats2bfloat162_rn(acc[i][0], acc[i][1]);
    if (row0 + 8 < rows)
      *reinterpret_cast<bf162*>(out + static_cast<size_t>(row0 + 8) * H + col) =
          __floats2bfloat162_rn(acc[i][2], acc[i][3]);
  }
}

}  // namespace vp

// Warp-level helpers shared by K1's attention core (capped_attention.cu),
// K5 (flash_attention.cu) and K7 (flash_attention_bwd.cu): ldmatrix loads,
// mma.sync m16n8k16 with fp32 accumulators, the two tile products the
// three are built from, and the one per-logit weight of the capped softmax
// they all use, so that K7 recomputes the forward's probabilities bit for
// bit.
//
// The weight (logit_weight): with a cap, exp(cap * tanh(l / cap)) as
//   z = 2^(l * 2 log2(e) / cap), r = 1 / (z + 1), w = 2^(cap log2(e) (1 - 2r))
// on the special-function unit (ex2.approx, rcp.approx: three operations
// per logit, against ~40 instructions of the precise tanhf and expf), and
// 1 - tanh^2 = 4 r (1 - r) for the backward.  z = inf gives e^cap and z = 0
// e^-cap; the error in the exponent stays near 1e-5, so w is within ~1.5e-5
// relative of exp(cap tanh(l / cap)) over l in [-4 cap, 4 cap]
// (chip_smoke.py [kernels] sweeps it against fp64), far below bf16's
// 2^-9.  Without a cap, w = 2^((l - max) log2(e)).  A masked logit weighs
// 0 in both: a fully masked row sums to 0, and its probabilities are the
// reference's uniform 1/S (row_scale).  Probabilities
// are w times a reciprocal of the row sum taken once per row, with one
// correction step (normalise), not a division per logit: the correctly
// rounded w / sum of the reference.
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

constexpr double kLog2e = 1.4426950408889634;
// Rows of the row statistics K5 writes for K7 ([planes][B * N][t_pad] fp32,
// t_pad = T rounded up to this): K7's query tile.
constexpr int kStatRows = 64;

// Constants of logit_weight under a cap (all 0 without one), computed on
// the host in double from the cap.
struct CapConsts {
  float k1;  // 2 log2(e) / cap
  float k2;  // cap log2(e)
  float k3;  // -2 cap log2(e)
};

inline CapConsts cap_consts(float cap) {
  if (!(cap > 0.f)) return CapConsts{0.f, 0.f, 0.f};
  return CapConsts{static_cast<float>(2.0 * kLog2e / cap), static_cast<float>(cap * kLog2e),
                   static_cast<float>(-2.0 * cap * kLog2e)};
}

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Unnormalised weight of an unmasked logit l: exp(cap tanh(l / cap)) under
// a cap (r gets 1 / (exp(2 l / cap) + 1), so that tanh = 1 - 2 r), exp(l -
// mx) without one (mx the row max; r unused).
template <bool kCapped>
__device__ __forceinline__ float logit_weight(float l, float mx, const CapConsts& c, float& r) {
  if constexpr (kCapped) {
    r = rcp_approx(ex2_approx(l * c.k1) + 1.f);
    return ex2_approx(fmaf(c.k3, r, c.k2));
  } else {
    r = 0.f;
    return ex2_approx((l - mx) * static_cast<float>(kLog2e));
  }
}

// 1 - tanh^2 of a capped logit from logit_weight's r: 4 r (1 - r).
__device__ __forceinline__ float tanh_grad(float r) {
  const float r4 = 4.f * r;
  return fmaf(-r4, r, r4);
}

// A row's normalisation from its sum of weights (normalise): w / sum, or
// 1 / S for a fully masked row (sum 0, every w 0).
struct RowScale {
  float scale;  // 1 / sum, 0 for a fully masked row
  float shift;  // 1 / S for a fully masked row, else 0
  float sum;
};
__device__ __forceinline__ RowScale row_scale(float sum, int S) {
  return sum == 0.f ? RowScale{0.f, 1.f / static_cast<float>(S), 0.f}
                    : RowScale{1.f / sum, 0.f, sum};
}
// w / sum by the row's reciprocal and one correction step (the remainder w
// - q0 * sum is exact in an fma): the correctly rounded quotient, the
// reference's unnorm / denom, in three fmas instead of a division per
// logit.
__device__ __forceinline__ float normalise(float w, const RowScale& rs) {
  const float q0 = fmaf(w, rs.scale, rs.shift);
  return fmaf(fmaf(-q0, rs.sum, w), rs.scale, q0);
}

// Bit test of a mask word pre-shifted by the lane's column (c2, see
// above): bit 8 jn + e1 is column 8 jn + c2 + e1 of the 64-key tile.
__device__ __forceinline__ bool mask_bit(uint64_t word, int jn, int e) {
  return (word >> (jn * 8 + (e & 1))) & 1;
}

// The mask of a warp's query rows r0 and r0 + 8 (K5 and K7's query-major
// kernel) over 64-key tiles, as one word per tile and row half for
// mask_bit: a bit set where the key is below S and not masked.  One mask
// row for every query (mask_t = 1, the auxiliary encoder's): each lane
// fetches keys lane and lane + 32 of a tile one tile ahead (fetch), and the
// words are two ballots of those values; per-row masks: each lane loads its
// own 16 columns of each row.
struct KeyTileMask {
  const float* row[2];
  int S, mask_t, lane;
  float next[2] = {0.f, 0.f};

  __device__ KeyTileMask(const float* mask, int b, int mask_b, int mask_t_, int T, int S_, int r0,
                         int lane_)
      : S(S_), mask_t(mask_t_), lane(lane_) {
    const float* base = mask + static_cast<size_t>(mask_b > 1 ? b : 0) * mask_t * S;
    row[0] = base + static_cast<size_t>(mask_t > 1 ? min(r0, T - 1) : 0) * S;
    row[1] = base + static_cast<size_t>(mask_t > 1 ? min(r0 + 8, T - 1) : 0) * S;
  }
  __device__ __forceinline__ void fetch(int j) {
    if (mask_t != 1) return;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int s = j * 64 + lane + 32 * i;
      next[i] = s < S ? __ldg(row[0] + s) : kNegInf;
    }
  }
  // The words of tile j; `cur` holds what fetch(j) fetched.
  __device__ __forceinline__ void words(int j, const float (&cur)[2], uint64_t (&bits)[2]) const {
    const int c2 = 2 * (lane % 4);
    if (mask_t == 1) {
      const uint64_t word =
          __ballot_sync(0xffffffffu, cur[0] >= kMaskThreshold) |
          static_cast<uint64_t>(__ballot_sync(0xffffffffu, cur[1] >= kMaskThreshold)) << 32;
      bits[0] = bits[1] = word >> c2;
      return;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint64_t word = 0;
#pragma unroll
      for (int jn = 0; jn < 8; ++jn)
#pragma unroll
        for (int e1 = 0; e1 < 2; ++e1) {
          const int s = j * 64 + jn * 8 + c2 + e1;
          if (s < S && __ldg(row[h] + s) >= kMaskThreshold) word |= 1ull << (jn * 8 + e1);
        }
      bits[h] = word;
    }
  }
};

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

// sc = a @ tile^T: a warp's 16 rows (fragments af) against the 8 * NT rows
// of a [8 * NT, 16 * HT] bf16 tile in shared memory -> a 16 x 8 NT fp32
// block (NT n-tiles; 8 for a whole 64-key tile, 4 for half of one).  K1's
// core, K5 and K7 compute every logit with this one sequence of
// instructions, each n-tile's products summed over the head dim in the same
// order whatever NT, so the same q and k tiles give bit-identical logits in
// all three.
template <int HT, int NT = 8>
__device__ __forceinline__ void tile_logits(float (&sc)[NT][4], const uint32_t (&af)[HT][4],
                                            const bf16* tile, int ld, int lane) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HT; ++kk) {
#pragma unroll
    for (int p = 0; p < NT / 2; ++p) {
      uint32_t kf[4];
      const int m = lane / 8;
      ldsm_x4(kf, tile + (p * 16 + lane % 8 + 8 * (m >> 1)) * ld + kk * 16 + 8 * (m & 1));
      mma16816(sc[2 * p], af[kk], kf[0], kf[1]);
      mma16816(sc[2 * p + 1], af[kk], kf[2], kf[3]);
    }
  }
}

// acc += a @ rows 16p .. 16p + 15 of a [64, 16 * HT] bf16 tile in shared
// memory (row stride ld), a being the A operand of 16 keys (n-tiles 2p and
// 2p + 1 of a 16 x 64 block in accumulator layout, cast to bf16 pairs,
// pack_block).
template <int HT>
__device__ __forceinline__ void mma_rows(float (&acc)[2 * HT][4], const uint32_t (&a)[4],
                                         const bf16* tile, int ld, int p, int lane) {
#pragma unroll
  for (int hp = 0; hp < HT; ++hp) {
    uint32_t vf[4];
    const int m = lane / 8;
    ldsm_x4_trans(vf, tile + (p * 16 + lane % 8 + 8 * (m & 1)) * ld + hp * 16 + 8 * (m >> 1));
    mma16816(acc[2 * hp], a, vf[0], vf[1]);
    mma16816(acc[2 * hp + 1], a, vf[2], vf[3]);
  }
}

// The A operand of n-tiles 2p and 2p + 1 of a 16 x 64 fp32 block, x0 and
// x1 being those n-tiles, cast to bf16.
__device__ __forceinline__ void pack_block(uint32_t (&a)[4], const float (&x0)[4],
                                           const float (&x1)[4]) {
  a[0] = pack_bf16x2(x0[0], x0[1]);
  a[1] = pack_bf16x2(x0[2], x0[3]);
  a[2] = pack_bf16x2(x1[0], x1[1]);
  a[3] = pack_bf16x2(x1[2], x1[3]);
}

// acc += bf16(x) @ tile: a 16 x 64 fp32 block in accumulator layout, cast to
// bf16 in registers, times a [64, 16 * HT] bf16 tile in shared memory (row
// stride ld) -> 16 x 16 * HT in fp32 accumulators.
template <int HT>
__device__ __forceinline__ void mma_block_tile(float (&acc)[2 * HT][4], const float (&x)[8][4],
                                               const bf16* tile, int ld, int lane) {
#pragma unroll
  for (int p = 0; p < 4; ++p) {  // 16 rows of the tile: n-tiles 2p and 2p + 1 of x
    uint32_t a[4];
    pack_block(a, x[2 * p], x[2 * p + 1]);
    mma_rows<HT>(acc, a, tile, ld, p, lane);
  }
}

// Writes a warp's 16 x 16 * HT fp32 accumulators as bf16 rows row0 and
// row0 + 8 of a [rows, H] matrix (H <= 16 * HT, a multiple of 8): rows at
// or past `rows` and the zero-padded columns at or past H skipped.
template <int HT>
__device__ __forceinline__ void store_rows(bf16* out, const float (&acc)[2 * HT][4], int row0,
                                           int rows, int H, int lane) {
  const int c2 = 2 * (lane % 4);
#pragma unroll
  for (int i = 0; i < 2 * HT; ++i) {
    const int col = i * 8 + c2;
    if (col >= H) continue;
    if (row0 < rows)
      *reinterpret_cast<bf162*>(out + static_cast<size_t>(row0) * H + col) =
          __floats2bfloat162_rn(acc[i][0], acc[i][1]);
    if (row0 + 8 < rows)
      *reinterpret_cast<bf162*>(out + static_cast<size_t>(row0 + 8) * H + col) =
          __floats2bfloat162_rn(acc[i][2], acc[i][3]);
  }
}

// Copies rows [r0, r0 + n) of a [rows, H] bf16 matrix into a [n, 16 * HT +
// 8] shared tile with cp.async, zero-filling rows at or past `rows` and the
// columns from H to 16 * HT (zero q, k and v columns leave the logits and
// the kept columns of every product unchanged).  H is a multiple of 8, so
// each row is whole 16-byte chunks.
template <int HT>
__device__ __forceinline__ void copy_rows(bf16* dst, const bf16* src, int r0, int n, int rows,
                                          int H, int tid, int threads) {
  constexpr int LD = 16 * HT + 8, CH = 2 * HT;
  for (int i = tid; i < n * CH; i += threads) {
    const int r = i / CH, c = (i % CH) * 8;
    const bool ok = r0 + r < rows && c < H;
    cp_async16(dst + r * LD + c, src + (ok ? static_cast<size_t>(r0 + r) * H + c : 0), ok);
  }
}

}  // namespace vp

// K9, K10, K11, K12a and K12b: the int8 (W8A8) serving blocks of
// videoprism_tpu/ops/pallas/int8_blocks.py, as chains of two primitives
// and K1's attention core.
//
//   quant_rows_kernel  per-row (or per row and column chunk) symmetric int8
//                      quantization of a bf16 or fp32 value, with an
//                      optional fp32 LayerNorm in front (quant_rows and
//                      _ln_f32):
//                        s = max|h| * (1/127), s = max(s, 1e-12),
//                        q = clip(rint(h * (1/s)), -127, 127).
//                      rint rounds half to even like jnp.round (one
//                      addition of 1.5 * 2^23, see code_word); 1/s is an
//                      IEEE division (the build has no --use_fast_math).
//   gemm_i8_kernel     int8 x int8 -> int32 products with the blocks' fp32
//                      epilogues, in the reference's order:
//                        v = (float(acc) * row_scale) * col_scale; over K
//                        cut into chunks (head groups, F-chunks) each with
//                        its own row scale, v = v_0 + v_1 + .. in fp32;
//                        kI8Proj  (v + bias) * col_mul on the first
//                                 scaled_cols columns (q's query scale),
//                                 v + bias on the others -> bf16;
//                        kI8Act   act(v + bias) * keep -> fp32;
//                        kI8Out   v [+ running fp32 sum] -> the sum, or
//                                 ((v + bias) * keep) + residual -> bf16
//                                 (bias, keep and residual each optional);
//                        kI8Raw   the int32 sums themselves (measurement);
//                        kI8ActQuant  kI8Act's a quantized per row over
//                                 each output chunk -> int8 codes and
//                                 fp32 scales (K9's W1, see below).
//                      Every step is rounded on its own (__fmul_rn,
//                      __fadd_rn): no contraction merges a scale into a
//                      sum, so a product summed on chip and one summed
//                      through memory are the same bits.
//
// The GEMM gets A in one of four ways (I8Mode):
//   kQuantA      the block quantizes its own 64 rows of A from bf16 (with
//                the LN in front, or per chunk) in a prologue, into shared
//                memory, and keeps them there while it walks its N tiles;
//   kQuantAWide  the same for 128 rows (one K-chunk), walked in 128-row
//                tiles: each B stage feeds twice the rows (K12a, where the
//                128-row blocks need one N-group);
//   kTmaA        A's codes by TMA, 128-row tiles, one K-chunk (the chains
//                and the primitives run alone);
//   kTmaASum     A's codes by TMA, 64-row tiles, the chunks summed on chip.
//
// The blocks (_ffn_int8_chunk_kernel, _attn_int8_chunk_kernel,
// _layer_int8_kernel, _qkv_int8_kernel, _out_int8_kernel):
//   q|k|v              K11, K12a: kQuantA (K12a: or kQuantAWide) kI8Proj,
//                      LN1 + quantize in the prologue; K10:
//                      quant_rows_kernel, then kTmaA; one product over the
//                      fused [3NH, D] weights -> qkv bf16
//   attention          capped_attention_kernel (K1's core) -> ctx bf16
//   out = ctx @ Wo     K11, K12b: kQuantA kI8Out, ctx quantized per head
//                      group in the prologue, the groups summed on chip;
//                      K10: quant_rows_kernel per group, then kTmaA per
//                      group, chained
//   a = act(h @ W1)    K11: kQuantA kI8Act, LN2 + quantize in the prologue
//                      -> a fp32 [rows, F]; K9: quant_rows_kernel, then
//                      kTmaA kI8ActQuant -> a8, as (a stays on chip)
//   quantize a         K11: quant_rows_f32_kernel per F-chunk -> a8, as
//   out = a @ W2       K11: kTmaA (one chunk) or kTmaASum (the chunks summed
//                      on chip); K9: kTmaA per chunk, chained
// Chained blocks (K9, K10) cast the running output to bf16 after every
// chunk, with the bias (and K10's x) in chunk 0 only; the one-kernel layer
// (K11) sums the chunks' products in fp32 and casts once: six launches at
// any chunk counts.  The TPU recomputes LN and h8 per chunk and quantizes
// the hidden activation of a chunk from its own columns: the first
// product is the same bits for every column however the work is cut, so it
// runs over all columns at once, and only the quantization of ctx and a
// and the last product are cut into chunks.
//
// Weights are K-major ([N, K], K contiguous), written once at load by
// io/checkpoints.py prepare_for_kernels: q|k|v as [3NH, D], Wo as [D, NH],
// W1 as [F, D], W2 as [D, F].  8-bit wgmma reads both operands K-major
// only (it has no transposed B), and a chunk of the last product is then a
// column block of its weights, read in place with their row pitch.
//
// Bound: at the base model's shapes (K = 768 or 3072 with M = B * 4096
// rows) the products do hundreds of int8 operations per byte, above the
// card's ~590 op/byte ridge for int8, so the tensor cores bound them; the
// quantizers and the fp32 hidden activation (written once and read twice)
// are bytes.  On the TPU int8 ran at the bf16 rate and only saved weight
// bandwidth; on the H100 the int8 tensor cores run at twice the bf16 rate.
// Design of the product: gemm_bf16.cu's, in 8 bits.  One producer warp
// keeps TMA loads of the B tile ([128 rows, 128] of the K-major weights)
// and, in the TMA modes, of the A tile (128 or 64 rows of the codes) in
// flight through a ring of up to six (kQuantA: eight) mbarrier stages with
// 128-byte swizzle, its stage and round kept as counters; two consumer
// warpgroups take the block's tiles in turn (ping-pong), multiplying with
// wgmma.mma_async m64n128k32 .s32.s8.s8 into exact int32 registers, so one
// runs its epilogue while the other multiplies.  kTmaA's persistent blocks
// walk 128 x 128 tiles (two m64 halves, 128 int32 registers a thread); the
// modes that sum chunks take 64 x 128 tiles, whose accumulator and fp32
// running sum fit beside each other (64 + 64 registers): at each chunk's
// end the consumer folds (float(acc) * row_scale_c) * col_scale into the
// sum and zeroes acc.  The tensor maps are 3-D ([rows, chunks, kc]), so a
// k-tile that runs past a chunk's width reads zeros there, as the TPU's
// per-chunk products see it; K, every row pitch and the operands'
// addresses must be multiples of 16 bytes, N of 8.  The epilogue runs on
// the registers, in the fp32 order above; the bf16 outputs then go through
// a per-warpgroup staging in shared memory and out in 16-byte stores, whole
// rows at a time, with kI8Out's residual prefetched into that staging by
// cp.async when the tile starts (its loads overlap the products).
// kQuantA: a block owns 64 rows and a group of N tiles (row blocks x
// groups fill the SMs; each group quantizes its rows again, from L2).  The
// producer thread first fills the B ring; meanwhile all twelve warps stage
// the group's column scales and bias and quantize the rows: each warp runs
// quant_row (the body of quant_rows_kernel, so the codes and scales are
// the standalone quantizer's bits) on its (row, chunk) items, two or three
// rows' 16-byte loads in flight, and writes the codes into resident k-slabs
// laid out as TMA's 128-byte swizzle lays out a [64, 128] box (zeros past
// a chunk's width), the row scales beside them; the consumers' wgmma
// descriptors then point at a slab instead of a ring stage.  At K = 768
// the codes take 48 KB beside a ring of up to eight 16 KB stages; at
// giant's K = 1408, 88 KB beside five (rows of up to 2048 codes, in chunks
// of up to 1536 values).  The prologue, which only the block's twelve
// warps run while its tensor cores wait, is what the fused kernel pays for
// the round trip it saves: the chains (K9, K10) keep the standalone
// quantizer, which spreads the rows over every SM (first_product).
// kI8ActQuant (K9's W1, kTmaA's 128 x 128 tiles): a row's scale is the
// absmax over an F-chunk's columns, which 24 tiles of the same 128 rows
// compute on as many SMs (a band, at a chunk of 3072).  The tiles walk
// band after band; each tile keeps its fp32 activation in its accumulator
// registers, reduces its rows' absmax over its columns (two shuffles
// across the four lanes of a row), and one lane per row meets the band's
// other tiles in row_max [rows, chunks] in device memory (L2) by
// atomicMax on the value's bits; a counter per band, raised after a
// release fence, tells a tile when its band is met, and its warpgroup
// waits for it while the block's other warpgroup multiplies the next
// tile.  Then the tile forms its codes from the registers and writes them
// in 16-byte stores: the fp32 activation that kI8Act wrote and
// quant_rows_f32_kernel read back (0.4 GB at 32768 rows) never leaves the
// chip.  The launch is cooperative (see gemm() for why it cannot
// deadlock), and the LN'd quantizer in front zeroes row_max and the
// counters.
// kQuantAWide (K12a): 128 rows a block, walked in 128 x 128 tiles as kTmaA
// walks them (ping-pong, two m64 products per B stage), so each weight
// byte out of L2 feeds twice the rows; its codes take 96 KB at K = 768,
// beside five stages.  It is taken only where the 128-row blocks fill the
// SMs in one N-group (16384 rows and more at the base width): with two
// groups (8192 rows) each quantizes the same 128 rows, twice a 64-row
// block's prologue, which costs more than the halved weight traffic saves
// (measured on the card; so is the variant whose two warpgroups multiply
// each B stage together, over a 64-row half each, whose epilogues then
// leave the tensor cores idle).
// Design of the standalone quantizer: K6's row kernel (ln_rows.cu).  One
// warp per (row, chunk); a bf16 row of up to 2048 values is held in
// registers from one read in 16-byte loads, and the LN statistics, the
// absmax and the codes (eight per 8-byte store) all come from them.  K11's
// fp32 hidden activation (3072 values per row chunk at base and giant
// widths) is held across a block of 128 threads instead, also from one
// read in 16-byte loads: its codes for 64 rows x F = 3072 would not fit in
// shared memory beside a B ring, so W2 reads them by TMA.
#include <algorithm>

#include "tma_wgmma.cuh"

namespace vp {
namespace {

constexpr float kInv127 = static_cast<float>(1.0 / 127.0);

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

// clip(rint(v * (1/s)), -127, 127) in the low byte of a word.  |v| is at
// most the row's absmax m and 1/s at most 127 / m (s = max(m / 127, 1e-12)),
// so |v * (1/s)| stays below 127.5 and the clip never acts; rint is then
// one addition of 1.5 * 2^23, whose sum is rounded to an integer, to
// nearest and to even like rintf, with the integer's two's-complement low
// byte as the sum's low byte.  That takes two full-rate operations where a
// float-to-int conversion runs at a quarter of the rate (the quantizers
// are bound by their arithmetic).
__device__ __forceinline__ uint32_t code_word(float v, float inv_s) {
  return __float_as_uint(__fadd_rn(__fmul_rn(v, inv_s), 12582912.f));
}
// Two codes packed in the low half-word, four in a word, the first in the
// low byte.
__device__ __forceinline__ uint32_t code2(float a, float b, float inv_s) {
  return __byte_perm(code_word(a, inv_s), code_word(b, inv_s), 0x40);
}
__device__ __forceinline__ uint32_t code4(float a, float b, float c, float d, float inv_s) {
  return __byte_perm(code2(a, b, inv_s), code2(c, d, inv_s), 0x5410);
}
// A row's scale from its absmax m (NaN-free, >= 0), and its inverse: every
// quantizer and kI8ActQuant's epilogue take the same expression.
__device__ __forceinline__ float row_scale(float m, float& inv_s) {
  const float s = fmaxf(m * kInv127, 1e-12f);
  inv_s = 1.0f / s;
  return s;
}

// The fp32 LN of one value, each operation rounded on its own; g1 is the
// LN scale plus one (__fadd_rn(scale, 1)).
__device__ __forceinline__ float ln_value(float v, float mean, float inv, float g1, float h) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v, mean), inv), g1), h);
}

// x [rows, chunks * cols] (row pitch ldx) -> q [rows, chunks * cols] (pitch
// ldq), scale [rows, chunks].  With ln_scale (chunks = 1) the quantized
// value is the fp32 LayerNorm of the row, (x - mean) * rsqrt(var + eps) *
// (scale + 1) + bias.  With sync (K9's front, see BandSync), the kernel
// also zeroes the next product's row maxima of its rows and band counters.
struct QuantRows {
  const void* x;
  const bf16* ln_scale;
  const bf16* ln_bias;
  int8_t* q;
  float* scale;
  int ldx, ldq, rows, cols, chunks;
  float eps;
  float* row_max;         // [rows, sync_chunks] or null
  unsigned* band_count;   // [ceil(rows / 128), sync_chunks]
  int sync_chunks;        // at most 32
};

// Zeroes what kI8ActQuant meets its row maxima in for row `row` (lane l
// takes chunk l; the band counters with the first row of a 128-row block).
__device__ __forceinline__ void zero_sync(const QuantRows& p, int row, int lane) {
  if (!p.row_max || lane >= p.sync_chunks) return;
  p.row_max[static_cast<size_t>(row) * p.sync_chunks + lane] = 0.f;
  if (row % 128 == 0) p.band_count[static_cast<size_t>(row / 128) * p.sync_chunks + lane] = 0u;
}

// Lane l's 16-byte chunks l, l + 32, .. of a bf16 row of n8 such chunks.
template <int J>
__device__ __forceinline__ void load_row(const bf16* xr, int n8, int lane, uint4 (&xv)[J]) {
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int i = lane + 32 * j;
    if (i < n8) xv[j] = __ldg(reinterpret_cast<const uint4*>(xr) + i);
  }
}

// Quantizes one bf16 row of 8 n8 values held as load_row left it, with
// its fp32 LN in front when `ln`: ln_at(i, g1, h) gives the LN scale plus
// one and the bias of 16-byte chunk i's eight columns (from device memory,
// or staged in shared memory by the GEMM's prologue); calls emit(i, codes)
// with the chunk's eight codes packed in a uint2, returns the row's scale.
// quant_rows_kernel and the GEMM's prologue both run it, and every
// operation is rounded on its own, so both give the same bits.
template <int J, typename LnAt, typename Emit>
__device__ __forceinline__ float quant_row(const uint4 (&xv)[J], int n8, int lane, bool ln,
                                           LnAt&& ln_at, float eps, Emit&& emit) {
  const int cols = 8 * n8;
  // This lane's values, unpacked once and (with the LN) replaced by their
  // LN values once: the absmax and the codes read them from registers.
  float f[J][8];
#pragma unroll
  for (int j = 0; j < J; ++j)
    if (lane + 32 * j < n8) unpack8(xv[j], f[j]);
  if (ln) {
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < J; ++j)
      if (lane + 32 * j < n8)
#pragma unroll
        for (int e = 0; e < 8; ++e) acc = __fadd_rn(acc, f[j][e]);
    const float mean = warp_sum(acc) / cols;
    acc = 0.f;
#pragma unroll
    for (int j = 0; j < J; ++j)
      if (lane + 32 * j < n8)
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float d = __fsub_rn(f[j][e], mean);
          acc = __fadd_rn(acc, __fmul_rn(d, d));
        }
    const float inv = rsqrtf(warp_sum(acc) / cols + eps);
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int i = lane + 32 * j;
      if (i < n8) {
        float g1[8], h[8];
        ln_at(i, g1, h);
#pragma unroll
        for (int e = 0; e < 8; ++e) f[j][e] = ln_value(f[j][e], mean, inv, g1[e], h[e]);
      }
    }
  }
  float m = 0.f;
#pragma unroll
  for (int j = 0; j < J; ++j)
    if (lane + 32 * j < n8)
#pragma unroll
      for (int e = 0; e < 8; ++e) m = fmaxf(m, fabsf(f[j][e]));
  m = warp_max(m);
  float inv_s;
  const float s = row_scale(m, inv_s);
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int i = lane + 32 * j;
    if (i < n8) {
      emit(i, make_uint2(code4(f[j][0], f[j][1], f[j][2], f[j][3], inv_s),
                         code4(f[j][4], f[j][5], f[j][6], f[j][7], inv_s)));
    }
  }
  return s;
}

// bf16 rows held in registers: one warp per (row, chunk).
template <int J>
__global__ void quant_rows_kernel(const __grid_constant__ QuantRows p) {
  const int w = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (w >= p.rows * p.chunks) return;
  const int row = w / p.chunks, c = w % p.chunks;
  int8_t* qr = p.q + static_cast<size_t>(row) * p.ldq + static_cast<size_t>(c) * p.cols;
  uint4 xv[J];
  load_row<J>(static_cast<const bf16*>(p.x) + static_cast<size_t>(row) * p.ldx +
                  static_cast<size_t>(c) * p.cols,
              p.cols / 8, lane, xv);
  const float s = quant_row<J>(
      xv, p.cols / 8, lane, p.ln_scale != nullptr,
      [&](int i, float (&g1)[8], float (&h)[8]) {
        unpack8(__ldg(reinterpret_cast<const uint4*>(p.ln_scale) + i), g1);
        unpack8(__ldg(reinterpret_cast<const uint4*>(p.ln_bias) + i), h);
#pragma unroll
        for (int e = 0; e < 8; ++e) g1[e] = __fadd_rn(g1[e], 1.f);
      },
      p.eps, [&](int i, uint2 codes) { reinterpret_cast<uint2*>(qr)[i] = codes; });
  if (lane == 0) p.scale[static_cast<size_t>(row) * p.chunks + c] = s;
  zero_sync(p, row, lane);
}

// K11's fp32 hidden activation (up to 4096 values per row chunk, more than
// a warp's registers hold): one block of 128 threads per (row, chunk),
// thread t keeping the chunk's float4s t, t + 128, .. in registers, so the
// chunk is read from device memory once, in 16-byte loads; the absmax is
// reduced over the block, then the codes go out four per 4-byte store.
constexpr int kF32Threads = 128;
constexpr int kMaxF32Vectors = 8;   // float4s per thread: 4096 values a chunk

template <int V>
__global__ void __launch_bounds__(kF32Threads)
    quant_rows_f32_kernel(const __grid_constant__ QuantRows p) {
  __shared__ float warp_max_of[kF32Threads / 32];
  const int row = blockIdx.x / p.chunks, c = blockIdx.x % p.chunks;
  const float4* xr = reinterpret_cast<const float4*>(
      static_cast<const float*>(p.x) + static_cast<size_t>(row) * p.ldx +
      static_cast<size_t>(c) * p.cols);
  uint32_t* qr = reinterpret_cast<uint32_t*>(p.q + static_cast<size_t>(row) * p.ldq +
                                             static_cast<size_t>(c) * p.cols);
  const int n4 = p.cols / 4;
  float4 v[V];
  float m = 0.f;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int i = threadIdx.x + kF32Threads * j;
    if (i < n4) {
      v[j] = __ldg(xr + i);
      m = fmaxf(fmaxf(m, fabsf(v[j].x)), fmaxf(fabsf(v[j].y), fmaxf(fabsf(v[j].z), fabsf(v[j].w))));
    }
  }
  m = warp_max(m);
  if (threadIdx.x % 32 == 0) warp_max_of[threadIdx.x / 32] = m;
  __syncthreads();
  m = fmaxf(fmaxf(warp_max_of[0], warp_max_of[1]), fmaxf(warp_max_of[2], warp_max_of[3]));
  float inv_s;
  const float s = row_scale(m, inv_s);
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int i = threadIdx.x + kF32Threads * j;
    if (i < n4)
      qr[i] = code4(v[j].x, v[j].y, v[j].z, v[j].w, inv_s);
  }
  if (threadIdx.x == 0) p.scale[static_cast<size_t>(row) * p.chunks + c] = s;
}

// The streaming path for rows the two kernels above do not take (wider
// than 2048 bf16 or 4096 fp32 values, or not whole 16-byte chunks): one
// value per lane per step, the row re-read in each pass.
template <typename T>
__global__ void quant_rows_stream_kernel(const __grid_constant__ QuantRows p) {
  const int w = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (w >= p.rows * p.chunks) return;
  const int row = w / p.chunks, c = w % p.chunks;
  const T* xr = static_cast<const T*>(p.x) + static_cast<size_t>(row) * p.ldx +
                static_cast<size_t>(c) * p.cols;
  int8_t* qr = p.q + static_cast<size_t>(row) * p.ldq + static_cast<size_t>(c) * p.cols;

  float mean = 0.f, inv = 0.f;
  if (p.ln_scale) {
    float s = 0.f;
    for (int i = lane; i < p.cols; i += 32) s = __fadd_rn(s, to_f32(xr[i]));
    mean = warp_sum(s) / p.cols;
    float v2 = 0.f;
    for (int i = lane; i < p.cols; i += 32) {
      const float d = __fsub_rn(to_f32(xr[i]), mean);
      v2 = __fadd_rn(v2, __fmul_rn(d, d));
    }
    inv = rsqrtf(warp_sum(v2) / p.cols + p.eps);
  }
  auto value = [&](int i) {
    const float v = to_f32(xr[i]);
    if (!p.ln_scale) return v;
    return ln_value(v, mean, inv, __fadd_rn(__bfloat162float(p.ln_scale[i]), 1.f),
                    __bfloat162float(p.ln_bias[i]));
  };
  float m = 0.f;
  for (int i = lane; i < p.cols; i += 32) m = fmaxf(m, fabsf(value(i)));
  m = warp_max(m);
  float inv_s;
  const float s = row_scale(m, inv_s);
  for (int i = lane; i < p.cols; i += 32)
    qr[i] = static_cast<int8_t>(code_word(value(i), inv_s) & 0xFFu);
  if (lane == 0) p.scale[static_cast<size_t>(row) * p.chunks + c] = s;
  zero_sync(p, row, lane);
}

// The BandSync of K9's W1 (kI8ActQuant), whose row maxima and band
// counters the LN'd quantizer in front zeroes: row_max [rows, chunks] fp32
// and band_count [ceil(rows / 128), chunks] in one buffer of (rows +
// ceil(rows / 128)) * chunks 32-bit words.
struct BandSync {
  float* row_max;
  unsigned* band_count;
  int chunks;
};
inline BandSync band_sync(void* buf, int rows, int chunks) {
  float* row_max = static_cast<float*>(buf);
  return {row_max, reinterpret_cast<unsigned*>(row_max + static_cast<size_t>(rows) * chunks),
          chunks};
}

template <typename T>
cudaError_t quant(const T* x, int ldx, const bf16* ln_scale, const bf16* ln_bias, float eps,
                  int8_t* q, int ldq, float* scale, int rows, int cols, int chunks,
                  cudaStream_t stream, BandSync sync = {}) {
  if (sync.row_max && (chunks != 1 || sync.chunks < 1 || sync.chunks > 32))
    return cudaErrorInvalidValue;
  const QuantRows p{x,    ln_scale, ln_bias, q,   scale,        ldx,
                    ldq,  rows,     cols,    chunks, eps,         sync.row_max,
                    sync.band_count, sync.chunks};
  const long warps_total = static_cast<long>(rows) * chunks;
  const int warps = row_warps(warps_total);
  const int blocks = static_cast<int>((warps_total + warps - 1) / warps);
  constexpr int kPer16 = 16 / sizeof(T);  // values per 16-byte chunk
  const bool vec = cols % kPer16 == 0 && ldx % kPer16 == 0 && ldq % 8 == 0 && aligned16(x) &&
                   aligned16(q) && (!ln_scale || (aligned16(ln_scale) && aligned16(ln_bias)));
  const int v4 = (cols / 4 + kF32Threads - 1) / kF32Threads;
  if (vec && sizeof(T) == 4 && !ln_scale && v4 <= kMaxF32Vectors) {
    const int grid = rows * chunks;
    switch (v4) {
#define VP_QUANT_F32_CASE(n) \
  case n:                    \
    quant_rows_f32_kernel<n><<<grid, kF32Threads, 0, stream>>>(p); \
    break;
      VP_QUANT_F32_CASE(1) VP_QUANT_F32_CASE(2) VP_QUANT_F32_CASE(3) VP_QUANT_F32_CASE(4)
      VP_QUANT_F32_CASE(5) VP_QUANT_F32_CASE(6) VP_QUANT_F32_CASE(7) VP_QUANT_F32_CASE(8)
#undef VP_QUANT_F32_CASE
      default: return cudaErrorInvalidValue;
    }
    return cudaGetLastError();
  }
  const int j = row_chunks(cols);
  if (!vec || sizeof(T) != 2 || j > kMaxRowChunks) {
    quant_rows_stream_kernel<T><<<blocks, warps * 32, 0, stream>>>(p);
    return cudaGetLastError();
  }
  switch (j) {
#define VP_QUANT_CASE(n) \
  case n:                \
    quant_rows_kernel<n><<<blocks, warps * 32, 0, stream>>>(p); \
    break;
    VP_QUANT_CASE(1) VP_QUANT_CASE(2) VP_QUANT_CASE(3) VP_QUANT_CASE(4)
    VP_QUANT_CASE(5) VP_QUANT_CASE(6) VP_QUANT_CASE(7) VP_QUANT_CASE(8)
#undef VP_QUANT_CASE
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

enum I8Epilogue : int { kI8Proj = 0, kI8Act = 1, kI8Out = 2, kI8Raw = 3, kI8ActQuant = 4 };
enum I8Mode : int { kTmaA = 0, kTmaASum = 1, kQuantA = 2, kQuantAWide = 3 };

struct I8Epi {
  const float* a_scale;   // TMA modes: row m's scale of chunk c at a_scale[m * as_ld + c]
  const float* b_scale;   // [N]
  const bf16* bias;       // [N] or null
  const bf16* pads;       // [M] (keep = 1 - pad) or null
  const bf16* resid;      // [M, N] or null
  const float* acc_in;    // [M, N] running fp32 sum to add, or null (kTmaA kI8Out)
  float* acc_out;         // [M, N] running fp32 sum to write, or null (kTmaA kI8Out)
  void* out;              // bf16 (kI8Proj, kI8Out), fp32 (kI8Act) or int32 (kI8Raw), pitch ldo
  // The quantizing modes: A is quant_rows(x [M, K] bf16, row pitch ldx), per
  // chunk, with the fp32 LN in front when ln_scale is not null (one chunk).
  const bf16* x;
  const bf16* ln_scale;
  const bf16* ln_bias;
  float eps;
  int ldx, as_ld, ldo, M, N, K, epilogue, activation;
  int scaled_cols;        // kI8Proj: col_mul applies to columns below this
  float col_mul;          // kI8Proj: the query scale
  int chunks, kc;         // K = chunks * kc, each chunk with its own row scales
  int wide;               // with x: 128-row blocks where they pay (kQuantAWide)
  int stages, groups;     // set by gemm(): ring depth; the quantizing modes' N-groups
  // kI8ActQuant: the output's qchunks column chunks of qkc, each quantized
  // per row into out (int8 codes, pitch ldo) and code_scale [M, qchunks],
  // the rows' maxima met in sync (zeroed before the launch).
  float* code_scale;
  BandSync sync;
  int qkc;
};

constexpr int BN = 128;                // output tile width
constexpr int BK = 128;                // depth per stage: one 128-byte row
constexpr int kThreads = 384;          // producer + 2 consumer warpgroups
constexpr int kMaxStages = 6;          // the TMA modes' ring (A and B)
constexpr int kMaxStagesB = 8;         // the quantizing modes' ring (B only)
constexpr int kMinStagesWide = 3;      // kQuantAWide only where this many stages fit
constexpr int kWgRows = 64;            // rows of one warpgroup's m64 products
constexpr int kPrologueChunks = 6;     // kQuantA: 16-byte chunks a lane holds (1536 values a row)
constexpr int kSmemMax = 232448;       // an H100 block's dynamic shared memory

__host__ __device__ constexpr bool quantizes(int mode) {
  return mode == kQuantA || mode == kQuantAWide;
}
// Rows of one consumer warpgroup's tile, and of a quantizing block.
__host__ __device__ constexpr int tile_rows(int mode) {
  return mode == kTmaA || mode == kQuantAWide ? 128 : 64;
}
__host__ __device__ constexpr int block_rows(int mode) {
  return mode == kQuantAWide ? 128 : 64;
}
__host__ __device__ constexpr int stage_bytes(int mode) {
  return (quantizes(mode) ? 0 : tile_rows(mode) * BK) + BN * BK;
}
// Bytes of one output element in the staging: the bf16 outputs (kI8Proj,
// kI8Out) and kI8ActQuant's codes are staged; kI8Act's fp32 and the int32
// sums go out directly (kI8Act's staging would take 64 KB of the B ring).
// A staged row's pitch is 128 columns and 16 bytes, so that the
// accumulator layout's pair stores (eight rows by four column pairs a
// warp) fall in different banks.
__host__ __device__ constexpr int out_bytes(int epilogue) {
  return epilogue == kI8Proj || epilogue == kI8Out ? 2 : epilogue == kI8ActQuant ? 1 : 0;
}
__host__ __device__ constexpr int out_pitch(int epilogue) {
  return BN * out_bytes(epilogue) + 16;
}

// Byte offsets in shared memory past the 1 KB of slack that aligns the
// ring to the swizzle's 1024-byte period: the ring, the quantizing modes'
// resident codes (block_rows x 128 bytes a k-tile), a full and an empty
// barrier per stage, column scales (fp32) and bias (bf16): the TMA modes'
// per consumer warpgroup for its tile, the quantizing modes' for the
// block's N-group (group_tiles tiles), staged once; the quantizing modes'
// row scales, and their LN's scale plus one and bias over the row's
// ln_cols columns (fp32; none without the LN); each consumer warpgroup's
// output staging, 64 rows of its tile.
struct SmemLayout {
  int codes, bars, cs, bias, row_scales, ln, out, total;
};
__host__ __device__ inline SmemLayout smem_layout(int mode, int epilogue, int stages, int chunks,
                                                  int ktc, int group_tiles, int ln_cols) {
  const bool quant = quantizes(mode);
  const int cols = (quant ? group_tiles : 2) * BN;
  SmemLayout s;
  s.codes = stages * stage_bytes(mode);
  s.bars = s.codes + (quant ? chunks * ktc * block_rows(mode) * BK : 0);
  s.cs = s.bars + 2 * stages * 8;
  s.bias = s.cs + cols * 4;
  s.row_scales = s.bias + cols * 2;
  s.ln = s.row_scales + (quant ? chunks * block_rows(mode) * 4 : 0);
  s.out = s.ln + 2 * ln_cols * 4;
  s.total = 1024 + s.out + (out_bytes(epilogue) ? 2 * kWgRows * out_pitch(epilogue) : 0);
  return s;
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous products.
__device__ __forceinline__ void fence_acc(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d[64 x 128] += A[64 x 32] @ B[32 x 128]^T, both K-major int8, exact int32
// sums; the accumulator layout of lane l of warp w is that of mma.sync:
// d[4j + 2h + e] is row 16w + l / 4 + 8h, column 8j + 2 (l % 4) + e.
__device__ __forceinline__ void wgmma_m64n128k32_s8(int (&d)[64], uint64_t desc_a,
                                                    uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]),
        "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]),
        "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),
        "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]),
        "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]),
        "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]),
        "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]),
        "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// Named barrier `id` over one consumer warpgroup (128 threads).
__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// kI8ActQuant's meeting of a band's tiles in device memory (L2), run by one
// thread of a warpgroup after a barrier over it: the warpgroup's row-max
// atomics are released to the device, the band's counter raised with
// release semantics, and the thread spins with acquire loads until all
// `tiles` of the band have raised it; like mbar_wait it traps (a launch
// error, not a hung card) after ~10 s.
__device__ __forceinline__ void band_arrive_and_wait(unsigned* count, int tiles) {
  asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
  asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" ::"l"(count) : "memory");
  const long long start = clock64();
  for (;;) {
    unsigned seen;
    asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(seen) : "l"(count) : "memory");
    if (seen >= static_cast<unsigned>(tiles)) break;
    if (clock64() - start > 20000000000LL) __trap();
    __nanosleep(64);
  }
}
// A value other blocks wrote before the band's meeting, read from L2.
__device__ __forceinline__ float ld_relaxed(const float* p) {
  float v;
  asm volatile("ld.relaxed.gpu.global.f32 %0, [%1];\n" : "=f"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ float activate(float v, int act) {
  if (act == kActGelu) return 0.5f * v * (1.f + erff(v * 0.7071067811865476f));
  if (act == kActRelu) return fmaxf(v, 0.f);
  return v;
}

__device__ __forceinline__ float2 bf16x2_to_float2(uint32_t w) {
  return __bfloat1622float2(*reinterpret_cast<const bf162*>(&w));
}

// v = (float(acc) * row_scale) * col_scale.
__device__ __forceinline__ float scaled(int acc, float rs, float cs) {
  return __fmul_rn(__fmul_rn(__int2float_rn(acc), rs), cs);
}

// Epilogue kEpi (activation kAct) of two neighbouring elements (row,
// col) and (row, col + 1): their scaled products v (summed over the
// chunks), the row's keep, the columns' bias pair (from shared memory,
// unpacked once for the column pair's rows); the result goes to `staged`,
// the pair's place in the warpgroup's output staging, where kI8Out finds
// its residual pair (prefetched there), or, for a running fp32 sum, to
// acc_out in device memory.  The epilogue and the activation are template
// constants: the tile's 64 inlined copies then hold one epilogue's code,
// not all of them (the fully unrolled loop's code size, not its
// arithmetic, is what a run-time switch costs).  kI8Act writes its fp32
// pair to device memory directly.
template <int kEpi, int kAct>
__device__ __forceinline__ void finish2(const I8Epi& p, int row, int col, float v0, float v1,
                                        float keep, float2 b, unsigned char* staged) {
  float v[2] = {v0, v1};
  const float bb[2] = {b.x, b.y};
  if constexpr (kEpi == kI8Proj) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      v[e] = __fadd_rn(v[e], bb[e]);
      if (col + e < p.scaled_cols) v[e] = __fmul_rn(v[e], p.col_mul);
    }
    *reinterpret_cast<bf162*>(staged) = __floats2bfloat162_rn(v[0], v[1]);
    return;
  }
  if constexpr (kEpi == kI8Act) {
#pragma unroll
    for (int e = 0; e < 2; ++e) v[e] = __fmul_rn(activate(__fadd_rn(v[e], bb[e]), kAct), keep);
    *reinterpret_cast<float2*>(static_cast<float*>(p.out) + static_cast<size_t>(row) * p.ldo +
                               col) = make_float2(v[0], v[1]);
    return;
  }
  const size_t off = static_cast<size_t>(row) * p.N + col;
  if (p.acc_in) {
    const float2 r = __ldg(reinterpret_cast<const float2*>(p.acc_in + off));
    v[0] = __fadd_rn(r.x, v[0]);
    v[1] = __fadd_rn(r.y, v[1]);
  }
  if (p.acc_out) {
    *reinterpret_cast<float2*>(p.acc_out + off) = make_float2(v[0], v[1]);
    return;
  }
  const float2 r = p.resid ? bf16x2_to_float2(*reinterpret_cast<const uint32_t*>(staged))
                           : make_float2(0.f, 0.f);
  const float rr[2] = {r.x, r.y};
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    if (p.bias) v[e] = __fadd_rn(v[e], bb[e]);
    if (p.pads) v[e] = __fmul_rn(v[e], keep);
    if (p.resid) v[e] = __fadd_rn(v[e], rr[e]);
  }
  *reinterpret_cast<bf162*>(staged) = __floats2bfloat162_rn(v[0], v[1]);
}

// The quantizing modes' prologue: the block's R rows of A (from row m0)
// quantized into the resident k-slabs (chunk c's k-tile kt at codes + (c *
// ktc + kt) * R * 128; 16-byte unit u of row r at r * 128 + (u ^ r % 8) *
// 16, TMA's 128-byte swizzle of an [R, 128] box), zeros past a chunk's
// width, the row scales to row_scales[c * R + r].  Warp w takes the (row, chunk)
// items w, w + 12, .., each read in 16-byte loads into registers, D rows
// in flight (three for rows of up to 1024 values, else two, so that the
// registers hold them): once item i is quantized, item i + 12 D's loads are
// issued into its registers, so that a row's memory latency overlaps the
// quantization of the D - 1 items before it; the LN's scale plus one and
// bias come from ln_g1 and ln_h in shared memory (fp32, staged once per
// block: read from device memory per item, their loads waited in every
// item).  Rows past M are left as they are: their products are never
// written.
template <int J, int R>
__device__ __forceinline__ void quantize_rows(const I8Epi& p, int m0, unsigned char* codes,
                                              float* row_scales, const float* ln_g1,
                                              const float* ln_h) {
  constexpr int W = kThreads / 32, D = J <= 4 ? 3 : 2;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n8 = p.kc / 8, ktc = (p.kc + BK - 1) / BK;
  const int tail = p.kc % BK;   // a chunk's codes end here in its last k-tile (0: whole)
  constexpr int kSlab = R * BK;  // bytes of one resident k-tile of codes
  const int items = min(R, p.M - m0) * p.chunks;
  auto row_of = [&](int item) {
    return p.x + static_cast<size_t>(m0 + item / p.chunks) * p.ldx +
           static_cast<size_t>(item % p.chunks) * p.kc;
  };
  uint4 buf[D][J];  // the rows in flight, item warp + W (base + u) in buf[u]
#pragma unroll
  for (int u = 0; u < D; ++u)
    if (warp + W * u < items) load_row<J>(row_of(warp + W * u), n8, lane, buf[u]);
  for (int base = warp; base < items; base += W * D) {
#pragma unroll
    for (int u = 0; u < D; ++u) {
      const int item = base + W * u;
      if (item >= items) break;
      const int local = item / p.chunks, c = item % p.chunks;
      unsigned char* row_codes = codes + static_cast<size_t>(c) * ktc * kSlab + local * BK;
      const int swz = local % 8;
      const float s = quant_row<J>(
          buf[u], n8, lane, p.ln_scale != nullptr,
          [&](int i, float (&g1)[8], float (&h)[8]) {
#pragma unroll
            for (int e = 0; e < 8; e += 4) {
              const float4 a = *reinterpret_cast<const float4*>(ln_g1 + 8 * i + e);
              const float4 b = *reinterpret_cast<const float4*>(ln_h + 8 * i + e);
              g1[e] = a.x, g1[e + 1] = a.y, g1[e + 2] = a.z, g1[e + 3] = a.w;
              h[e] = b.x, h[e + 1] = b.y, h[e + 2] = b.z, h[e + 3] = b.w;
            }
          },
          p.eps, [&](int i, uint2 q) {
            const int col = 8 * i;
            *reinterpret_cast<uint2*>(row_codes + col / BK * kSlab +
                                      (((col % BK / 16) ^ swz) * 16) + col % 16) = q;
          });
      if (tail && lane < (BK - tail) / 16)
        *reinterpret_cast<uint4*>(row_codes + (ktc - 1) * kSlab +
                                  (((tail / 16 + lane) ^ swz) * 16)) = make_uint4(0, 0, 0, 0);
      if (lane == 0) row_scales[c * R + local] = s;
      if (item + W * D < items) load_row<J>(row_of(item + W * D), n8, lane, buf[u]);
    }
  }
}

template <int kEpi, int kAct, int kMode>
__global__ void __launch_bounds__(kThreads, 1)
    gemm_i8_kernel(const __grid_constant__ CUtensorMap map_a,
                   const __grid_constant__ CUtensorMap map_b,
                   const __grid_constant__ I8Epi p) {
  constexpr int TR = tile_rows(kMode), MH = TR / 64, kStage = stage_bytes(kMode);
  constexpr int R = block_rows(kMode), kSlab = R * BK;  // the quantizing modes' rows
  constexpr bool kSum = TR == 64;  // 64-row tiles, the chunks summed on chip
  constexpr bool kQuant = quantizes(kMode);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int S = p.stages, ktc = (p.kc + BK - 1) / BK, KT = p.chunks * ktc;
  // kI8ActQuant walks each row block's output chunks, band_tiles N tiles a
  // chunk (the last may run past the chunk's columns: masked); with chunks
  // of whole tiles that is the plain tile order.
  constexpr bool kActQuant = kEpi == kI8ActQuant;
  const int band_tiles = kActQuant ? (p.qkc + BN - 1) / BN : 1;
  const int tiles_n = kActQuant ? p.sync.chunks * band_tiles : (p.N + BN - 1) / BN;
  const int per_group = (tiles_n + p.groups - 1) / p.groups;  // the quantizing modes
  const int ln_cols = kQuant && p.ln_scale ? p.K : 0;
  const SmemLayout L = smem_layout(kMode, kEpi, S, p.chunks, ktc, per_group, ln_cols);
  unsigned char* codes = ring + L.codes;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + L.bars);
  uint64_t* empty = full + S;
  float* stage_cs = reinterpret_cast<float*>(ring + L.cs);           // [2 | per_group][BN]
  uint16_t* stage_bias = reinterpret_cast<uint16_t*>(ring + L.bias);  // the same
  float* row_scales = reinterpret_cast<float*>(ring + L.row_scales);  // kQuant [chunks][R]
  float* ln_g1 = reinterpret_cast<float*>(ring + L.ln);               // kQuant [ln_cols]
  float* ln_h = ln_g1 + ln_cols;
  const int wg = threadIdx.x / 128;

  // The block's tiles: the quantizing modes' are the N tiles of its group
  // over its R rows; the TMA modes' every gridDim.x-th tile of the output
  // from blockIdx.x (grid <= tiles).
  int ntiles, m_first = 0, n_first = 0;
  if constexpr (kQuant) {
    m_first = blockIdx.x / p.groups * R;
    n_first = blockIdx.x % p.groups * per_group;
    ntiles = min(per_group, tiles_n - n_first);
  } else {
    const int tiles = (p.M + TR - 1) / TR * tiles_n;
    ntiles = (tiles - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;
  }
  auto tile_at = [&](int i, int& m0, int& n0) {
    if constexpr (kQuant) {
      m0 = m_first;
      n0 = (n_first + i) * BN;
    } else {
      const int tile = blockIdx.x + i * gridDim.x, nn = tile % tiles_n;
      m0 = tile / tiles_n * TR;
      n0 = kActQuant ? nn / band_tiles * p.qkc + nn % band_tiles * BN : nn * BN;
    }
  };
  // The producer's steps from..to - 1 of the block's walk (tile, chunk,
  // k-tile), the ring's stage and round kept as counters: no division per
  // step, since one thread issuing every load must not fall behind.
  auto produce = [&](int from, int to) {
    int it = 0, s = 0, round = 0;
    for (int i = 0; i < ntiles && it < to; ++i) {
      int m0, n0;
      tile_at(i, m0, n0);
      for (int c = 0; c < p.chunks && it < to; ++c) {
        for (int kt = 0; kt < ktc && it < to; ++kt, ++it) {
          if (it >= from) {
            if (round > 0) mbar_wait(&empty[s], (round - 1) & 1);
            unsigned char* stage = ring + s * kStage;
            mbar_expect_tx(&full[s], kStage);
            if constexpr (!kQuant) {
              tma_load3(stage, &map_a, &full[s], kt * BK, c, m0);
              stage += TR * BK;
            }
            tma_load3(stage, &map_b, &full[s], kt * BK, c, n0);
          }
          if (++s == S) {
            s = 0;
            ++round;
          }
        }
      }
    }
  };
  const int steps = ntiles * KT;

  for (int i = threadIdx.x; i < ln_cols; i += kThreads) {  // ordered by the barrier below
    ln_g1[i] = __fadd_rn(__bfloat162float(p.ln_scale[i]), 1.f);
    ln_h[i] = __bfloat162float(p.ln_bias[i]);
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);  // one arrival per warp of the consuming warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  int it0 = 0;  // the producer's first step after the prologue
  if constexpr (kQuant) {
    // The column scales and bias of the block's N tiles, staged once (the
    // prologue's barriers order them before their reads).
    for (int idx = threadIdx.x; idx < ntiles * BN; idx += kThreads) {
      const int col = n_first * BN + idx;
      const bool ok = col < p.N;
      stage_cs[idx] = ok ? __ldg(p.b_scale + col) : 0.f;
      stage_bias[idx] =
          ok && p.bias ? __ldg(reinterpret_cast<const unsigned short*>(p.bias) + col) : 0;
    }
    // The ring's first stages need no release: they load while every warp
    // quantizes the block's rows.
    it0 = min(S, steps);
    if (threadIdx.x == 0) produce(0, it0);
    const int j = (p.kc / 8 + 31) / 32;  // 16-byte chunks per lane
    if (j <= 1) quantize_rows<1, R>(p, m_first, codes, row_scales, ln_g1, ln_h);
    else if (j <= 2) quantize_rows<2, R>(p, m_first, codes, row_scales, ln_g1, ln_h);
    else if (j <= 3) quantize_rows<3, R>(p, m_first, codes, row_scales, ln_g1, ln_h);
    else if (j <= 4) quantize_rows<4, R>(p, m_first, codes, row_scales, ln_g1, ln_h);
    else quantize_rows<6, R>(p, m_first, codes, row_scales, ln_g1, ln_h);
    fence_proxy_async_shared();
    __syncthreads();
  }

  // The tile walk, the ring's use and the consumers' turns are
  // gemm_bf16_kernel's (gemm_bf16.cu).
  if (wg == 0) {  // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) produce(it0, steps);
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int cw = wg - 1;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, c2 = 2 * (lane % 4);
  constexpr bool raw = kEpi == kI8Raw;
  constexpr int kOB = out_bytes(kEpi), kPitch = out_pitch(kEpi);  // kOB 0: not staged
  unsigned char* staging = ring + L.out + cw * kWgRows * kPitch;  // this warpgroup's
  const bool with_res = kEpi == kI8Out && p.resid && !p.acc_out;
  int acc[MH][64];         // rows 64 * mh + 16 * warp + g (+ 8) of the tile
  float sum[kSum ? 64 : 1];
  for (int i = cw; i < ntiles; i += 2) {
    int m0, n0;
    tile_at(i, m0, n0);
    // The residual of 64 rows of the tile into the staging, 16 bytes a
    // copy (rows and columns past the output read as zeros): the first 64
    // before the tile's products, so that the loads overlap them.
    auto fetch_residual = [&](int r0) {
      for (int idx = threadIdx.x % 128; idx < kWgRows * 16; idx += 128) {
        const int r = idx / 16, u = idx % 16, row = r0 + r, col = n0 + 8 * u;
        const bool ok = row < p.M && col < p.N;
        cp_async16(staging + r * kPitch + 16 * u,
                   ok ? p.resid + static_cast<size_t>(row) * p.N + col : p.resid, ok);
      }
      cp_async_commit();
    };
    if (with_res) fetch_residual(m0);
    // The tile's column scales and bias in shared memory: the quantizing
    // modes' staged with the block's; the TMA modes' go to this
    // warpgroup's staging (one column per thread) while it waits for its
    // turn.  The folds and the epilogue then read them without a global
    // load between their stores.
    const float* tile_cs = stage_cs + (kQuant ? i : cw) * BN;
    const uint16_t* tile_bias = stage_bias + (kQuant ? i : cw) * BN;
    if constexpr (!kQuant) {
      warpgroup_sync(3 + cw);  // the previous tile's epilogue is done with them
      const int col = n0 + threadIdx.x % 128;
      const bool ok = col < p.N && !raw;
      stage_cs[cw * BN + threadIdx.x % 128] = ok ? __ldg(p.b_scale + col) : 0.f;
      stage_bias[cw * BN + threadIdx.x % 128] =
          ok && p.bias ? __ldg(reinterpret_cast<const unsigned short*>(p.bias) + col) : 0;
      warpgroup_sync(3 + cw);
    }
    if (i > 0) consumer_sync(1 + cw);

    // The ring's stage and round of the tile's first step, then counters.
    int s = i * KT % S, round = i * KT / S;
    const unsigned char* slab = codes;  // the k-tile's resident codes
    for (int c = 0; c < p.chunks; ++c) {
      float rs[2] = {0.f, 0.f};  // kSum: the rows' scales of chunk c
      if constexpr (kSum) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int local = 16 * warp + g + 8 * h;
          if constexpr (kQuant) rs[h] = row_scales[c * R + local];
          else if (m0 + local < p.M)
            rs[h] = __ldg(p.a_scale + static_cast<size_t>(m0 + local) * p.as_ld + c);
        }
      }
#pragma unroll
      for (int mh = 0; mh < MH; ++mh)
#pragma unroll
        for (int e = 0; e < 64; ++e) acc[mh][e] = 0;
      int prev = -1;  // the stage of the k-tile still being multiplied
      for (int kt = 0; kt < ktc; ++kt, slab += kSlab) {
        mbar_wait(&full[s], round & 1);
        // A and B: rows of 128 bytes each, 8-row groups 1024 bytes apart; a
        // 32-deep step is 32 bytes along the rows.
        const uint32_t stage = smem_u32(ring + s * kStage);
        const uint32_t a_base = kQuant ? smem_u32(slab) : stage;
        const uint32_t b_base = kQuant ? stage : stage + TR * BK;
#pragma unroll
        for (int mh = 0; mh < MH; ++mh) fence_acc(acc[mh]);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < BK / 32; ++k) {
          const uint64_t db = sw128_desc(b_base + 32 * k, 16, 1024);
#pragma unroll
          for (int mh = 0; mh < MH; ++mh)
            wgmma_m64n128k32_s8(acc[mh], sw128_desc(a_base + mh * 64 * 128 + 32 * k, 16, 1024),
                                db);
        }
        wgmma_commit();
#pragma unroll
        for (int mh = 0; mh < MH; ++mh) fence_acc(acc[mh]);
        wgmma_wait<1>();  // the previous k-tile is multiplied: release its stage
        __syncwarp();
        if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
        prev = s;
        if (++s == S) {
          s = 0;
          ++round;
        }
      }
      if (c == p.chunks - 1 && i + 1 < ntiles) consumer_arrive(2 - cw);  // tile i + 1 may start
      wgmma_wait<0>();
#pragma unroll
      for (int mh = 0; mh < MH; ++mh) fence_acc(acc[mh]);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[prev]);
      if constexpr (kSum) {  // fold chunk c into the running sum
#pragma unroll
        for (int jn = 0; jn < 16; ++jn) {
          const float2 cs = *reinterpret_cast<const float2*>(tile_cs + 8 * jn + c2);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int e0 = 4 * jn + 2 * h;
            const float v0 = scaled(acc[0][e0], rs[h], cs.x);
            const float v1 = scaled(acc[0][e0 + 1], rs[h], cs.y);
            sum[e0] = c == 0 ? v0 : __fadd_rn(sum[e0], v0);
            sum[e0 + 1] = c == 0 ? v1 : __fadd_rn(sum[e0 + 1], v1);
          }
        }
      }
    }

    // kI8ActQuant: a = act(v + b1) * keep in fp32 (kI8Act's bits) stays in
    // registers; each row's absmax over the tile's columns of its chunk goes
    // to row_max by atomicMax on its bits (exact for values >= 0, and a max
    // does not depend on the order), one lane per row; then the band's
    // counter is raised and the warpgroup waits until every tile of the
    // band has raised it, meanwhile the other warpgroup multiplies.  The
    // codes and scales are then those quant_rows_f32_kernel takes from the
    // fp32 a (row_scale, code2), written through the staging in 16-byte
    // stores; the chunk's first N tile writes the rows' scales.
    if constexpr (kActQuant) {
      const int tid = threadIdx.x % 128;
      const int tile = blockIdx.x + i * gridDim.x, nn = tile % tiles_n;
      const int chunk = nn / band_tiles, band = tile / band_tiles;
      const int cend = (chunk + 1) * p.qkc;  // the chunk's columns end here
      const int qchunks = p.sync.chunks;
      float inv_s[2][2];
      // a replaces the products in acc's own registers (as fp32 bits), 64
      // rows at a time: the tile's 128 values a thread are all it holds
      // across the band's wait.
#pragma unroll
      for (int mh = 0; mh < 2; ++mh) {
        float rs[2], keep[2], m[2] = {0.f, 0.f};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = m0 + 64 * mh + 16 * warp + g + 8 * h;
          const bool ok = row < p.M;
          keep[h] = ok && p.pads ? 1.f - __bfloat162float(p.pads[row]) : 1.f;
          rs[h] = ok ? __ldg(p.a_scale + static_cast<size_t>(row) * p.as_ld) : 0.f;
        }
#pragma unroll
        for (int jn = 0; jn < 16; ++jn) {
          const bool in_chunk = n0 + 8 * jn + c2 < cend;  // the pair lies in one chunk
          const float2 cs = *reinterpret_cast<const float2*>(tile_cs + 8 * jn + c2);
          const float2 b =
              bf16x2_to_float2(*reinterpret_cast<const uint32_t*>(tile_bias + 8 * jn + c2));
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int e0 = 4 * jn + 2 * h;
            const float a0 = __fmul_rn(
                activate(__fadd_rn(scaled(acc[mh][e0], rs[h], cs.x), b.x), kAct), keep[h]);
            const float a1 = __fmul_rn(
                activate(__fadd_rn(scaled(acc[mh][e0 + 1], rs[h], cs.y), b.y), kAct), keep[h]);
            acc[mh][e0] = __float_as_int(a0);
            acc[mh][e0 + 1] = __float_as_int(a1);
            if (in_chunk) m[h] = fmaxf(m[h], fmaxf(fabsf(a0), fabsf(a1)));
          }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = m0 + 64 * mh + 16 * warp + g + 8 * h;
          float mm = m[h];
          mm = fmaxf(mm, __shfl_xor_sync(0xffffffffu, mm, 1));
          mm = fmaxf(mm, __shfl_xor_sync(0xffffffffu, mm, 2));
          if (lane % 4 == 0 && row < p.M)
            atomicMax(reinterpret_cast<int*>(p.sync.row_max) +
                          static_cast<size_t>(row) * qchunks + chunk,
                      __float_as_int(mm));
        }
      }
      warpgroup_sync(3 + cw);  // the warpgroup's maxima are in
      if (tid == 0) band_arrive_and_wait(p.sync.band_count + band, band_tiles);
      warpgroup_sync(3 + cw);
#pragma unroll
      for (int mh = 0; mh < 2; ++mh)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = m0 + 64 * mh + 16 * warp + g + 8 * h;
          inv_s[mh][h] = 0.f;
          if (row >= p.M) continue;
          const size_t at = static_cast<size_t>(row) * qchunks + chunk;
          const float s = row_scale(ld_relaxed(p.sync.row_max + at), inv_s[mh][h]);
          if (nn % band_tiles == 0 && lane % 4 == 0) p.code_scale[at] = s;
        }
#pragma unroll
      for (int mh = 0; mh < 2; ++mh) {
#pragma unroll
        for (int jn = 0; jn < 16; ++jn)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            *reinterpret_cast<uint16_t*>(staging + (16 * warp + g + 8 * h) * kPitch + 8 * jn + c2) =
                static_cast<uint16_t>(code2(__int_as_float(acc[mh][4 * jn + 2 * h]),
                                            __int_as_float(acc[mh][4 * jn + 2 * h + 1]),
                                            inv_s[mh][h]));
        warpgroup_sync(3 + cw);  // every pair is staged
        for (int idx = tid; idx < kWgRows * 8; idx += 128) {
          const int r = idx / 8, u = idx % 8, row = m0 + 64 * mh + r, col = n0 + 16 * u;
          if (row < p.M && col < cend)
            *reinterpret_cast<uint4*>(static_cast<int8_t*>(p.out) +
                                      static_cast<size_t>(row) * p.ldo + col) =
                *reinterpret_cast<const uint4*>(staging + r * kPitch + 16 * u);
        }
        warpgroup_sync(3 + cw);  // the staging is free for the next rows
      }
      continue;
    }

    // The epilogue, 64 rows at a time: each thread's bf16 pairs go to the
    // warpgroup's staging (with the residual read from there), then the
    // warpgroup writes the 64 rows out in 16-byte stores, whole rows at a
    // time (stored from the accumulator layout, each warp store would touch
    // eight rows).  kI8Act's fp32, the int32 sums and a running fp32 sum go
    // out directly.
#pragma unroll
    for (int mh = 0; mh < MH; ++mh) {
      int rows[2];
      float rs[2], keep[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        rows[h] = m0 + 64 * mh + 16 * warp + g + 8 * h;
        const bool ok = rows[h] < p.M;
        if constexpr (kQuant && !kSum)
          rs[h] = row_scales[64 * mh + 16 * warp + g + 8 * h];
        else
          rs[h] = !kSum && ok && !raw ? __ldg(p.a_scale + static_cast<size_t>(rows[h]) * p.as_ld)
                                      : 0.f;
        keep[h] = ok && p.pads ? 1.f - __bfloat162float(p.pads[rows[h]]) : 1.f;
      }
      if (with_res) {
        if (mh > 0) fetch_residual(m0 + 64 * mh);
        cp_async_wait<0>();
        warpgroup_sync(3 + cw);
      }
      // Column pairs outer and rows inner: a pair's column scales and bias
      // are read from shared memory and unpacked once for both rows.
#pragma unroll
      for (int jn = 0; jn < 16; ++jn) {
        const int col = n0 + 8 * jn + c2;
        if (col >= p.N) continue;
        const float2 cs = *reinterpret_cast<const float2*>(tile_cs + 8 * jn + c2);
        const float2 bias =
            bf16x2_to_float2(*reinterpret_cast<const uint32_t*>(tile_bias + 8 * jn + c2));
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (rows[h] >= p.M) continue;
          const int e0 = 4 * jn + 2 * h;
          if constexpr (raw) {
            *reinterpret_cast<int2*>(static_cast<int*>(p.out) +
                                     static_cast<size_t>(rows[h]) * p.ldo + col) =
                make_int2(acc[mh][e0], acc[mh][e0 + 1]);
          } else {
            float v0, v1;
            if constexpr (kSum) {
              v0 = sum[e0];
              v1 = sum[e0 + 1];
            } else {
              v0 = scaled(acc[mh][e0], rs[h], cs.x);
              v1 = scaled(acc[mh][e0 + 1], rs[h], cs.y);
            }
            finish2<kEpi, kAct>(p, rows[h], col, v0, v1, keep[h], bias,
                                staging + (16 * warp + g + 8 * h) * kPitch + (8 * jn + c2) * kOB);
          }
        }
      }
      if constexpr (kOB > 0) {
        warpgroup_sync(3 + cw);  // every pair is staged
        if (kEpi != kI8Out || !p.acc_out) {
          constexpr int kUnits = BN * kOB / 16;  // 16-byte units of a staged row
          for (int idx = threadIdx.x % 128; idx < kWgRows * kUnits; idx += 128) {
            const int r = idx / kUnits, u = idx % kUnits;
            const int row = m0 + 64 * mh + r, col = n0 + 16 / kOB * u;
            if (row < p.M && col < p.N)
              *reinterpret_cast<uint4*>(static_cast<unsigned char*>(p.out) +
                                        (static_cast<size_t>(row) * p.ldo + col) * kOB) =
                  *reinterpret_cast<const uint4*>(staging + r * kPitch + 16 * u);
          }
        }
        warpgroup_sync(3 + cw);  // the staging is free for the next rows
      }
    }
  }
}

I8Epi epi(const float* a_scale, int as_ld, const float* b_scale, int M, int N, int K,
          int epilogue) {
  I8Epi p{};
  p.a_scale = a_scale;
  p.as_ld = as_ld;
  p.b_scale = b_scale;
  p.M = M;
  p.N = N;
  p.K = K;
  p.ldo = N;
  p.epilogue = epilogue;
  p.chunks = 1;
  p.kc = K;
  return p;
}

// kI8ActQuant's tiles wait for their bands' other tiles, so its launch is
// cooperative: it fails, where it would otherwise hang, unless every block
// is resident at once.
template <int kEpi, int kAct, int kMode>
cudaError_t launch_i8(const CUtensorMap& map_a, const CUtensorMap& map_b, const I8Epi& p,
                      int grid, int smem, cudaStream_t stream) {
  cudaError_t err = set_max_dynamic_smem<gemm_i8_kernel<kEpi, kAct, kMode>>(kSmemMax);
  if (err != cudaSuccess) return err;
  if constexpr (kEpi == kI8ActQuant) {
    cudaLaunchAttribute cooperative[1];
    cooperative[0].id = cudaLaunchAttributeCooperative;
    cooperative[0].val.cooperative = 1;
    cudaLaunchConfig_t config = {};
    config.gridDim = dim3(grid);
    config.blockDim = dim3(kThreads);
    config.dynamicSmemBytes = smem;
    config.stream = stream;
    config.attrs = cooperative;
    config.numAttrs = 1;
    err = cudaLaunchKernelEx(&config, gemm_i8_kernel<kEpi, kAct, kMode>, map_a, map_b, p);
    if (err != cudaSuccess) return err;
  } else {
    gemm_i8_kernel<kEpi, kAct, kMode><<<grid, kThreads, smem, stream>>>(map_a, map_b, p);
  }
  return cudaGetLastError();
}

// A launch of mode `mode`: its grid, the quantizing modes' N-groups, the
// ring's depth (as many stages as fit) and the shared memory.  The
// quantizing modes' grid is the row blocks times as many N-groups as fill
// the SMs with them, at most one per N tile, none empty; the TMA modes'
// persistent blocks take every gridDim.x-th tile.
struct LaunchShape {
  long grid;
  int groups, stages, smem;
};
LaunchShape launch_shape(int mode, const I8Epi& p, int ktc, int tiles_n) {
  LaunchShape l{};
  if (quantizes(mode)) {
    const long row_blocks = (p.M + block_rows(mode) - 1) / block_rows(mode);
    const int groups = static_cast<int>(
        std::max(1L, std::min<long>(tiles_n, sm_count() / row_blocks)));
    const int per_group = (tiles_n + groups - 1) / groups;
    l.groups = (tiles_n + per_group - 1) / per_group;
    l.grid = row_blocks * l.groups;
  } else {
    l.groups = 1;
    const long tiles = static_cast<long>((p.M + tile_rows(mode) - 1) / tile_rows(mode)) * tiles_n;
    l.grid = std::min<long>(tiles, sm_count());
  }
  const int group_tiles = (tiles_n + l.groups - 1) / l.groups;
  const int ln_cols = quantizes(mode) && p.ln_scale ? p.K : 0;
  auto bytes = [&](int stages) {
    return smem_layout(mode, p.epilogue, stages, p.chunks, ktc, group_tiles, ln_cols).total;
  };
  for (l.stages = quantizes(mode) ? kMaxStagesB : kMaxStages;
       l.stages > 2 && bytes(l.stages) > kSmemMax;)
    --l.stages;
  l.smem = bytes(l.stages);
  return l;
}

// kI8ActQuant's tiles of one band (128 rows by one output chunk).
inline int act_quant_band_tiles(const I8Epi& p) { return (p.qkc + BN - 1) / BN; }

// out = epilogue(A [M, K] @ b [N, K]^T (row pitch ldb)), K cut into
// p.chunks chunks of p.kc.  A is quantized in the kernel from p.x when it
// is set (kQuantA; kQuantAWide where p.wide asks for it, K is one chunk,
// the 128-row blocks take one N-group and their codes fit beside
// kMinStagesWide stages: a shape rule), else it is the codes a (row pitch
// lda), read by TMA (kTmaA for one chunk, kTmaASum for more).
// kI8ActQuant (kTmaA, one K-chunk) needs two shape rules for its band
// meeting not to deadlock: every block resident at once (the cooperative
// launch) and 2 G > T, G the grid and T a band's tiles.  A block whose
// oldest unfinished tile is t0 (global tile indices) raises the counters
// of t0 and of t0 + G: t0 + G multiplies as soon as t0 has (its stages
// and its turn follow t0's, and its warpgroup's previous tile t0 - G is
// done).  Take the lowest band not yet met, tiles [bT, (b+1)T): every
// block's t0 lies in it or later, so every tile of the band lies below
// its block's t0 + 2G (bT + 2G > (b+1)T - 1) and has raised its counter,
// and the band is met.
cudaError_t gemm(I8Epi p, const int8_t* a, int lda, const int8_t* b, int ldb,
                 cudaStream_t stream) {
  const int ktc = (p.kc + BK - 1) / BK;
  int mode = p.x ? kQuantA : p.chunks > 1 ? kTmaASum : kTmaA;
  const bool act_quant = p.epilogue == kI8ActQuant;
  if (p.M <= 0 || p.N <= 0 || p.chunks < 1 || p.kc <= 0 || p.kc % 16 ||
      p.K != p.chunks * p.kc || p.N % 8 || ldb % 16 || ldb < p.K || !aligned16(b) ||
      (p.epilogue != kI8Raw && !aligned16(p.out)) || (p.resid && !aligned16(p.resid)) ||
      (act_quant && (mode != kTmaA || !p.sync.row_max || !p.code_scale || p.sync.chunks < 1 ||
                     p.sync.chunks > 32 || p.qkc % 16 || p.qkc * p.sync.chunks != p.N ||
                     p.ldo % 16)))
    return cudaErrorInvalidValue;
  if (p.x ? p.ldx % 8 || p.ldx < p.K || !aligned16(p.x) || row_chunks(p.kc) > kPrologueChunks ||
                (p.ln_scale &&
                 (p.chunks != 1 || !aligned16(p.ln_scale) || !aligned16(p.ln_bias)))
          : lda % 16 || lda < p.K || !aligned16(a))
    return cudaErrorInvalidValue;
  const int tiles_n =
      act_quant ? p.sync.chunks * act_quant_band_tiles(p) : (p.N + BN - 1) / BN;
  LaunchShape l = launch_shape(mode, p, ktc, tiles_n);
  if (act_quant && 2 * l.grid <= act_quant_band_tiles(p)) return cudaErrorInvalidValue;
  if (p.x && p.wide && p.chunks == 1) {
    const LaunchShape w = launch_shape(kQuantAWide, p, ktc, tiles_n);
    if (w.groups == 1 && w.stages >= kMinStagesWide && w.smem <= kSmemMax) {
      mode = kQuantAWide;
      l = w;
    }
  }
  if (l.smem > kSmemMax) return cudaErrorInvalidValue;
  p.groups = l.groups;
  p.stages = l.stages;
  const int smem = l.smem;
  CUtensorMap map_a{}, map_b;
  constexpr auto kU8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  if (!tensor_map3(&map_b, kU8, b, p.kc, p.chunks, p.N, p.kc, ldb, BK, BN) ||
      (!quantizes(mode) &&
       !tensor_map3(&map_a, kU8, a, p.kc, p.chunks, p.M, p.kc, lda, BK, tile_rows(mode))))
    return cudaErrorInvalidValue;
  const int g = static_cast<int>(l.grid);
#define VP_LAUNCH(epi, act, m) return launch_i8<epi, act, m>(map_a, map_b, p, g, smem, stream)
  switch (mode) {
    case kTmaA:
      switch (p.epilogue) {
        case kI8Proj: VP_LAUNCH(kI8Proj, kActNone, kTmaA);
        case kI8Act:
          if (p.activation == kActGelu) VP_LAUNCH(kI8Act, kActGelu, kTmaA);
          if (p.activation == kActRelu) VP_LAUNCH(kI8Act, kActRelu, kTmaA);
          VP_LAUNCH(kI8Act, kActNone, kTmaA);
        case kI8Out: VP_LAUNCH(kI8Out, kActNone, kTmaA);
        case kI8Raw: VP_LAUNCH(kI8Raw, kActNone, kTmaA);
        case kI8ActQuant:
          if (p.activation == kActGelu) VP_LAUNCH(kI8ActQuant, kActGelu, kTmaA);
          if (p.activation == kActRelu) VP_LAUNCH(kI8ActQuant, kActRelu, kTmaA);
          return cudaErrorInvalidValue;
        default: return cudaErrorInvalidValue;
      }
    case kTmaASum:
      if (p.epilogue == kI8Out && !p.acc_in && !p.acc_out) VP_LAUNCH(kI8Out, kActNone, kTmaASum);
      return cudaErrorInvalidValue;
    case kQuantA:
      if (p.acc_in || p.acc_out) return cudaErrorInvalidValue;
      switch (p.epilogue) {
        case kI8Proj: VP_LAUNCH(kI8Proj, kActNone, kQuantA);
        case kI8Act:
          if (p.activation == kActGelu) VP_LAUNCH(kI8Act, kActGelu, kQuantA);
          if (p.activation == kActRelu) VP_LAUNCH(kI8Act, kActRelu, kQuantA);
          return cudaErrorInvalidValue;
        case kI8Out: VP_LAUNCH(kI8Out, kActNone, kQuantA);
        default: return cudaErrorInvalidValue;
      }
    case kQuantAWide:  // K12a's q|k|v only
      if (p.epilogue == kI8Proj && !p.acc_in && !p.acc_out)
        VP_LAUNCH(kI8Proj, kActNone, kQuantAWide);
      return cudaErrorInvalidValue;
  }
  return cudaErrorInvalidValue;
#undef VP_LAUNCH
}

// The first product of a block, its A the LN of x [rows, d] quantized: in
// the product's prologue (p.x; K11, whose six launches are the point, and
// K12a's one, in 128-row blocks where they pay), or, where the caller
// gives scratch h8 [rows, d] / hs [rows], by quant_rows_kernel into h8 /
// hs, read by TMA (K10's chain, and K9's by quantized_hidden): the
// standalone quantizer spreads the rows over every SM, where a block's
// prologue quantizes its 64 rows on one SM, again in every N-group, while
// its tensor cores wait.
cudaError_t first_product(I8Epi p, const bf16* x, const bf16* ln_s, const bf16* ln_b, float eps,
                          int8_t* h8, float* hs, const int8_t* w, cudaStream_t st) {
  const int d = p.K;
  if (h8) {
    cudaError_t err = quant(x, d, ln_s, ln_b, eps, h8, d, hs, p.M, d, 1, st);
    if (err != cudaSuccess) return err;
    p.a_scale = hs;
    p.as_ld = 1;
    return gemm(p, h8, d, w, d, st);
  }
  p.x = x;
  p.ldx = d;
  p.ln_scale = ln_s;
  p.ln_bias = ln_b;
  p.eps = eps;
  return gemm(p, nullptr, 0, w, d, st);
}

// LN + quantize x [rows, d] (first_product), then q | k | v into qkv [rows,
// 3 nh] in bf16 by one product over the fused K-major weights wqkv [3 nh,
// d], q times query_scale (K12a, and the front of K10 and K11).  wide: the
// prologue's 128-row blocks where they pay (K12a; K11 keeps 64 rows).
cudaError_t qkv_projection(const bf16* x, const bf16* ln_s, const bf16* ln_b,
                           const int8_t* wqkv, const float* sqkv, const bf16* bqkv, bf16* qkv,
                           int8_t* h8, float* hs, int rows, int d, int nh, float eps,
                           float query_scale, bool wide, cudaStream_t st) {
  I8Epi p = epi(nullptr, 0, sqkv, rows, 3 * nh, d, kI8Proj);
  p.wide = wide;
  p.bias = bqkv;
  p.out = qkv;
  p.col_mul = query_scale;
  p.scaled_cols = nh;
  return first_product(p, x, ln_s, ln_b, eps, h8, hs, wqkv, st);
}

// out = cast(((sum_c quant_rows(x_c) @ w_c) + bias) [* keep] + resid) in one
// launch: x [rows, chunks * kc] bf16 quantized per chunk in the prologue,
// w K-major [d, chunks * kc] (K12b; K11's output projection).
cudaError_t quantized_out(const bf16* x, int chunks, int kc, const int8_t* w, const float* ws,
                          const bf16* bias, const bf16* pads, const bf16* resid, bf16* out,
                          int rows, int d, cudaStream_t st) {
  I8Epi p = epi(nullptr, 0, ws, rows, d, chunks * kc, kI8Out);
  p.chunks = chunks;
  p.kc = kc;
  p.x = x;
  p.ldx = chunks * kc;
  p.bias = bias;
  p.pads = pads;
  p.resid = resid;
  p.out = out;
  return gemm(p, nullptr, 0, w, chunks * kc, st);
}

// K11's W1: a = act(LN(x) quantized in the prologue @ W1 + b1) * keep in
// fp32 [rows, f] (first_product; W1 K-major [f, d]).
cudaError_t hidden_activation(const bf16* x, const bf16* pads, const bf16* ln_s,
                              const bf16* ln_b, const int8_t* w1, const float* s1,
                              const bf16* b1, float* a, int rows, int d, int f, int activation,
                              float eps, cudaStream_t st) {
  I8Epi p = epi(nullptr, 0, s1, rows, f, d, kI8Act);
  p.bias = b1;
  p.pads = pads;
  p.out = a;
  p.activation = activation;
  return first_product(p, x, ln_s, ln_b, eps, nullptr, nullptr, w1, st);
}

// K9's W1: the LN'd x quantized into h8 / hs by quant_rows_kernel, which
// also zeroes the band meeting (sync, band_sync's layout), then a =
// act(h8 @ W1 + b1) * keep quantized per F-chunk in the product's epilogue
// (kI8ActQuant) -> a8 [rows, f], as [rows, chunks]: the fp32 a never
// leaves the chip.
cudaError_t quantized_hidden(const bf16* x, const bf16* pads, const bf16* ln_s,
                             const bf16* ln_b, const int8_t* w1, const float* s1,
                             const bf16* b1, int8_t* h8, float* hs, void* sync, int8_t* a8,
                             float* as, int rows, int d, int f, int chunks, int activation,
                             float eps, cudaStream_t st) {
  if (chunks < 1 || f % chunks) return cudaErrorInvalidValue;
  const BandSync meet = band_sync(sync, rows, chunks);
  cudaError_t err = quant(x, d, ln_s, ln_b, eps, h8, d, hs, rows, d, 1, st, meet);
  if (err != cudaSuccess) return err;
  I8Epi p = epi(hs, 1, s1, rows, f, d, kI8ActQuant);
  p.bias = b1;
  p.pads = pads;
  p.out = a8;
  p.activation = activation;
  p.code_scale = as;
  p.sync = meet;
  p.qkc = f / chunks;
  return gemm(p, h8, d, w1, d, st);
}

// The last product over `chunks` K-slices of a8 [rows, chunks * kc] (row
// scales as [rows, chunks]) and the K-major w [d, chunks * kc] (column
// scales ws):
//   sum:   out = cast(((sum_c (a_c @ w_c)) + bias) * keep + x), the sum in
//          fp32 on chip, one launch (K11);
//   chain: out_c = cast(((a_c @ w_c) [+ bias]) [* keep] + resid_c), bias in
//          chunk 0, resid_0 = x, resid_c = out_{c-1} (K9, K10); the chunks
//          alternate between tmp and out so that the last lands in out
//          (tmp may be null for one chunk).
cudaError_t last_product(const int8_t* a8, const float* as, int chunks, int kc, const int8_t* w,
                         const float* ws, const bf16* bias, const bf16* pads, const bf16* x,
                         bf16* tmp, bf16* out, int rows, int d, bool sum, cudaStream_t st) {
  if (sum) {
    I8Epi p = epi(as, chunks, ws, rows, d, chunks * kc, kI8Out);
    p.chunks = chunks;
    p.kc = kc;
    p.bias = bias;
    p.pads = pads;
    p.resid = x;
    p.out = out;
    return gemm(p, a8, chunks * kc, w, chunks * kc, st);
  }
  const bf16* resid = x;
  for (int c = 0; c < chunks; ++c) {
    I8Epi p = epi(as + c, chunks, ws, rows, d, kc, kI8Out);
    bf16* dst = (chunks - 1 - c) % 2 == 0 ? out : tmp;
    p.bias = c == 0 ? bias : nullptr;
    p.pads = pads;
    p.resid = resid;
    p.out = dst;
    resid = dst;
    const size_t k0 = static_cast<size_t>(c) * kc;
    cudaError_t err = gemm(p, a8 + k0, chunks * kc, w + k0, chunks * kc, st);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// K11's FFN half from x: a = act(LN(x) @ W1 + b1) * keep in fp32 over all
// F columns, a quantized per F-chunk, the output product summed on chip
// (W2 K-major [d, f]; see last_product).
cudaError_t ffn_half(const bf16* x, const bf16* pads, const bf16* ln_s, const bf16* ln_b,
                     const int8_t* w1, const float* s1, const bf16* b1, const int8_t* w2,
                     const float* s2, const bf16* b2, float* a, int8_t* a8, float* as, bf16* out,
                     int rows, int d, int f, int chunks, int activation, float eps,
                     cudaStream_t st) {
  cudaError_t err =
      hidden_activation(x, pads, ln_s, ln_b, w1, s1, b1, a, rows, d, f, activation, eps, st);
  if (err == cudaSuccess)
    err = quant(a, f, nullptr, nullptr, 0.f, a8, f, as, rows, f / chunks, chunks, st);
  if (err == cudaSuccess)
    err = last_product(a8, as, chunks, f / chunks, w2, s2, b2, pads, x, nullptr, out, rows, d,
                       true, st);
  return err;
}

// K11's scratch, carved from one buffer: qkv [rows, 3 nh] and ctx [rows, nh]
// bf16, x1 [rows, d] bf16, a [rows, f] fp32, a8 [rows, f] int8, as [rows,
// ffn_chunks] fp32, each 256-byte aligned.
struct LayerScratch {
  bf16* qkv;
  bf16* ctx;
  bf16* x1;
  float* a;
  int8_t* a8;
  float* as;
  size_t bytes;
};
LayerScratch layer_scratch(void* base, int rows, int d, int nh, int f, int ffn_chunks) {
  LayerScratch s{};
  auto take = [&](size_t bytes) {
    void* at = static_cast<char*>(base) + s.bytes;
    s.bytes += (bytes + 255) / 256 * 256;
    return at;
  };
  const size_t r = static_cast<size_t>(rows);
  s.qkv = static_cast<bf16*>(take(r * 3 * nh * 2));
  s.ctx = static_cast<bf16*>(take(r * nh * 2));
  s.x1 = static_cast<bf16*>(take(r * d * 2));
  s.a = static_cast<float*>(take(r * f * 4));
  s.a8 = static_cast<int8_t*>(take(r * f));
  s.as = static_cast<float*>(take(r * ffn_chunks * 4));
  return s;
}

}  // namespace
}  // namespace vp

extern "C" {

using vp::bf16;
#define VP_B(p) static_cast<const bf16*>(p)
#define VP_F(p) static_cast<const float*>(p)
#define VP_I8(p) static_cast<const int8_t*>(p)

// Weights are K-major throughout (see the top of this file).

// K9: x [rows, d] bf16 -> out; chunks F-slices chained with a cast after
// each; w1 [f, d], w2 [d, f].  Three device kernels and one per F-slice:
// the LN'd quantizer, W1 quantizing its hidden activation per F-chunk in
// its epilogue (quantized_hidden), W2 per slice (last_product's chain).
// Scratch: h8 [rows, d] i8, hs [rows] f32, sync (band_sync's layout), a8
// [rows, f] i8, as [rows, chunks] f32, tmp [rows, d] bf16 (chunks > 1).
int vp_int8_ffn_block(const void* x, const void* pads, const void* ln_s, const void* ln_b,
                      const void* w1, const void* s1, const void* b1, const void* w2,
                      const void* s2, const void* b2, void* h8, void* hs, void* sync, void* a8,
                      void* as, void* tmp, void* out, int rows, int d, int f, int chunks,
                      int activation, float eps, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto* a8p = static_cast<int8_t*>(a8);
  auto* asp = static_cast<float*>(as);
  cudaError_t err = vp::quantized_hidden(VP_B(x), VP_B(pads), VP_B(ln_s), VP_B(ln_b), VP_I8(w1),
                                         VP_F(s1), VP_B(b1), static_cast<int8_t*>(h8),
                                         static_cast<float*>(hs), sync, a8p, asp, rows, d, f,
                                         chunks, activation, eps, st);
  if (err == cudaSuccess)
    err = vp::last_product(a8p, asp, chunks, f / chunks, VP_I8(w2), VP_F(s2), VP_B(b2),
                           VP_B(pads), VP_B(x), static_cast<bf16*>(tmp), static_cast<bf16*>(out),
                           rows, d, false, st);
  return err;
}

// K10: x [batch, t, d] -> out; chunks head groups chained with a cast
// after each; wqkv [3 nh, d] (sqkv, bqkv [3 nh]), wo [d, nh].  Scratch: h8
// [rows, d] i8, hs [rows] f32 (see first_product), qkv [rows, 3 nh] bf16,
// ctx [rows, nh] bf16, c8 [rows, nh] i8, cs [rows, chunks] f32, tmp.
int vp_int8_attention_block(const void* x, const void* mask, const void* ln_s, const void* ln_b,
                            const void* wqkv, const void* sqkv, const void* bqkv, const void* wo,
                            const void* so, const void* bo, void* h8, void* hs, void* qkv,
                            void* ctx, void* c8, void* cs, void* tmp, void* out, int batch,
                            int t, int d, int heads,
                            int hd, int mask_b, int mask_t, int chunks, float cap, float eps,
                            float query_scale, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  const int rows = batch * t, nh = heads * hd, gh = nh / chunks;
  auto* qkvp = static_cast<bf16*>(qkv);
  auto* ctxp = static_cast<bf16*>(ctx);
  auto* c8p = static_cast<int8_t*>(c8);
  auto* csp = static_cast<float*>(cs);
  cudaError_t err = vp::qkv_projection(VP_B(x), VP_B(ln_s), VP_B(ln_b), VP_I8(wqkv), VP_F(sqkv),
                                       VP_B(bqkv), qkvp, static_cast<int8_t*>(h8),
                                       static_cast<float*>(hs), rows, d, nh, eps, query_scale,
                                       false, st);
  if (err == cudaSuccess)
    err = vp::launch_capped_attention(qkvp, VP_F(mask), ctxp, batch, t, heads, hd, mask_b,
                                      mask_t, cap, st);
  if (err == cudaSuccess)
    err = vp::quant(static_cast<const bf16*>(ctxp), nh, nullptr, nullptr, 0.f, c8p, nh, csp,
                    rows, gh, chunks, st);
  if (err == cudaSuccess)
    err = vp::last_product(c8p, csp, chunks, gh, VP_I8(wo), VP_F(so), VP_B(bo), nullptr, VP_B(x),
                           static_cast<bf16*>(tmp), static_cast<bf16*>(out), rows, d, false, st);
  return err;
}

// K11's scratch bytes (one buffer, carved by vp_int8_layer_block).
size_t vp_int8_layer_scratch(int rows, int d, int nh, int f, int ffn_chunks) {
  return vp::layer_scratch(nullptr, rows, d, nh, f, ffn_chunks).bytes;
}

// K11: a whole pre-norm layer, x [batch, t, d] -> out, in six launches: q|k|v
// (LN1 and the quantizer in the prologue), K1's core, the output
// projection (ctx quantized per head group in the prologue, the groups
// summed on chip, + bo + x -> x1), W1 (LN2 and the quantizer in the
// prologue -> a fp32), the quantizer of a per F-chunk, W2 (the F-chunks
// summed on chip, + b2, * keep, + x1 -> out).  scratch holds
// vp_int8_layer_scratch bytes.
int vp_int8_layer_block(const void* x, const void* mask, const void* pads, const void* ln1_s,
                        const void* ln1_b, const void* wqkv, const void* sqkv, const void* bqkv,
                        const void* wo, const void* so, const void* bo, const void* ln2_s,
                        const void* ln2_b, const void* w1, const void* s1, const void* b1,
                        const void* w2, const void* s2, const void* b2, void* scratch, void* out,
                        int batch, int t, int d, int heads, int hd, int f, int mask_b, int mask_t,
                        int head_chunks, int ffn_chunks, int activation, float cap, float eps,
                        float query_scale, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  const int rows = batch * t, nh = heads * hd;
  const vp::LayerScratch s = vp::layer_scratch(scratch, rows, d, nh, f, ffn_chunks);
  cudaError_t err = vp::qkv_projection(VP_B(x), VP_B(ln1_s), VP_B(ln1_b), VP_I8(wqkv),
                                       VP_F(sqkv), VP_B(bqkv), s.qkv, nullptr, nullptr, rows, d,
                                       nh, eps, query_scale, false, st);
  if (err == cudaSuccess)
    err = vp::launch_capped_attention(s.qkv, VP_F(mask), s.ctx, batch, t, heads, hd, mask_b,
                                      mask_t, cap, st);
  if (err == cudaSuccess)
    err = vp::quantized_out(s.ctx, head_chunks, nh / head_chunks, VP_I8(wo), VP_F(so), VP_B(bo),
                            nullptr, VP_B(x), s.x1, rows, d, st);
  if (err == cudaSuccess)
    err = vp::ffn_half(s.x1, VP_B(pads), VP_B(ln2_s), VP_B(ln2_b), VP_I8(w1), VP_F(s1),
                       VP_B(b1), VP_I8(w2), VP_F(s2), VP_B(b2), s.a, s.a8, s.as,
                       static_cast<bf16*>(out), rows, d, f, ffn_chunks, activation, eps, st);
  return err;
}

// K12a: x [rows, d] -> q | k | v in the column blocks of qkv [rows, 3 nh],
// one launch over wqkv [3 nh, d], in 128-row blocks where they pay.
int vp_int8_qkv_projection(const void* x, const void* ln_s, const void* ln_b, const void* wqkv,
                           const void* sqkv, const void* bqkv, void* qkv, int rows, int d, int nh,
                           float eps, float query_scale, void* stream) {
  return vp::qkv_projection(VP_B(x), VP_B(ln_s), VP_B(ln_b), VP_I8(wqkv), VP_F(sqkv),
                            VP_B(bqkv), static_cast<bf16*>(qkv), nullptr, nullptr, rows, d, nh,
                            eps, query_scale, true, static_cast<cudaStream_t>(stream));
}

// K12b: ctx [rows, nh] -> cast(quant_rows(ctx) @ Wo + bo + resid) [rows,
// d]; wo [d, nh]; one launch.
int vp_int8_out_projection(const void* ctx, const void* resid, const void* wo, const void* so,
                           const void* bo, void* out, int rows, int nh, int d, void* stream) {
  return vp::quantized_out(VP_B(ctx), 1, nh, VP_I8(wo), VP_F(so), VP_B(bo), nullptr,
                           VP_B(resid), static_cast<bf16*>(out), rows, d,
                           static_cast<cudaStream_t>(stream));
}

// The int8 GEMM alone, for measurement and for composing the blocks from
// their primitives (chip_smoke.py [gemm-i8], [kernels]): out [m, n] =
// epilogue(a [m, k] @ b [n, k]^T) with row scales a_scale [m] and column
// scales b_scale [n], A's codes by TMA; epilogue 0 (q|k|v: + bias, x
// col_mul on the first scaled_cols columns, bf16), 1 (act(+ bias) x keep,
// fp32), 2 (acc_in + v, to acc_out, or then (+ bias) x keep + resid, bf16)
// or 3 (the int32 sums).
int vp_gemm_i8(const void* a, const void* b, const void* a_scale, const void* b_scale,
               const void* bias, const void* pads, const void* resid, const void* acc_in,
               void* acc_out, void* out, int m, int n, int k, int epilogue, int activation,
               float col_mul, int scaled_cols, void* stream) {
  if (epilogue < vp::kI8Proj || epilogue > vp::kI8Raw) return cudaErrorInvalidValue;
  vp::I8Epi p = vp::epi(VP_F(a_scale), 1, VP_F(b_scale), m, n, k, epilogue);
  p.bias = VP_B(bias);
  p.pads = VP_B(pads);
  p.resid = VP_B(resid);
  p.acc_in = VP_F(acc_in);
  p.acc_out = static_cast<float*>(acc_out);
  p.out = out;
  p.activation = activation;
  p.col_mul = col_mul;
  p.scaled_cols = scaled_cols;
  return vp::gemm(p, VP_I8(a), k, VP_I8(b), k, static_cast<cudaStream_t>(stream));
}

// K9's W1 alone (kI8ActQuant), for measurement and for holding its codes
// and scales against kI8Act's fp32 output quantized by
// quant_rows_f32_kernel (chip_smoke.py [gemm-i8]): a [m, k] and b [n, k]
// int8 with row scales a_scale [m] and column scales b_scale [n] ->
// codes [m, n] int8 and scales [m, chunks] of act(v + bias) * keep, each
// row quantized over each of `chunks` column chunks; sync is band_sync's
// buffer for m rows, zeroed.
int vp_gemm_i8_act_quant(const void* a, const void* b, const void* a_scale, const void* b_scale,
                         const void* bias, const void* pads, void* codes, void* scales,
                         void* sync, int m, int n, int k, int chunks, int activation,
                         void* stream) {
  if (chunks < 1 || n % chunks) return cudaErrorInvalidValue;
  vp::I8Epi p = vp::epi(VP_F(a_scale), 1, VP_F(b_scale), m, n, k, vp::kI8ActQuant);
  p.bias = VP_B(bias);
  p.pads = VP_B(pads);
  p.out = codes;
  p.activation = activation;
  p.code_scale = static_cast<float*>(scales);
  p.sync = vp::band_sync(sync, m, chunks);
  p.qkc = n / chunks;
  return vp::gemm(p, VP_I8(a), k, VP_I8(b), k, static_cast<cudaStream_t>(stream));
}

// The standalone quantizer, for composing the blocks from their primitives:
// x [rows, chunks * cols] (bf16, or fp32 when fp32 != 0) -> q int8 and
// scale [rows, chunks], with the fp32 LN in front when ln_s is not null.
int vp_quant_rows(const void* x, const void* ln_s, const void* ln_b, void* q, void* scale,
                  int rows, int cols, int chunks, int fp32, float eps, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  const int width = cols * chunks;
  if (fp32)
    return vp::quant(VP_F(x), width, VP_B(ln_s), VP_B(ln_b), eps, static_cast<int8_t*>(q), width,
                     static_cast<float*>(scale), rows, cols, chunks, st);
  return vp::quant(VP_B(x), width, VP_B(ln_s), VP_B(ln_b), eps, static_cast<int8_t*>(q), width,
                   static_cast<float*>(scale), rows, cols, chunks, st);
}

// K1's attention core alone over qkv [batch * t, 3 heads hd] -> ctx [batch
// * t, heads hd], for composing K10 and K11 from their primitives.
int vp_capped_attention(const void* qkv, const void* mask, void* ctx, int batch, int t,
                        int heads, int hd, int mask_b, int mask_t, float cap, void* stream) {
  return vp::launch_capped_attention(VP_B(qkv), VP_F(mask), static_cast<bf16*>(ctx), batch, t,
                                     heads, hd, mask_b, mask_t, cap,
                                     static_cast<cudaStream_t>(stream));
}

// Host cost of the GEMM launcher's parts, for chip_smoke.py [host]: n
// tensor-map encodes (what = 0, a [768, 768] int8 map at buf) or n
// cudaFuncSetAttribute calls (what = 1).
int vp_host_probe(const void* buf, int what, int n, void* stream) {
  (void)stream;
  for (int i = 0; i < n; ++i) {
    if (what == 0) {
      CUtensorMap map;
      if (!vp::tensor_map3(&map, CU_TENSOR_MAP_DATA_TYPE_UINT8, buf, 768, 1, 768, 768, 768,
                           vp::BK, vp::BN))
        return cudaErrorInvalidValue;
    } else {
      cudaError_t err = cudaFuncSetAttribute(
          vp::gemm_i8_kernel<vp::kI8Out, vp::kActNone, vp::kTmaA>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, vp::kSmemMax);
      if (err != cudaSuccess) return err;
    }
  }
  return 0;
}

#undef VP_B
#undef VP_F
#undef VP_I8

}  // extern "C"

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
//                      rintf rounds half to even like jnp.round; 1/s is an
//                      IEEE division (the build has no --use_fast_math).
//   gemm_i8_kernel     int8 x int8 -> int32 products with the blocks' fp32
//                      epilogues, in the reference's order:
//                        v = (float(acc) * row_scale) * col_scale, then
//                        kI8Proj  (v + bias) * col_mul on the first
//                                 scaled_cols columns (q's query scale),
//                                 v + bias on the others -> bf16;
//                        kI8Act   act(v + bias) * keep -> fp32;
//                        kI8Out   v [+ running fp32 sum] -> the sum, or
//                                 ((v + bias) * keep) + residual -> bf16
//                                 (bias, keep and residual each optional);
//                        kI8Raw   the int32 sums themselves (measurement).
//
// The blocks (_ffn_int8_chunk_kernel, _attn_int8_chunk_kernel,
// _layer_int8_kernel, _qkv_int8_kernel, _out_int8_kernel):
//   LN1 + quantize x        quant_rows_kernel           -> h8, hs
//   q|k|v                   gemm_i8_kernel kI8Proj, one launch over the
//                           fused [3NH, D] weights  -> qkv bf16 [rows, 3NH]
//   attention               capped_attention_kernel (K1's core) -> ctx bf16
//   quantize ctx per group  quant_rows_kernel           -> c8, cs [rows, chunks]
//   out = ctx @ Wo          gemm_i8_kernel kI8Out per head group
//   LN2 + quantize          quant_rows_kernel           -> h8, hs
//   a = act(h @ W1) * keep  gemm_i8_kernel kI8Act       -> a fp32 [rows, F]
//   quantize a per F-chunk  quant_rows_kernel           -> a8, as [rows, chunks]
//   out = a @ W2            gemm_i8_kernel kI8Out per F-chunk
// Chained blocks (K9, K10) cast the running output to bf16 after every
// chunk, with the bias (and K10's x) in chunk 0 only; the one-kernel layer
// (K11) sums the chunks' products in fp32 (a running sum in device memory)
// and casts once.  The TPU recomputes LN and h8 per chunk and quantizes
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
// Design of the product: gemm_bf16.cu's, in 8 bits.  Persistent blocks, one
// per SM, walk 128 x 128 output tiles 128 bytes (128 int8) deep per stage;
// one producer warp keeps TMA loads of the A tile ([128 rows, 128] of the
// activation codes) and the B tile ([128 rows, 128] of the K-major weights)
// in flight through a six-stage mbarrier ring with 128-byte swizzle; two
// consumer warpgroups take the block's tiles in turn (ping-pong), each
// multiplying a whole tile with wgmma.mma_async m64n128k32 .s32.s8.s8 into
// exact int32 registers, so one runs its epilogue while the other
// multiplies.  The epilogue runs on the accumulator registers, in the fp32
// order above, so the products' values are those of any exact int8 GEMM.
// TMA zero-fills the ragged M, N and K edges (a chunk's K-slice ends at
// its width), so the loop masks nothing; K, every row pitch and the
// operands' addresses must be multiples of 16 bytes.
// Design of the quantizer: K6's row kernel (ln_rows.cu).  One warp per
// (row, chunk); a bf16 row of up to 2048 values is held in registers from
// one read in 16-byte loads, and the LN statistics, the absmax and the
// codes (eight per 8-byte store) all come from them.  K9's fp32 hidden
// activation (3072 values per row chunk at base and giant widths) is held
// across a block of 128 threads instead, also from one read in 16-byte
// loads.
#include "tma_wgmma.cuh"

namespace vp {
namespace {

constexpr float kInv127 = static_cast<float>(1.0 / 127.0);

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

__device__ __forceinline__ uint32_t code(float v, float inv_s) {
  return static_cast<uint8_t>(
      static_cast<int8_t>(fminf(fmaxf(rintf(v * inv_s), -127.f), 127.f)));
}

// x [rows, chunks * cols] (row pitch ldx) -> q [rows, chunks * cols] (pitch
// ldq), scale [rows, chunks].  With ln_scale (chunks = 1) the quantized
// value is the fp32 LayerNorm of the row, (x - mean) * rsqrt(var + eps) *
// (scale + 1) + bias.
struct QuantRows {
  const void* x;
  const bf16* ln_scale;
  const bf16* ln_bias;
  int8_t* q;
  float* scale;
  int ldx, ldq, rows, cols, chunks;
  float eps;
};

// bf16 rows held in registers: lane l keeps 16-byte chunks l, l + 32, ..
template <int J>
__global__ void quant_rows_kernel(const __grid_constant__ QuantRows p) {
  const int w = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (w >= p.rows * p.chunks) return;
  const int row = w / p.chunks, c = w % p.chunks;
  const uint4* xr = reinterpret_cast<const uint4*>(
      static_cast<const bf16*>(p.x) + static_cast<size_t>(row) * p.ldx +
      static_cast<size_t>(c) * p.cols);
  int8_t* qr = p.q + static_cast<size_t>(row) * p.ldq + static_cast<size_t>(c) * p.cols;
  const bool ln = p.ln_scale != nullptr;
  const int n8 = p.cols / 8;
  uint4 xv[J], sv[J], bv[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int i = lane + 32 * j;
    if (i < n8) {
      xv[j] = __ldg(xr + i);
      if (ln) {
        sv[j] = __ldg(reinterpret_cast<const uint4*>(p.ln_scale) + i);
        bv[j] = __ldg(reinterpret_cast<const uint4*>(p.ln_bias) + i);
      }
    }
  }
  float f[8];
  float mean = 0.f, inv = 0.f;
  if (ln) {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      if (lane + 32 * j < n8) {
        unpack8(xv[j], f);
#pragma unroll
        for (int e = 0; e < 8; ++e) s += f[e];
      }
    }
    mean = warp_sum(s) / p.cols;
    float q2 = 0.f;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      if (lane + 32 * j < n8) {
        unpack8(xv[j], f);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float d = f[e] - mean;
          q2 += d * d;
        }
      }
    }
    inv = rsqrtf(warp_sum(q2) / p.cols + p.eps);
  }
  auto values = [&](int j, float (&v)[8]) {
    unpack8(xv[j], v);
    if (!ln) return;
    float g[8], h[8];
    unpack8(sv[j], g);
    unpack8(bv[j], h);
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = (v[e] - mean) * inv * (g[e] + 1.f) + h[e];
  };
  float m = 0.f;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    if (lane + 32 * j < n8) {
      values(j, f);
#pragma unroll
      for (int e = 0; e < 8; ++e) m = fmaxf(m, fabsf(f[e]));
    }
  }
  m = warp_max(m);
  const float s = fmaxf(m * kInv127, 1e-12f);
  const float inv_s = 1.0f / s;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int i = lane + 32 * j;
    if (i < n8) {
      values(j, f);
      uint2 packed = make_uint2(0u, 0u);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        packed.x |= code(f[e], inv_s) << (8 * e);
        packed.y |= code(f[4 + e], inv_s) << (8 * e);
      }
      reinterpret_cast<uint2*>(qr)[i] = packed;
    }
  }
  if (lane == 0) p.scale[static_cast<size_t>(row) * p.chunks + c] = s;
}

// K9's fp32 hidden activation (up to 4096 values per row chunk, more than
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
  const float s = fmaxf(m * kInv127, 1e-12f);
  const float inv_s = 1.0f / s;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int i = threadIdx.x + kF32Threads * j;
    if (i < n4)
      qr[i] = code(v[j].x, inv_s) | code(v[j].y, inv_s) << 8 | code(v[j].z, inv_s) << 16 |
              code(v[j].w, inv_s) << 24;
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
    for (int i = lane; i < p.cols; i += 32) s += to_f32(xr[i]);
    mean = warp_sum(s) / p.cols;
    float v2 = 0.f;
    for (int i = lane; i < p.cols; i += 32) {
      const float d = to_f32(xr[i]) - mean;
      v2 += d * d;
    }
    inv = rsqrtf(warp_sum(v2) / p.cols + p.eps);
  }
  auto value = [&](int i) {
    const float v = to_f32(xr[i]);
    if (!p.ln_scale) return v;
    return (v - mean) * inv * (__bfloat162float(p.ln_scale[i]) + 1.f) +
           __bfloat162float(p.ln_bias[i]);
  };
  float m = 0.f;
  for (int i = lane; i < p.cols; i += 32) m = fmaxf(m, fabsf(value(i)));
  m = warp_max(m);
  const float s = fmaxf(m * kInv127, 1e-12f);
  const float inv_s = 1.0f / s;
  for (int i = lane; i < p.cols; i += 32) qr[i] = static_cast<int8_t>(code(value(i), inv_s));
  if (lane == 0) p.scale[static_cast<size_t>(row) * p.chunks + c] = s;
}

template <typename T>
cudaError_t quant(const T* x, int ldx, const bf16* ln_scale, const bf16* ln_bias, float eps,
                  int8_t* q, int ldq, float* scale, int rows, int cols, int chunks,
                  cudaStream_t stream) {
  const QuantRows p{x, ln_scale, ln_bias, q, scale, ldx, ldq, rows, cols, chunks, eps};
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

enum I8Epilogue : int { kI8Proj = 0, kI8Act = 1, kI8Out = 2, kI8Raw = 3 };

struct I8Epi {
  const float* a_scale;   // row m's scale at a_scale[m * as_ld]
  const float* b_scale;   // [N]
  const bf16* bias;       // [N] or null
  const bf16* pads;       // [M] (keep = 1 - pad) or null
  const bf16* resid;      // [M, N] or null
  const float* acc_in;    // [M, N] running fp32 sum to add, or null
  float* acc_out;         // [M, N] running fp32 sum to write, or null (kI8Out)
  void* out;              // bf16 (kI8Proj, kI8Out), fp32 (kI8Act) or int32 (kI8Raw), pitch ldo
  int as_ld, ldo, M, N, K, epilogue, activation;
  int scaled_cols;        // kI8Proj: col_mul applies to columns below this
  float col_mul;          // kI8Proj: the query scale
};

constexpr int BM = 128, BN = 128;      // output tile of one consumer warpgroup
constexpr int BK = 128;                // depth per stage: one 128-byte row
constexpr int kThreads = 384;          // producer + 2 consumer warpgroups
constexpr int kTileA = BM * BK;        // bytes: [128, 128] int8
constexpr int kStage = kTileA + BN * BK;
constexpr int kStages = 6;
// 1 KB of slack to align the ring to the swizzle's 1024-byte period, then
// the ring, a full and an empty barrier per stage, and per consumer
// warpgroup its tile's column scales (fp32) and bias (bf16).
constexpr size_t kSmem = 1024 + size_t(kStages) * kStage + 2 * kStages * 8 + 2 * BN * 6;

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

__device__ __forceinline__ float activate(float v, int act) {
  if (act == kActGelu) return 0.5f * v * (1.f + erff(v * 0.7071067811865476f));
  if (act == kActRelu) return fmaxf(v, 0.f);
  return v;
}

__device__ __forceinline__ uint32_t ldg_u32(const bf16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}
__device__ __forceinline__ float2 bf16x2_to_float2(uint32_t w) {
  return __bfloat1622float2(*reinterpret_cast<const bf162*>(&w));
}

// Epilogue kEpi (activation kAct) of two neighbouring elements (row,
// col) and (row, col + 1): their int32 sums, the row's scale and keep, the
// columns' scales and bias pair (from shared memory) and the residual pair
// (packed bf16, loaded ahead).  The epilogue and the activation are
// template constants: the tile's 64 inlined copies then hold one
// epilogue's code, not all of them (the fully unrolled loop's code size,
// not its arithmetic, is what a run-time switch costs).
template <int kEpi, int kAct>
__device__ __forceinline__ void finish2(const I8Epi& p, int row, int col, int acc0, int acc1,
                                        float rs, float keep, float2 cs, uint32_t bias2,
                                        uint32_t res2) {
  float v[2] = {__int2float_rn(acc0) * rs * cs.x, __int2float_rn(acc1) * rs * cs.y};
  const float2 b = bf16x2_to_float2(bias2);
  const float bb[2] = {b.x, b.y};
  if constexpr (kEpi == kI8Proj) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      v[e] = v[e] + bb[e];
      if (col + e < p.scaled_cols) v[e] *= p.col_mul;
    }
    *reinterpret_cast<bf162*>(static_cast<bf16*>(p.out) + static_cast<size_t>(row) * p.ldo +
                              col) = __floats2bfloat162_rn(v[0], v[1]);
    return;
  }
  if constexpr (kEpi == kI8Act) {
#pragma unroll
    for (int e = 0; e < 2; ++e) v[e] = activate(v[e] + bb[e], kAct) * keep;
    *reinterpret_cast<float2*>(static_cast<float*>(p.out) + static_cast<size_t>(row) * p.ldo +
                               col) = make_float2(v[0], v[1]);
    return;
  }
  const size_t off = static_cast<size_t>(row) * p.N + col;
  if (p.acc_in) {
    const float2 r = __ldg(reinterpret_cast<const float2*>(p.acc_in + off));
    v[0] = r.x + v[0];
    v[1] = r.y + v[1];
  }
  if (p.acc_out) {
    *reinterpret_cast<float2*>(p.acc_out + off) = make_float2(v[0], v[1]);
    return;
  }
  const float2 r = bf16x2_to_float2(res2);
  const float rr[2] = {r.x, r.y};
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    if (p.bias) v[e] += bb[e];
    if (p.pads) v[e] *= keep;
    if (p.resid) v[e] += rr[e];
  }
  *reinterpret_cast<bf162*>(static_cast<bf16*>(p.out) + static_cast<size_t>(row) * p.ldo + col) =
      __floats2bfloat162_rn(v[0], v[1]);
}

template <int kEpi, int kAct>
__global__ void __launch_bounds__(kThreads, 1)
    gemm_i8_kernel(const __grid_constant__ CUtensorMap map_a,
                   const __grid_constant__ CUtensorMap map_b,
                   const __grid_constant__ I8Epi p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * kStage);
  uint64_t* empty = full + kStages;
  float* stage_cs = reinterpret_cast<float*>(empty + kStages);   // [2][BN]
  uint16_t* stage_bias = reinterpret_cast<uint16_t*>(stage_cs + 2 * BN);
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

  // The tile walk, the ring's use count `it` and the consumers' turns are
  // gemm_bf16_kernel's (gemm_bf16.cu).
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
          tma_load(stage + kTileA, &map_b, &full[s], kt * BK, n0);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int cw = wg - 1;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, c2 = 2 * (lane % 4);
  int acc[2][64];  // rows 64 * mh + 16 * warp + g (+ 8) of the tile
  for (int i = cw, tile = blockIdx.x + cw * gridDim.x; tile < tiles;
       i += 2, tile += 2 * gridDim.x) {
    const int m0 = tile / tiles_n * BM, n0 = tile % tiles_n * BN;
#pragma unroll
    for (int mh = 0; mh < 2; ++mh)
#pragma unroll
      for (int e = 0; e < 64; ++e) acc[mh][e] = 0;

    if (i > 0) consumer_sync(1 + cw);
    for (int kt = 0, it = i * ktiles; kt < ktiles; ++kt, ++it) {
      const int s = it % kStages;
      mbar_wait(&full[s], (it / kStages) & 1);
      // A and B: 128 rows of 128 bytes each, 8-row groups 1024 bytes apart;
      // a 32-deep step is 32 bytes along the rows.
      const uint32_t a_base = smem_u32(ring + s * kStage);
      const uint32_t b_base = a_base + kTileA;
#pragma unroll
      for (int mh = 0; mh < 2; ++mh) fence_acc(acc[mh]);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < BK / 32; ++k) {
        const uint64_t db = sw128_desc(b_base + 32 * k, 16, 1024);
#pragma unroll
        for (int mh = 0; mh < 2; ++mh)
          wgmma_m64n128k32_s8(acc[mh], sw128_desc(a_base + mh * 64 * 128 + 32 * k, 16, 1024),
                              db);
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

    // The epilogue.  The tile's column scales and bias go to this
    // warpgroup's shared staging (one column per thread), so the inner
    // loop reads them without a global load between its stores; then, 64
    // rows at a time as in gemm_bf16_kernel, every global load a row block
    // needs (the rows' scales and keeps, the residual pairs) is issued
    // before any is used, so that their latencies overlap.
    constexpr bool raw = kEpi == kI8Raw;
    float* tile_cs = stage_cs + cw * BN;
    uint16_t* tile_bias = stage_bias + cw * BN;
    warpgroup_sync(3 + cw);  // the previous tile's epilogue is done with them
    {
      const int col = n0 + threadIdx.x % 128;
      const bool ok = col < p.N && !raw;
      tile_cs[threadIdx.x % 128] = ok ? __ldg(p.b_scale + col) : 0.f;
      tile_bias[threadIdx.x % 128] =
          ok && p.bias ? __ldg(reinterpret_cast<const unsigned short*>(p.bias) + col) : 0;
    }
    warpgroup_sync(3 + cw);
    const bool with_res = kEpi == kI8Out && p.resid && !p.acc_out;
#pragma unroll
    for (int mh = 0; mh < 2; ++mh) {
      int rows[2];
      float rs[2], keep[2];
      uint32_t res[2][16];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        rows[h] = m0 + 64 * mh + 16 * warp + g + 8 * h;
        const bool ok = rows[h] < p.M;
        rs[h] = ok && !raw ? __ldg(p.a_scale + static_cast<size_t>(rows[h]) * p.as_ld) : 0.f;
        keep[h] = ok && p.pads ? 1.f - __bfloat162float(p.pads[rows[h]]) : 1.f;
#pragma unroll
        for (int jn = 0; jn < 16; ++jn) {
          const int col = n0 + 8 * jn + c2;
          res[h][jn] = with_res && ok && col < p.N
                           ? ldg_u32(p.resid + static_cast<size_t>(rows[h]) * p.N + col)
                           : 0u;
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (rows[h] >= p.M) continue;
#pragma unroll
        for (int jn = 0; jn < 16; ++jn) {
          const int col = n0 + 8 * jn + c2;
          if (col >= p.N) continue;
          const int a0 = acc[mh][4 * jn + 2 * h], a1 = acc[mh][4 * jn + 2 * h + 1];
          if constexpr (raw) {
            *reinterpret_cast<int2*>(static_cast<int*>(p.out) +
                                     static_cast<size_t>(rows[h]) * p.ldo + col) =
                make_int2(a0, a1);
            continue;
          }
          else finish2<kEpi, kAct>(p, rows[h], col, a0, a1, rs[h], keep[h],
                  *reinterpret_cast<const float2*>(tile_cs + 8 * jn + c2),
                  *reinterpret_cast<const uint32_t*>(tile_bias + 8 * jn + c2), res[h][jn]);
        }
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
  return p;
}

// out = epilogue(a [M, K] (row pitch lda) @ b [N, K]^T (row pitch ldb)).
cudaError_t gemm(const I8Epi& p, const int8_t* a, int lda, const int8_t* b, int ldb,
                 cudaStream_t stream) {
  if (p.M <= 0 || p.N <= 0 || p.K <= 0 || p.N % 2 || p.K % 16 || lda % 16 || ldb % 16 ||
      lda < p.K || ldb < p.K || !aligned16(a) || !aligned16(b))
    return cudaErrorInvalidValue;
  CUtensorMap map_a, map_b;
  constexpr auto kU8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  if (!tensor_map(&map_a, kU8, a, p.K, p.M, lda, BK, BM) ||
      !tensor_map(&map_b, kU8, b, p.K, p.N, ldb, BK, BN))
    return cudaErrorInvalidValue;
  const long tiles = static_cast<long>((p.M + BM - 1) / BM) * ((p.N + BN - 1) / BN);
  const int grid = static_cast<int>(tiles < sm_count() ? tiles : sm_count());
  auto run = [&](auto kernel) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(kSmem));
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, kSmem, stream>>>(map_a, map_b, p);
    return cudaGetLastError();
  };
  switch (p.epilogue) {
    case kI8Proj: return run(gemm_i8_kernel<kI8Proj, kActNone>);
    case kI8Act:
      if (p.activation == kActGelu) return run(gemm_i8_kernel<kI8Act, kActGelu>);
      if (p.activation == kActRelu) return run(gemm_i8_kernel<kI8Act, kActRelu>);
      return run(gemm_i8_kernel<kI8Act, kActNone>);
    case kI8Out: return run(gemm_i8_kernel<kI8Out, kActNone>);
    case kI8Raw: return run(gemm_i8_kernel<kI8Raw, kActNone>);
    default: return cudaErrorInvalidValue;
  }
}

// LN + quantize x [rows, d]; q | k | v into qkv [rows, 3 nh] in bf16 by one
// product over the fused K-major weights wqkv [3 nh, d], q times
// query_scale (K12a, and the front of K10 and K11).
cudaError_t qkv_projection(const bf16* x, const bf16* ln_s, const bf16* ln_b,
                           const int8_t* wqkv, const float* sqkv, const bf16* bqkv, int8_t* h8,
                           float* hs, bf16* qkv, int rows, int d, int nh, float eps,
                           float query_scale, cudaStream_t st) {
  cudaError_t err = quant(x, d, ln_s, ln_b, eps, h8, d, hs, rows, d, 1, st);
  if (err != cudaSuccess) return err;
  I8Epi p = epi(hs, 1, sqkv, rows, 3 * nh, d, kI8Proj);
  p.bias = bqkv;
  p.out = qkv;
  p.col_mul = query_scale;
  p.scaled_cols = nh;
  return gemm(p, h8, d, wqkv, d, st);
}

// The last product over `chunks` K-slices of a8 [rows, chunks * kc] (row
// scales as [rows, chunks]) and the K-major w [d, chunks * kc] (column
// scales ws):
//   sum:   out = cast(((sum_c (a_c @ w_c)) + bias) * keep + x), the sum in
//          fp32 through facc (K11);
//   chain: out_c = cast(((a_c @ w_c) [+ bias]) [* keep] + resid_c), bias in
//          chunk 0, resid_0 = x, resid_c = out_{c-1} (K9, K10, K12b); the
//          chunks alternate between tmp and out so that the last lands in
//          out (tmp may be null for one chunk).
cudaError_t last_product(const int8_t* a8, const float* as, int chunks, int kc, const int8_t* w,
                         const float* ws, const bf16* bias, const bf16* pads, const bf16* x,
                         float* facc, bf16* tmp, bf16* out, int rows, int d, bool sum,
                         cudaStream_t st) {
  const bf16* resid = x;
  for (int c = 0; c < chunks; ++c) {
    const bool last = c == chunks - 1;
    I8Epi p = epi(as + c, chunks, ws, rows, d, kc, kI8Out);
    if (sum) {
      p.acc_in = c > 0 ? facc : nullptr;
      p.acc_out = last ? nullptr : facc;
      if (last) {
        p.bias = bias;
        p.pads = pads;
        p.resid = x;
        p.out = out;
      }
    } else {
      bf16* dst = (chunks - 1 - c) % 2 == 0 ? out : tmp;
      p.bias = c == 0 ? bias : nullptr;
      p.pads = pads;
      p.resid = resid;
      p.out = dst;
      resid = dst;
    }
    const size_t k0 = static_cast<size_t>(c) * kc;
    cudaError_t err = gemm(p, a8 + k0, chunks * kc, w + k0, chunks * kc, st);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// The attention half from x: q|k|v, K1's attention core, ctx quantized per
// head group, the output product (sum or chain, see last_product).
cudaError_t attention_half(const bf16* x, const float* mask, const bf16* ln_s, const bf16* ln_b,
                           const int8_t* wqkv, const float* sqkv, const bf16* bqkv,
                           const int8_t* wo, const float* so, const bf16* bo, int8_t* h8,
                           float* hs, bf16* qkv, bf16* ctx, int8_t* c8, float* cs, float* facc,
                           bf16* tmp, bf16* out, int batch, int t, int d, int heads, int hd,
                           int mask_b, int mask_t, int chunks, bool sum, float cap, float eps,
                           float query_scale, cudaStream_t st) {
  const int rows = batch * t, nh = heads * hd, gh = nh / chunks;
  cudaError_t err = qkv_projection(x, ln_s, ln_b, wqkv, sqkv, bqkv, h8, hs, qkv, rows, d, nh,
                                   eps, query_scale, st);
  if (err == cudaSuccess)
    err = launch_capped_attention(qkv, mask, ctx, batch, t, heads, hd, mask_b, mask_t, cap, st);
  if (err == cudaSuccess)
    err = quant(ctx, nh, nullptr, nullptr, 0.f, c8, nh, cs, rows, gh, chunks, st);
  if (err == cudaSuccess)
    err = last_product(c8, cs, chunks, gh, wo, so, bo, nullptr, x, facc, tmp, out, rows, d, sum,
                       st);
  return err;
}

// The FFN half from x: LN + quantize, a = act(h @ W1 + b1) * keep in fp32
// over all F columns (W1 K-major [f, d]), a quantized per F-chunk, the
// output product (W2 K-major [d, f]).
cudaError_t ffn_half(const bf16* x, const bf16* pads, const bf16* ln_s, const bf16* ln_b,
                     const int8_t* w1, const float* s1, const bf16* b1, const int8_t* w2,
                     const float* s2, const bf16* b2, int8_t* h8, float* hs, float* a, int8_t* a8,
                     float* as, float* facc, bf16* tmp, bf16* out, int rows, int d, int f,
                     int chunks, bool sum, int activation, float eps, cudaStream_t st) {
  cudaError_t err = quant(x, d, ln_s, ln_b, eps, h8, d, hs, rows, d, 1, st);
  if (err != cudaSuccess) return err;
  I8Epi p = epi(hs, 1, s1, rows, f, d, kI8Act);
  p.bias = b1;
  p.pads = pads;
  p.out = a;
  p.activation = activation;
  err = gemm(p, h8, d, w1, d, st);
  if (err == cudaSuccess)
    err = quant(a, f, nullptr, nullptr, 0.f, a8, f, as, rows, f / chunks, chunks, st);
  if (err == cudaSuccess)
    err = last_product(a8, as, chunks, f / chunks, w2, s2, b2, pads, x, facc, tmp, out, rows, d,
                       sum, st);
  return err;
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
// each; w1 [f, d], w2 [d, f].  Scratch: h8 [rows, d] i8, hs [rows] f32, a
// [rows, f] f32, a8 [rows, f] i8, as [rows, chunks] f32, tmp [rows, d] bf16
// (chunks > 1).
int vp_int8_ffn_block(const void* x, const void* pads, const void* ln_s, const void* ln_b,
                      const void* w1, const void* s1, const void* b1, const void* w2,
                      const void* s2, const void* b2, void* h8, void* hs, void* a, void* a8,
                      void* as, void* tmp, void* out, int rows, int d, int f, int chunks,
                      int activation, float eps, void* stream) {
  return vp::ffn_half(VP_B(x), VP_B(pads), VP_B(ln_s), VP_B(ln_b), VP_I8(w1), VP_F(s1), VP_B(b1),
                      VP_I8(w2), VP_F(s2), VP_B(b2), static_cast<int8_t*>(h8),
                      static_cast<float*>(hs), static_cast<float*>(a), static_cast<int8_t*>(a8),
                      static_cast<float*>(as), nullptr, static_cast<bf16*>(tmp),
                      static_cast<bf16*>(out), rows, d, f, chunks, false, activation, eps,
                      static_cast<cudaStream_t>(stream));
}

// K10: x [batch, t, d] -> out; chunks head groups chained with a cast
// after each; wqkv [3 nh, d] (sqkv, bqkv [3 nh]), wo [d, nh].  Scratch: h8
// [rows, d], hs [rows], qkv [rows, 3 nh] bf16, ctx [rows, nh] bf16, c8
// [rows, nh] i8, cs [rows, chunks] f32, tmp.
int vp_int8_attention_block(const void* x, const void* mask, const void* ln_s, const void* ln_b,
                            const void* wqkv, const void* sqkv, const void* bqkv, const void* wo,
                            const void* so, const void* bo, void* h8, void* hs, void* qkv,
                            void* ctx, void* c8, void* cs, void* tmp, void* out, int batch, int t,
                            int d, int heads, int hd, int mask_b, int mask_t, int chunks,
                            float cap, float eps, float query_scale, void* stream) {
  return vp::attention_half(VP_B(x), VP_F(mask), VP_B(ln_s), VP_B(ln_b), VP_I8(wqkv),
                            VP_F(sqkv), VP_B(bqkv), VP_I8(wo), VP_F(so), VP_B(bo),
                            static_cast<int8_t*>(h8), static_cast<float*>(hs),
                            static_cast<bf16*>(qkv), static_cast<bf16*>(ctx),
                            static_cast<int8_t*>(c8), static_cast<float*>(cs), nullptr,
                            static_cast<bf16*>(tmp), static_cast<bf16*>(out), batch, t, d, heads,
                            hd, mask_b, mask_t, chunks, false, cap, eps, query_scale,
                            static_cast<cudaStream_t>(stream));
}

// K11: a whole pre-norm layer, x [batch, t, d] -> out, the head groups'
// and the F-chunks' products summed in fp32 (facc [rows, d]) and cast
// once each; x1 [rows, d] bf16 is the attention half's output.
int vp_int8_layer_block(const void* x, const void* mask, const void* pads, const void* ln1_s,
                        const void* ln1_b, const void* wqkv, const void* sqkv, const void* bqkv,
                        const void* wo, const void* so, const void* bo, const void* ln2_s,
                        const void* ln2_b, const void* w1, const void* s1, const void* b1,
                        const void* w2, const void* s2, const void* b2, void* h8, void* hs,
                        void* qkv, void* ctx, void* c8, void* cs, void* facc, void* x1, void* a,
                        void* a8, void* as, void* out, int batch, int t, int d, int heads, int hd,
                        int f, int mask_b, int mask_t, int head_chunks, int ffn_chunks,
                        int activation, float cap, float eps, float query_scale, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto* h8p = static_cast<int8_t*>(h8);
  auto* hsp = static_cast<float*>(hs);
  auto* faccp = static_cast<float*>(facc);
  auto* x1p = static_cast<bf16*>(x1);
  cudaError_t err = vp::attention_half(
      VP_B(x), VP_F(mask), VP_B(ln1_s), VP_B(ln1_b), VP_I8(wqkv), VP_F(sqkv), VP_B(bqkv),
      VP_I8(wo), VP_F(so), VP_B(bo), h8p, hsp, static_cast<bf16*>(qkv), static_cast<bf16*>(ctx),
      static_cast<int8_t*>(c8), static_cast<float*>(cs), faccp, nullptr, x1p, batch, t, d, heads,
      hd, mask_b, mask_t, head_chunks, true, cap, eps, query_scale, st);
  if (err != cudaSuccess) return err;
  return vp::ffn_half(x1p, VP_B(pads), VP_B(ln2_s), VP_B(ln2_b), VP_I8(w1), VP_F(s1), VP_B(b1),
                      VP_I8(w2), VP_F(s2), VP_B(b2), h8p, hsp, static_cast<float*>(a),
                      static_cast<int8_t*>(a8), static_cast<float*>(as), faccp, nullptr,
                      static_cast<bf16*>(out), batch * t, d, f, ffn_chunks, true, activation, eps,
                      st);
}

// K12a: x [rows, d] -> q | k | v in the column blocks of qkv [rows, 3 nh],
// one product over wqkv [3 nh, d].
int vp_int8_qkv_projection(const void* x, const void* ln_s, const void* ln_b, const void* wqkv,
                           const void* sqkv, const void* bqkv, void* h8, void* hs, void* qkv,
                           int rows, int d, int nh, float eps, float query_scale, void* stream) {
  return vp::qkv_projection(VP_B(x), VP_B(ln_s), VP_B(ln_b), VP_I8(wqkv), VP_F(sqkv),
                            VP_B(bqkv), static_cast<int8_t*>(h8), static_cast<float*>(hs),
                            static_cast<bf16*>(qkv), rows, d, nh, eps, query_scale,
                            static_cast<cudaStream_t>(stream));
}

// K12b: ctx [rows, nh] -> cast(ctx @ Wo + bo + resid) [rows, d]; wo [d, nh].
int vp_int8_out_projection(const void* ctx, const void* resid, const void* wo, const void* so,
                           const void* bo, void* c8, void* cs, void* out, int rows, int nh, int d,
                           void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto* c8p = static_cast<int8_t*>(c8);
  auto* csp = static_cast<float*>(cs);
  cudaError_t err = vp::quant(VP_B(ctx), nh, nullptr, nullptr, 0.f, c8p, nh, csp, rows, nh, 1, st);
  if (err != cudaSuccess) return err;
  return vp::last_product(c8p, csp, 1, nh, VP_I8(wo), VP_F(so), VP_B(bo), nullptr, VP_B(resid),
                          nullptr, nullptr, static_cast<bf16*>(out), rows, d, false, st);
}

// The int8 GEMM alone, for measurement (chip_smoke.py [gemm-i8]): out [m, n]
// = epilogue(a [m, k] @ b [n, k]^T) with row scales a_scale [m] and column
// scales b_scale [n]; epilogue 0 (q|k|v: + bias, x col_mul on the first
// scaled_cols columns, bf16), 1 (act(+ bias) x keep, fp32), 2 ((+ bias) x
// keep + resid, bf16) or 3 (the int32 sums).
int vp_gemm_i8(const void* a, const void* b, const void* a_scale, const void* b_scale,
               const void* bias, const void* pads, const void* resid, void* out, int m, int n,
               int k, int epilogue, int activation, float col_mul, int scaled_cols,
               void* stream) {
  if (epilogue < vp::kI8Proj || epilogue > vp::kI8Raw) return cudaErrorInvalidValue;
  vp::I8Epi p = vp::epi(VP_F(a_scale), 1, VP_F(b_scale), m, n, k, epilogue);
  p.bias = VP_B(bias);
  p.pads = VP_B(pads);
  p.resid = VP_B(resid);
  p.out = out;
  p.activation = activation;
  p.col_mul = col_mul;
  p.scaled_cols = scaled_cols;
  return vp::gemm(p, VP_I8(a), k, VP_I8(b), k, static_cast<cudaStream_t>(stream));
}

#undef VP_B
#undef VP_F
#undef VP_I8

}  // extern "C"

// K9, K10, K11, K12a and K12b: the int8 (W8A8) serving blocks of
// videoprism_tpu/ops/pallas/int8_blocks.py, as chains of two primitives
// and K1's attention core.
//
//   quant_rows_kernel  per-row (or per row and column chunk) symmetric int8
//                      quantization of an fp32 value, with an optional fp32
//                      LayerNorm in front (quant_rows and _ln_f32):
//                        s = max|h| * (1/127), s = max(s, 1e-12),
//                        q = clip(rint(h * (1/s)), -127, 127).
//                      rintf rounds half to even like jnp.round; 1/s is an
//                      IEEE division (the build has no --use_fast_math).
//   gemm_i8_kernel     int8 x int8 -> int32 products with the blocks' fp32
//                      epilogues, in the reference's order:
//                        v = (float(acc) * row_scale) * col_scale, then
//                        kI8Proj  (v + bias) * col_mul -> bf16 (q's
//                                 query scale; 1 for k and v, exact);
//                        kI8Act   act(v + bias) * keep -> fp32;
//                        kI8Out   v [+ running fp32 sum] -> the sum, or
//                                 ((v + bias) * keep) + residual -> bf16
//                                 (bias, keep and residual each optional).
//
// The blocks (_ffn_int8_chunk_kernel, _attn_int8_chunk_kernel,
// _layer_int8_kernel, _qkv_int8_kernel, _out_int8_kernel):
//   LN1 + quantize x        quant_rows_kernel           -> h8, hs
//   q|k|v                   3 x gemm_i8_kernel kI8Proj  -> qkv bf16 [rows, 3NH]
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
// Bound: at the base model's shapes (K = 768 or 3072 with M = B * 4096
// rows) the products do hundreds of int8 operations per byte, above the
// card's ~590 op/byte ridge for int8, so the tensor cores bound them on
// paper; the quantizers and the fp32 hidden activation (written once and
// read twice) are bytes.  On the TPU int8 ran at the bf16 rate and only
// saved weight bandwidth; on the H100 the int8 tensor cores run at twice
// the bf16 rate, which these first kernels do not reach.
// Design of the product: 128 x 128 x 64 block tiles, 8 warps of 64 x 32,
// mma.sync m16n8k32 s8 with exact int32 accumulators, and a three-stage
// cp.async pipeline.  A ([M, K], K contiguous) is fed to the tensor cores
// with ldmatrix; the weights keep the reference's [K, N] layout (N
// contiguous), so each lane gathers its four k-consecutive bytes of a
// column from shared memory and packs them.  Each lane finishes its own
// accumulator elements in registers.  Ragged M and N edges are masked; K,
// N and every row pitch must be multiples of 16 bytes.  wgmma/TMA and
// int8's 2x rate are left to later work.
#include "common.cuh"

namespace vp {
namespace {

constexpr float kInv127 = static_cast<float>(1.0 / 127.0);

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

// One warp per (row, chunk) of x [rows, chunks * cols] (row pitch ldx).
// With ln_scale (chunks = 1) the quantized value is the fp32 LayerNorm of
// the row, (x - mean) * rsqrt(var + eps) * (scale + 1) + bias, recomputed
// in each pass.  q [rows, chunks * cols] (pitch ldq), scale [rows, chunks].
template <typename T>
__global__ void quant_rows_kernel(const T* __restrict__ x, int ldx,
                                  const bf16* __restrict__ ln_scale,
                                  const bf16* __restrict__ ln_bias, float eps,
                                  int8_t* __restrict__ q, int ldq, float* __restrict__ scale,
                                  int rows, int cols, int chunks) {
  const int w = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (w >= rows * chunks) return;
  const int row = w / chunks, c = w % chunks;
  const T* xr = x + static_cast<size_t>(row) * ldx + static_cast<size_t>(c) * cols;
  int8_t* qr = q + static_cast<size_t>(row) * ldq + static_cast<size_t>(c) * cols;

  float mean = 0.f, inv = 0.f;
  if (ln_scale) {
    float s = 0.f;
    for (int i = lane; i < cols; i += 32) s += to_f32(xr[i]);
    mean = warp_sum(s) / cols;
    float v2 = 0.f;
    for (int i = lane; i < cols; i += 32) {
      const float d = to_f32(xr[i]) - mean;
      v2 += d * d;
    }
    inv = rsqrtf(warp_sum(v2) / cols + eps);
  }
  auto value = [&](int i) {
    const float v = to_f32(xr[i]);
    if (!ln_scale) return v;
    return (v - mean) * inv * (__bfloat162float(ln_scale[i]) + 1.f) +
           __bfloat162float(ln_bias[i]);
  };
  float m = 0.f;
  for (int i = lane; i < cols; i += 32) m = fmaxf(m, fabsf(value(i)));
  m = warp_max(m);
  const float s = fmaxf(m * kInv127, 1e-12f);
  const float inv_s = 1.0f / s;
  for (int i = lane; i < cols; i += 32)
    qr[i] = static_cast<int8_t>(fminf(fmaxf(rintf(value(i) * inv_s), -127.f), 127.f));
  if (lane == 0) scale[static_cast<size_t>(row) * chunks + c] = s;
}

enum I8Epilogue : int { kI8Proj = 0, kI8Act = 1, kI8Out = 2 };

struct I8Gemm {
  const int8_t* a;        // [M, K], row pitch lda
  const float* a_scale;   // row m's scale at a_scale[m * as_ld]
  const int8_t* b;        // [K, N], row pitch ldb
  const float* b_scale;   // [N]
  const bf16* bias;       // [N] or null
  const bf16* pads;       // [M] (keep = 1 - pad) or null
  const bf16* resid;      // [M, N] or null
  const float* acc_in;    // [M, N] running fp32 sum to add, or null
  float* acc_out;         // [M, N] running fp32 sum to write, or null (kI8Out)
  void* out;              // bf16 (kI8Proj, kI8Out) or fp32 (kI8Act), pitch ldo
  int lda, as_ld, ldb, ldo, M, N, K, epilogue, activation;
  float col_mul;          // kI8Proj: the query scale for q, 1 for k and v
};

constexpr int BM = 128, BN = 128, BK = 64;
constexpr int A_LD = BK + 16;   // bytes per shared A row: ldmatrix rows on distinct banks
constexpr int B_LD = BN + 16;   // bytes per shared B row
constexpr int kThreads = 256;   // 8 warps: 2 along M x 4 along N
constexpr int WM = 64, WN = 32;
constexpr int MT = WM / 16, NT = WN / 8;   // m16n8 tiles per warp
constexpr int kStages = 3;
constexpr int kStageBytes = BM * A_LD + BK * B_LD;
constexpr size_t kSmemBytes = static_cast<size_t>(kStages) * kStageBytes;

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// c[16x8] += a[16x32] @ b[32x8], s8 operands, exact s32 accumulators.
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four bytes of one column of a row-major shared tile, k-consecutive.
__device__ __forceinline__ uint32_t gather4(const uint8_t* p) {
  return static_cast<uint32_t>(p[0]) | static_cast<uint32_t>(p[B_LD]) << 8 |
         static_cast<uint32_t>(p[2 * B_LD]) << 16 | static_cast<uint32_t>(p[3 * B_LD]) << 24;
}

__device__ __forceinline__ float activate(float v, int act) {
  if (act == kActGelu) return 0.5f * v * (1.f + erff(v * 0.7071067811865476f));
  if (act == kActRelu) return fmaxf(v, 0.f);
  return v;
}

// Epilogue of two neighbouring elements (row, col) and (row, col + 1).
__device__ __forceinline__ void finish2(const I8Gemm& p, int row, int col, int acc0, int acc1) {
  const float rs = p.a_scale[static_cast<size_t>(row) * p.as_ld];
  float v[2] = {__int2float_rn(acc0) * rs * p.b_scale[col],
                __int2float_rn(acc1) * rs * p.b_scale[col + 1]};
  const size_t off = static_cast<size_t>(row) * p.N + col;
  if (p.epilogue == kI8Proj) {
    for (int e = 0; e < 2; ++e)
      v[e] = (v[e] + __bfloat162float(p.bias[col + e])) * p.col_mul;
    *reinterpret_cast<bf162*>(static_cast<bf16*>(p.out) + static_cast<size_t>(row) * p.ldo +
                              col) = __floats2bfloat162_rn(v[0], v[1]);
    return;
  }
  const float keep = p.pads ? 1.f - __bfloat162float(p.pads[row]) : 1.f;
  if (p.epilogue == kI8Act) {
    for (int e = 0; e < 2; ++e)
      v[e] = activate(v[e] + __bfloat162float(p.bias[col + e]), p.activation) * keep;
    *reinterpret_cast<float2*>(static_cast<float*>(p.out) + static_cast<size_t>(row) * p.ldo +
                               col) = make_float2(v[0], v[1]);
    return;
  }
  if (p.acc_in) {
    const float2 r = *reinterpret_cast<const float2*>(p.acc_in + off);
    v[0] = r.x + v[0];
    v[1] = r.y + v[1];
  }
  if (p.acc_out) {
    *reinterpret_cast<float2*>(p.acc_out + off) = make_float2(v[0], v[1]);
    return;
  }
  for (int e = 0; e < 2; ++e) {
    if (p.bias) v[e] += __bfloat162float(p.bias[col + e]);
    if (p.pads) v[e] *= keep;
    if (p.resid) v[e] += __bfloat162float(p.resid[off + e]);
  }
  *reinterpret_cast<bf162*>(static_cast<bf16*>(p.out) + static_cast<size_t>(row) * p.ldo + col) =
      __floats2bfloat162_rn(v[0], v[1]);
}

__global__ void __launch_bounds__(kThreads) gemm_i8_kernel(const I8Gemm p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int warp_m = warp / 4, warp_n = warp % 4;
  const int g = lane / 4, t = lane % 4;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  auto load_tile = [&](int kt, int stage) {
    unsigned char* As = smem + stage * kStageBytes;
    unsigned char* Bs = As + BM * A_LD;
    const int k0 = kt * BK;
#pragma unroll
    for (int i = 0; i < BM * BK / 16 / kThreads; ++i) {  // A: 128 rows x 4 chunks
      const int c = tid + i * kThreads;
      const int r = c / (BK / 16), col = (c % (BK / 16)) * 16;
      const bool ok = (m0 + r < p.M) && (k0 + col < p.K);
      const int8_t* src = ok ? p.a + static_cast<size_t>(m0 + r) * p.lda + k0 + col : p.a;
      cp_async16(As + r * A_LD + col, src, ok);
    }
#pragma unroll
    for (int i = 0; i < BK * BN / 16 / kThreads; ++i) {  // B: 64 rows x 8 chunks
      const int c = tid + i * kThreads;
      const int r = c / (BN / 16), col = (c % (BN / 16)) * 16;
      const bool ok = (k0 + r < p.K) && (n0 + col < p.N);
      const int8_t* src = ok ? p.b + static_cast<size_t>(k0 + r) * p.ldb + n0 + col : p.b;
      cp_async16(Bs + r * B_LD + col, src, ok);
    }
  };

  int acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int ktiles = (p.K + BK - 1) / BK;
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
    const unsigned char* As = smem + (kt % kStages) * kStageBytes;
    const unsigned char* Bs = As + BM * A_LD;
#pragma unroll
    for (int ks = 0; ks < BK; ks += 32) {
      uint32_t af[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        ldsm_x4(af[i], As + (warp_m * WM + i * 16 + lane % 16) * A_LD + ks + (lane / 16) * 16);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const uint8_t* col = Bs + (ks + 4 * t) * B_LD + warp_n * WN + j * 8 + g;
        const uint32_t b0 = gather4(col), b1 = gather4(col + 16 * B_LD);
#pragma unroll
        for (int i = 0; i < MT; ++i) mma_s8(acc[i][j], af[i], b0, b1);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int row = m0 + warp_m * WM + i * 16 + g;
      const int col = n0 + warp_n * WN + j * 8 + 2 * t;
      if (col >= p.N) continue;
      if (row < p.M) finish2(p, row, col, acc[i][j][0], acc[i][j][1]);
      if (row + 8 < p.M) finish2(p, row + 8, col, acc[i][j][2], acc[i][j][3]);
    }
}

cudaError_t gemm(const I8Gemm& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(gemm_i8_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.N + BN - 1) / BN, (p.M + BM - 1) / BM);
  gemm_i8_kernel<<<grid, kThreads, kSmemBytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t quant(const T* x, int ldx, const bf16* ln_scale, const bf16* ln_bias, float eps,
                  int8_t* q, int ldq, float* scale, int rows, int cols, int chunks,
                  cudaStream_t stream) {
  constexpr int kWarps = 8;
  const int blocks = (rows * chunks + kWarps - 1) / kWarps;
  quant_rows_kernel<T><<<blocks, kWarps * 32, 0, stream>>>(x, ldx, ln_scale, ln_bias, eps, q, ldq,
                                                           scale, rows, cols, chunks);
  return cudaGetLastError();
}

I8Gemm make(const int8_t* a, int lda, const float* a_scale, int as_ld, const int8_t* b, int ldb,
            const float* b_scale, int M, int N, int K, int epilogue) {
  I8Gemm p{};
  p.a = a;
  p.lda = lda;
  p.a_scale = a_scale;
  p.as_ld = as_ld;
  p.b = b;
  p.ldb = ldb;
  p.b_scale = b_scale;
  p.M = M;
  p.N = N;
  p.K = K;
  p.ldo = N;
  p.epilogue = epilogue;
  return p;
}

// LN + quantize x [rows, d]; q | k | v into the column blocks of qkv
// [rows, 3 nh] in bf16, q times query_scale (K12a, and the front of K10
// and K11).
cudaError_t qkv_projection(const bf16* x, const bf16* ln_s, const bf16* ln_b,
                           const int8_t* const w[3], const float* const s[3],
                           const bf16* const bias[3], int8_t* h8, float* hs, bf16* qkv, int rows,
                           int d, int nh, float eps, float query_scale, cudaStream_t st) {
  cudaError_t err = quant(x, d, ln_s, ln_b, eps, h8, d, hs, rows, d, 1, st);
  for (int i = 0; i < 3 && err == cudaSuccess; ++i) {
    I8Gemm p = make(h8, d, hs, 1, w[i], nh, s[i], rows, nh, d, kI8Proj);
    p.bias = bias[i];
    p.out = qkv + static_cast<size_t>(i) * nh;
    p.ldo = 3 * nh;
    p.col_mul = i == 0 ? query_scale : 1.f;
    err = gemm(p, st);
  }
  return err;
}

// The last product over `chunks` K-slices of a8 [rows, chunks * kc] (row
// scales as [rows, chunks]) and w [chunks * kc, d] (column scales ws):
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
    I8Gemm p = make(a8 + static_cast<size_t>(c) * kc, chunks * kc, as + c, chunks,
                    w + static_cast<size_t>(c) * kc * d, d, ws, rows, d, kc, kI8Out);
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
    cudaError_t err = gemm(p, st);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// The attention half from x: q|k|v, K1's attention core, ctx quantized per
// head group, the output product (sum or chain, see last_product).
cudaError_t attention_half(const bf16* x, const float* mask, const bf16* ln_s, const bf16* ln_b,
                           const int8_t* const w[3], const float* const s[3],
                           const bf16* const bias[3], const int8_t* wo, const float* so,
                           const bf16* bo, int8_t* h8, float* hs, bf16* qkv, bf16* ctx,
                           int8_t* c8, float* cs, float* facc, bf16* tmp, bf16* out, int batch,
                           int t, int d, int heads, int hd, int mask_b, int mask_t, int chunks,
                           bool sum, float cap, float eps, float query_scale, cudaStream_t st) {
  const int rows = batch * t, nh = heads * hd, gh = nh / chunks;
  cudaError_t err = qkv_projection(x, ln_s, ln_b, w, s, bias, h8, hs, qkv, rows, d, nh, eps,
                                   query_scale, st);
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
// over all F columns, a quantized per F-chunk, the output product.
cudaError_t ffn_half(const bf16* x, const bf16* pads, const bf16* ln_s, const bf16* ln_b,
                     const int8_t* w1, const float* s1, const bf16* b1, const int8_t* w2,
                     const float* s2, const bf16* b2, int8_t* h8, float* hs, float* a, int8_t* a8,
                     float* as, float* facc, bf16* tmp, bf16* out, int rows, int d, int f,
                     int chunks, bool sum, int activation, float eps, cudaStream_t st) {
  cudaError_t err = quant(x, d, ln_s, ln_b, eps, h8, d, hs, rows, d, 1, st);
  if (err != cudaSuccess) return err;
  I8Gemm p = make(h8, d, hs, 1, w1, f, s1, rows, f, d, kI8Act);
  p.bias = b1;
  p.pads = pads;
  p.out = a;
  p.activation = activation;
  err = gemm(p, st);
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

// K9: x [rows, d] bf16 -> out; chunks F-slices chained with a cast after
// each.  Scratch: h8 [rows, d] i8, hs [rows] f32, a [rows, f] f32, a8
// [rows, f] i8, as [rows, chunks] f32, tmp [rows, d] bf16 (chunks > 1).
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
// after each.  Scratch: h8 [rows, d], hs [rows], qkv [rows, 3 nh] bf16,
// ctx [rows, nh] bf16, c8 [rows, nh] i8, cs [rows, chunks] f32, tmp.
int vp_int8_attention_block(const void* x, const void* mask, const void* ln_s, const void* ln_b,
                            const void* wq, const void* sq, const void* bq, const void* wk,
                            const void* sk, const void* bk, const void* wv, const void* sv,
                            const void* bv, const void* wo, const void* so, const void* bo,
                            void* h8, void* hs, void* qkv, void* ctx, void* c8, void* cs,
                            void* tmp, void* out, int batch, int t, int d, int heads, int hd,
                            int mask_b, int mask_t, int chunks, float cap, float eps,
                            float query_scale, void* stream) {
  const int8_t* w[3] = {VP_I8(wq), VP_I8(wk), VP_I8(wv)};
  const float* s[3] = {VP_F(sq), VP_F(sk), VP_F(sv)};
  const bf16* b[3] = {VP_B(bq), VP_B(bk), VP_B(bv)};
  return vp::attention_half(VP_B(x), VP_F(mask), VP_B(ln_s), VP_B(ln_b), w, s, b, VP_I8(wo),
                            VP_F(so), VP_B(bo), static_cast<int8_t*>(h8), static_cast<float*>(hs),
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
                        const void* ln1_b, const void* wq, const void* sq, const void* bq,
                        const void* wk, const void* sk, const void* bk, const void* wv,
                        const void* sv, const void* bv, const void* wo, const void* so,
                        const void* bo, const void* ln2_s, const void* ln2_b, const void* w1,
                        const void* s1, const void* b1, const void* w2, const void* s2,
                        const void* b2, void* h8, void* hs, void* qkv, void* ctx, void* c8,
                        void* cs, void* facc, void* x1, void* a, void* a8, void* as, void* out,
                        int batch, int t, int d, int heads, int hd, int f, int mask_b, int mask_t,
                        int head_chunks, int ffn_chunks, int activation, float cap, float eps,
                        float query_scale, void* stream) {
  const int8_t* w[3] = {VP_I8(wq), VP_I8(wk), VP_I8(wv)};
  const float* s[3] = {VP_F(sq), VP_F(sk), VP_F(sv)};
  const bf16* b[3] = {VP_B(bq), VP_B(bk), VP_B(bv)};
  auto st = static_cast<cudaStream_t>(stream);
  auto* h8p = static_cast<int8_t*>(h8);
  auto* hsp = static_cast<float*>(hs);
  auto* faccp = static_cast<float*>(facc);
  auto* x1p = static_cast<bf16*>(x1);
  cudaError_t err = vp::attention_half(
      VP_B(x), VP_F(mask), VP_B(ln1_s), VP_B(ln1_b), w, s, b, VP_I8(wo), VP_F(so), VP_B(bo), h8p,
      hsp, static_cast<bf16*>(qkv), static_cast<bf16*>(ctx), static_cast<int8_t*>(c8),
      static_cast<float*>(cs), faccp, nullptr, x1p, batch, t, d, heads, hd, mask_b, mask_t,
      head_chunks, true, cap, eps, query_scale, st);
  if (err != cudaSuccess) return err;
  return vp::ffn_half(x1p, VP_B(pads), VP_B(ln2_s), VP_B(ln2_b), VP_I8(w1), VP_F(s1), VP_B(b1),
                      VP_I8(w2), VP_F(s2), VP_B(b2), h8p, hsp, static_cast<float*>(a),
                      static_cast<int8_t*>(a8), static_cast<float*>(as), faccp, nullptr,
                      static_cast<bf16*>(out), batch * t, d, f, ffn_chunks, true, activation, eps,
                      st);
}

// K12a: x [rows, d] -> q | k | v in the column blocks of qkv [rows, 3 nh].
int vp_int8_qkv_projection(const void* x, const void* ln_s, const void* ln_b, const void* wq,
                           const void* sq, const void* bq, const void* wk, const void* sk,
                           const void* bk, const void* wv, const void* sv, const void* bv,
                           void* h8, void* hs, void* qkv, int rows, int d, int nh, float eps,
                           float query_scale, void* stream) {
  const int8_t* w[3] = {VP_I8(wq), VP_I8(wk), VP_I8(wv)};
  const float* s[3] = {VP_F(sq), VP_F(sk), VP_F(sv)};
  const bf16* b[3] = {VP_B(bq), VP_B(bk), VP_B(bv)};
  return vp::qkv_projection(VP_B(x), VP_B(ln_s), VP_B(ln_b), w, s, b, static_cast<int8_t*>(h8),
                            static_cast<float*>(hs), static_cast<bf16*>(qkv), rows, d, nh, eps,
                            query_scale, static_cast<cudaStream_t>(stream));
}

// K12b: ctx [rows, nh] -> cast(ctx @ Wo + bo + resid) [rows, d].
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

#undef VP_B
#undef VP_F
#undef VP_I8

}  // extern "C"

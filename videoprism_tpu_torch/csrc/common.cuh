// Shared helpers and host launchers of the Hopper kernels.
//
// Every exported entry point has a plain C interface (loaded from Python
// with ctypes), launches on the stream it is given, allocates nothing and
// returns cudaGetLastError() after its launches (0 on success).
#pragma once

#include <cfloat>
#include <cstddef>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace vp {

using bf16 = __nv_bfloat16;
using bf162 = __nv_bfloat162;

// -0.7 * float32 max, the JAX package's large negative mask value
// (ops/masks.py), and the select threshold half of it.
constexpr float kNegInf = static_cast<float>(-0.7 * static_cast<double>(FLT_MAX));
constexpr float kMaskThreshold = static_cast<float>(-0.7 * static_cast<double>(FLT_MAX) * 0.5);

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// 16-byte async copy global -> shared; zero-fills the destination when
// `valid` is false (nothing is read from `src` then).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// Eight bf16 <-> eight floats through one 16-byte word.
__device__ __forceinline__ void unpack8(const uint4& w, float* f) {
  const bf162* h = reinterpret_cast<const bf162*>(&w);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}
__device__ __forceinline__ uint4 pack8(const float* f) {
  uint4 w;
  bf162* h = reinterpret_cast<bf162*>(&w);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return w;
}

// Raises Kernel's dynamic shared-memory limit to `bytes` once per device:
// the attribute persists, and setting it on every launch costs host time.
template <auto Kernel>
inline cudaError_t set_max_dynamic_smem(size_t bytes) {
  static unsigned done = 0;  // one bit per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 32 && ((done >> dev) & 1u)) return cudaSuccess;
  err = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess && dev < 32) done |= 1u << dev;
  return err;
}

// Streaming multiprocessors of the current device (cached per device).
inline int sm_count() {
  static int count[32] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= 32) return 132;
  if (!count[dev] &&
      cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 132;
  return count[dev];
}

inline bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

// Warps per block of a kernel that gives each warp one row: 8, halved
// while that leaves fewer than two blocks per SM, so that a short call
// (130 rows of the text tower) spreads over the card.
inline int row_warps(long rows) {
  int warps = 8;
  const long want = 2L * sm_count();
  while (warps > 1 && (rows + warps - 1) / warps < want) warps /= 2;
  return warps;
}

// A row of up to 32 * kMaxRowChunks 16-byte chunks (2048 bf16) is held in
// registers by the row kernels (ln_rows.cu, int8_blocks.cu): lane l keeps
// chunks l, l + 32, ..  Wider rows, or rows that are not whole 16-byte
// chunks, take their streaming kernels.
constexpr int kMaxRowChunks = 8;
inline int row_chunks(int cols) { return (cols / 8 + 31) / 32; }

// ---- host launchers (each returns cudaGetLastError() after its launch) ----

// Row LayerNorm with fp32 statistics, (x - mean) * rsqrt(var + eps) *
// (scale + scale_offset) + bias (offset 1 is the (scale + 1) convention, 0
// is direct_scale), rows read in [B, X, Y] order and written in [B, Y, X]
// order, plus pos[x] in fp32 before the single cast when `pos` is not null.
// X = Y = 1 is a plain row LN.
cudaError_t launch_ln_rows(const bf16* x, const bf16* scale, const bf16* bias, const bf16* pos,
                           bf16* out, int batch, int X, int Y, int d, float scale_offset,
                           float eps, cudaStream_t stream);

enum Epilogue : int {
  kEpiQkv = 0,       // + bias, x col_scale on the first scaled_cols columns
  kEpiActKeep = 1,   // + bias, activation, x keep
  kEpiResidual = 2,  // + bias, x keep (when pads given), + residual in fp32
  kEpiChain = 3,     // kEpiResidual over `chunks` K-slices, cast after each
};
enum Activation : int { kActNone = 0, kActGelu = 1, kActRelu = 2 };

// out[M, N] = epilogue(a[M, K] @ b[K, N]) in bf16 with fp32 accumulation;
// row m of a starts at a + m * lda (lda = K for a contiguous a).  bias and
// pads (1 = padded row, keep = 1 - pad) may be null; kEpiResidual and
// kEpiChain need the residual [M, N]; kEpiChain cuts K into `chunks` slices
// of K / chunks (the other epilogues take chunks = 1), kEpiActKeep GELU or
// ReLU.  Needs N, lda, the slices' width and the offset of a in elements to
// be multiples of 8 (16-byte rows); a ragged K edge is zero-filled.
cudaError_t launch_gemm_bf16(const bf16* a, const bf16* b, const bf16* bias, const bf16* pads,
                             const bf16* residual, bf16* out, int M, int N, int K, int lda,
                             int epilogue, int activation, float col_scale, int scaled_cols,
                             int chunks, cudaStream_t stream);

// Soft-capped softmax attention over a fused [B*T, 3*N*H] q|k|v buffer
// (q already scaled) into ctx [B*T, N*H].  mask is an fp32 [mb, mt, T]
// additive mask (mb in {1, B}, mt in {1, T}).  Any T; head_dim a multiple
// of 8, at most 128.
cudaError_t launch_capped_attention(const bf16* qkv, const float* mask, bf16* ctx, int batch,
                                    int T, int num_heads, int head_dim, int mask_b, int mask_t,
                                    float logit_cap, cudaStream_t stream);

// The same core at head dims 88 and 96 and T <= 256, K and V held whole in
// shared memory (resident_attention.cu); launch_capped_attention takes it
// wherever resident_attention_takes(T, head_dim).
bool resident_attention_takes(int T, int head_dim);
cudaError_t launch_resident_attention(const bf16* qkv, const float* mask, bf16* ctx, int batch,
                                      int T, int num_heads, int head_dim, int mask_b, int mask_t,
                                      float logit_cap, cudaStream_t stream);

}  // namespace vp

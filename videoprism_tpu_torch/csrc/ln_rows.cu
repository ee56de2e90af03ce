// Row LayerNorm, and the encoder's two stack boundaries built on it.
//
// Replaces:
//   * the fp32 LN at the head of the TPU block kernels (_ln_f32 in
//     videoprism_tpu/ops/pallas/transformer_block.py), which the K1/K2 entry
//     points in transformer_block.cu run through launch_ln_rows;
//   * K6 videoprism_tpu/ops/pallas/layer_norm.py fused_layer_norm_2d
//     (_ln_kernel): a plain row LN, (scale + 1) or the scale itself with
//     direct_scale, every LN outside the fused blocks;
//   * K3 videoprism_tpu/ops/pallas/boundary.py spatial_to_temporal
//     (_st_kernel): spatial_ln + temporal pos-emb + regroup
//     (b t) n d -> (b n) t d;
//   * K4 boundary.py temporal_to_output (_ts_kernel): temporal_ln + regroup
//     (b n) t d -> b (t n) d.
//
// Bound: device-memory bytes.  Each row is read once from HBM and written
// once (a few FLOPs per byte), so the limit is the 3.35 TB/s of the card;
// at the text tower's 130 rows it is latency.
// Design: one warp per row, the row held in registers.  Lane l loads the
// row's 16-byte chunks l, l + 32, .. (eight bf16 each, so every load
// instruction of a warp covers 512 contiguous bytes) together with the same
// chunks of scale and bias, and the mean, the variance and the output all
// come from those registers: one read of the row from HBM, no re-read from
// L1.  Rows of up to 2048 (kMaxRowChunks chunks per lane) take this path,
// D = 768, 1024 and 1408 among them (1408 is 176 chunks: lanes 0-15 take a
// sixth); a row that is wider, or not whole 16-byte chunks, takes the
// streaming kernel, which re-reads it per pass.  Warps per block follow the
// row count (row_warps), so 130 rows spread over 130 SMs instead of 17.  The
// regroup costs nothing extra: a row is written whole at its transposed row
// index, so the TPU kernel's unrolled slice copies have no counterpart
// here.  Rounding follows _st_kernel: the pos-emb is added in fp32 before
// the one cast to bf16; the statistics are fp32, summed per lane over its
// chunks and then across the warp.
#include "common.cuh"

namespace vp {
namespace {

struct LnRows {
  const bf16* x;
  const bf16* scale;
  const bf16* bias;
  const bf16* pos;  // [X, d] or null
  bf16* out;
  int rows, X, Y, d;
  float scale_offset, eps;
};

// Row `row` of [B, X, Y] is written at row (b, y, x) of [B, Y, X].
__device__ __forceinline__ size_t regrouped(const LnRows& p, int row, int* xi) {
  const int y = row % p.Y;
  *xi = (row / p.Y) % p.X;
  const int b = row / (p.X * p.Y);
  return (static_cast<size_t>(b) * p.Y + y) * p.X + *xi;
}

template <int J>
__global__ void ln_rows_kernel(const __grid_constant__ LnRows p) {
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= p.rows) return;
  int xi;
  const size_t out_row = regrouped(p, row, &xi);
  const int n8 = p.d / 8;
  const uint4* xr = reinterpret_cast<const uint4*>(p.x + static_cast<size_t>(row) * p.d);
  const uint4* sc = reinterpret_cast<const uint4*>(p.scale);
  const uint4* bi = reinterpret_cast<const uint4*>(p.bias);
  uint4 xv[J], sv[J], bv[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int i = lane + 32 * j;
    if (i < n8) {
      xv[j] = __ldg(xr + i);
      sv[j] = __ldg(sc + i);
      bv[j] = __ldg(bi + i);
    }
  }
  float f[8];
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    if (lane + 32 * j < n8) {
      unpack8(xv[j], f);
#pragma unroll
      for (int e = 0; e < 8; ++e) s += f[e];
    }
  }
  const float mean = warp_sum(s) / p.d;
  float q = 0.f;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    if (lane + 32 * j < n8) {
      unpack8(xv[j], f);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float a = f[e] - mean;
        q += a * a;
      }
    }
  }
  const float inv = rsqrtf(warp_sum(q) / p.d + p.eps);

  const uint4* pr =
      p.pos ? reinterpret_cast<const uint4*>(p.pos + static_cast<size_t>(xi) * p.d) : nullptr;
  uint4* o = reinterpret_cast<uint4*>(p.out + out_row * p.d);
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int i = lane + 32 * j;
    if (i >= n8) continue;
    float g[8], h[8], r[8];
    unpack8(xv[j], f);
    unpack8(sv[j], g);
    unpack8(bv[j], h);
#pragma unroll
    for (int e = 0; e < 8; ++e) r[e] = (f[e] - mean) * inv * (g[e] + p.scale_offset) + h[e];
    if (pr) {
      float pe[8];
      unpack8(__ldg(pr + i), pe);
#pragma unroll
      for (int e = 0; e < 8; ++e) r[e] += pe[e];
    }
    o[i] = pack8(r);
  }
}

// The streaming path: any even d, the row re-read from L1 per pass, bf16x2
// loads across the warp.
__global__ void ln_rows_stream_kernel(const __grid_constant__ LnRows p) {
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= p.rows) return;
  int xi;
  const size_t out_row = regrouped(p, row, &xi);
  const bf162* xr = reinterpret_cast<const bf162*>(p.x + static_cast<size_t>(row) * p.d);
  const int pairs = p.d / 2;

  float s = 0.f;
  for (int i = lane; i < pairs; i += 32) {
    float2 v = __bfloat1622float2(xr[i]);
    s += v.x + v.y;
  }
  const float mean = warp_sum(s) / p.d;
  float q = 0.f;
  for (int i = lane; i < pairs; i += 32) {
    float2 v = __bfloat1622float2(xr[i]);
    float a = v.x - mean, c = v.y - mean;
    q += a * a + c * c;
  }
  const float inv = rsqrtf(warp_sum(q) / p.d + p.eps);

  const bf162* sc = reinterpret_cast<const bf162*>(p.scale);
  const bf162* bi = reinterpret_cast<const bf162*>(p.bias);
  const bf162* pr =
      p.pos ? reinterpret_cast<const bf162*>(p.pos + static_cast<size_t>(xi) * p.d) : nullptr;
  bf162* o = reinterpret_cast<bf162*>(p.out + out_row * p.d);
  for (int i = lane; i < pairs; i += 32) {
    float2 v = __bfloat1622float2(xr[i]);
    float2 g = __bfloat1622float2(sc[i]);
    float2 h = __bfloat1622float2(bi[i]);
    float r0 = (v.x - mean) * inv * (g.x + p.scale_offset) + h.x;
    float r1 = (v.y - mean) * inv * (g.y + p.scale_offset) + h.y;
    if (pr) {
      float2 pe = __bfloat1622float2(pr[i]);
      r0 += pe.x;
      r1 += pe.y;
    }
    o[i] = __floats2bfloat162_rn(r0, r1);
  }
}

}  // namespace

cudaError_t launch_ln_rows(const bf16* x, const bf16* scale, const bf16* bias, const bf16* pos,
                           bf16* out, int batch, int X, int Y, int d, float scale_offset,
                           float eps, cudaStream_t stream) {
  const LnRows p{x, scale, bias, pos, out, batch * X * Y, X, Y, d, scale_offset, eps};
  const int warps = row_warps(p.rows);
  const int blocks = (p.rows + warps - 1) / warps;
  const int chunks = row_chunks(d);
  const bool regs = d % 8 == 0 && chunks <= kMaxRowChunks && aligned16(x) && aligned16(scale) &&
                    aligned16(bias) && aligned16(out) && (!pos || aligned16(pos));
  if (!regs) {
    ln_rows_stream_kernel<<<blocks, warps * 32, 0, stream>>>(p);
    return cudaGetLastError();
  }
  switch (chunks) {
#define VP_LN_CASE(j) \
  case j:             \
    ln_rows_kernel<j><<<blocks, warps * 32, 0, stream>>>(p); \
    break;
    VP_LN_CASE(1) VP_LN_CASE(2) VP_LN_CASE(3) VP_LN_CASE(4)
    VP_LN_CASE(5) VP_LN_CASE(6) VP_LN_CASE(7) VP_LN_CASE(8)
#undef VP_LN_CASE
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace vp

extern "C" {

// K3: features [b*t, n, d] -> [b*n, t, d], LN + pos_emb[t] (pos [t, d]).
int vp_spatial_to_temporal(const void* x, const void* scale, const void* bias, const void* pos,
                           void* out, int b, int t, int n, int d, float eps, void* stream) {
  using vp::bf16;
  return vp::launch_ln_rows(static_cast<const bf16*>(x), static_cast<const bf16*>(scale),
                            static_cast<const bf16*>(bias), static_cast<const bf16*>(pos),
                            static_cast<bf16*>(out), b, t, n, d, 1.f, eps,
                            static_cast<cudaStream_t>(stream));
}

// K4: features [b*n, t, d] -> [b, t*n, d], LN.
int vp_temporal_to_output(const void* x, const void* scale, const void* bias, void* out, int b,
                          int n, int t, int d, float eps, void* stream) {
  using vp::bf16;
  return vp::launch_ln_rows(static_cast<const bf16*>(x), static_cast<const bf16*>(scale),
                            static_cast<const bf16*>(bias), nullptr, static_cast<bf16*>(out), b,
                            n, t, d, 1.f, eps, static_cast<cudaStream_t>(stream));
}

// K6: x [rows, d] -> LN(x) [rows, d]; (scale + 1), or scale with
// direct_scale.
int vp_layer_norm(const void* x, const void* scale, const void* bias, void* out, int rows, int d,
                  int direct_scale, float eps, void* stream) {
  using vp::bf16;
  return vp::launch_ln_rows(static_cast<const bf16*>(x), static_cast<const bf16*>(scale),
                            static_cast<const bf16*>(bias), nullptr, static_cast<bf16*>(out), rows,
                            1, 1, d, direct_scale ? 0.f : 1.f, eps,
                            static_cast<cudaStream_t>(stream));
}

const char* vp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

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
// once (a few FLOPs per byte), so the limit is the 3.35 TB/s of the card.
// Design: one warp per row, bf16x2 loads across the warp so that every load
// instruction of a warp covers 128 contiguous bytes; the two statistics
// passes re-read the row from L1 instead of keeping it in registers, which
// keeps any width D legal.  The regroup costs nothing extra: a row is
// written whole at its transposed row index, so the TPU kernel's unrolled
// slice copies have no counterpart here.  Rounding follows _st_kernel: the
// pos-emb is added in fp32 before the one cast to bf16.
#include "common.cuh"

namespace vp {

__global__ void ln_rows_kernel(const bf16* __restrict__ x, const bf16* __restrict__ scale,
                               const bf16* __restrict__ bias, const bf16* __restrict__ pos,
                               bf16* __restrict__ out, int rows, int X, int Y, int d,
                               float scale_offset, float eps) {
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const int y = row % Y;
  const int xi = (row / Y) % X;
  const int b = row / (X * Y);
  const size_t out_row = (static_cast<size_t>(b) * Y + y) * X + xi;
  const bf162* xr = reinterpret_cast<const bf162*>(x + static_cast<size_t>(row) * d);
  const int pairs = d / 2;

  float s = 0.f;
  for (int i = lane; i < pairs; i += 32) {
    float2 v = __bfloat1622float2(xr[i]);
    s += v.x + v.y;
  }
  const float mean = warp_sum(s) / d;
  float q = 0.f;
  for (int i = lane; i < pairs; i += 32) {
    float2 v = __bfloat1622float2(xr[i]);
    float a = v.x - mean, c = v.y - mean;
    q += a * a + c * c;
  }
  const float inv = rsqrtf(warp_sum(q) / d + eps);

  const bf162* sc = reinterpret_cast<const bf162*>(scale);
  const bf162* bi = reinterpret_cast<const bf162*>(bias);
  const bf162* pr = pos ? reinterpret_cast<const bf162*>(pos + static_cast<size_t>(xi) * d) : nullptr;
  bf162* o = reinterpret_cast<bf162*>(out + out_row * d);
  for (int i = lane; i < pairs; i += 32) {
    float2 v = __bfloat1622float2(xr[i]);
    float2 g = __bfloat1622float2(sc[i]);
    float2 h = __bfloat1622float2(bi[i]);
    float r0 = (v.x - mean) * inv * (g.x + scale_offset) + h.x;
    float r1 = (v.y - mean) * inv * (g.y + scale_offset) + h.y;
    if (pr) {
      float2 p = __bfloat1622float2(pr[i]);
      r0 += p.x;
      r1 += p.y;
    }
    o[i] = __floats2bfloat162_rn(r0, r1);
  }
}

cudaError_t launch_ln_rows(const bf16* x, const bf16* scale, const bf16* bias, const bf16* pos,
                           bf16* out, int batch, int X, int Y, int d, float scale_offset,
                           float eps, cudaStream_t stream) {
  const int rows = batch * X * Y;
  constexpr int kWarps = 8;
  const int blocks = (rows + kWarps - 1) / kWarps;
  ln_rows_kernel<<<blocks, kWarps * 32, 0, stream>>>(x, scale, bias, pos, out, rows, X, Y, d,
                                                      scale_offset, eps);
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

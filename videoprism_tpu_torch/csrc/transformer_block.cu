// K1 and K2 of videoprism_tpu/ops/pallas/transformer_block.py as chains of
// the hand-written kernels.
//
// K1 fused_attention_block (_attn_block_kernel):
//   h   = LN(x)                          ln_rows_kernel
//   qkv = (h @ Wqkv + bqkv) * [qs|1|1]   gemm_bf16_kernel, kEpiQkv
//   ctx = capped attention(qkv, mask)    capped_attention_kernel
//   out = ctx @ Wo + bo + x              gemm_bf16_kernel, kEpiResidual
// K2 fused_ffn_block (_ffn_block_kernel):
//   h   = LN(x)                          ln_rows_kernel
//   a   = act(h @ W1 + b1) * keep        gemm_bf16_kernel, kEpiActKeep
//   out = (a @ W2 + b2) * keep + x       gemm_bf16_kernel, kEpiResidual
//
// The TPU kernel keeps a whole sequence in VMEM through the half-layer.
// On Hopper one block cannot hold the half-layer's weights (4.7 MB / 9.4 MB
// at the base width against 227 KB of shared memory), so the half-layer is
// split where its values are rounded to bf16 anyway (h, q|k|v, ctx, a):
// materialising them in device memory changes no rounding.  The caller
// allocates those intermediates and passes them in.
#include "common.cuh"

extern "C" {

int vp_attention_block(const void* x, const void* mask, const void* ln_scale,
                       const void* ln_bias, const void* wqkv, const void* bqkv, const void* wo,
                       const void* bo, void* h, void* qkv, void* ctx, void* out, int batch, int t,
                       int d, int num_heads, int head_dim, int mask_b, int mask_t,
                       float logit_cap, float epsilon, float query_scale, void* stream) {
  using vp::bf16;
  auto s = static_cast<cudaStream_t>(stream);
  const int rows = batch * t, nh = num_heads * head_dim;
  cudaError_t err = vp::launch_ln_rows(static_cast<const bf16*>(x),
                                       static_cast<const bf16*>(ln_scale),
                                       static_cast<const bf16*>(ln_bias), nullptr,
                                       static_cast<bf16*>(h), rows, 1, 1, d, 1.f, epsilon, s);
  if (err != cudaSuccess) return err;
  err = vp::launch_gemm_bf16(static_cast<const bf16*>(h), static_cast<const bf16*>(wqkv),
                             static_cast<const bf16*>(bqkv), nullptr, nullptr,
                             static_cast<bf16*>(qkv), rows, 3 * nh, d, vp::kEpiQkv,
                             vp::kActNone, query_scale, nh, s);
  if (err != cudaSuccess) return err;
  err = vp::launch_capped_attention(static_cast<const bf16*>(qkv), static_cast<const float*>(mask),
                                    static_cast<bf16*>(ctx), batch, t, num_heads, head_dim,
                                    mask_b, mask_t, logit_cap, s);
  if (err != cudaSuccess) return err;
  return vp::launch_gemm_bf16(static_cast<const bf16*>(ctx), static_cast<const bf16*>(wo),
                              static_cast<const bf16*>(bo), nullptr, static_cast<const bf16*>(x),
                              static_cast<bf16*>(out), rows, d, nh, vp::kEpiResidual,
                              vp::kActNone, 1.f, 0, s);
}

int vp_ffn_block(const void* x, const void* pads, const void* ln_scale, const void* ln_bias,
                 const void* w1, const void* b1, const void* w2, const void* b2, void* h, void* a,
                 void* out, int rows, int d, int f, int activation, float epsilon,
                 void* stream) {
  using vp::bf16;
  auto s = static_cast<cudaStream_t>(stream);
  const bf16* p = static_cast<const bf16*>(pads);
  cudaError_t err = vp::launch_ln_rows(static_cast<const bf16*>(x),
                                       static_cast<const bf16*>(ln_scale),
                                       static_cast<const bf16*>(ln_bias), nullptr,
                                       static_cast<bf16*>(h), rows, 1, 1, d, 1.f, epsilon, s);
  if (err != cudaSuccess) return err;
  err = vp::launch_gemm_bf16(static_cast<const bf16*>(h), static_cast<const bf16*>(w1),
                             static_cast<const bf16*>(b1), p, nullptr, static_cast<bf16*>(a),
                             rows, f, d, vp::kEpiActKeep, activation, 1.f, 0, s);
  if (err != cudaSuccess) return err;
  return vp::launch_gemm_bf16(static_cast<const bf16*>(a), static_cast<const bf16*>(w2),
                              static_cast<const bf16*>(b2), p, static_cast<const bf16*>(x),
                              static_cast<bf16*>(out), rows, d, f, vp::kEpiResidual,
                              vp::kActNone, 1.f, 0, s);
}

}  // extern "C"

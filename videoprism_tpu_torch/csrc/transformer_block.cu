// K1, K2, K8a and K8b of videoprism_tpu/ops/pallas/transformer_block.py as
// chains of the hand-written kernels.
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
//
// K8a fused_attention_block_chunked (_attn_chunk_kernel, one pallas_call
// per head group) and K8b fused_ffn_block_chunked (_ffn_chunk_kernel, one
// per F-slice) chain the TPU kernel over `chunks` slices whose weights fit
// VMEM, each chunk's output cast to bf16 and used as the next chunk's
// residual.  LN, the q|k|v columns of a head group, the per-head attention
// and the F-slice of the hidden activation are the same bits as in the
// monolithic kernel, so only the last product differs: it is split into
// `chunks` K-slices with a cast after each,
//   out_0 = cast(a_0 @ W_0 + bias [* keep] + x),
//   out_c = cast(a_c @ W_c [* keep] + out_{c-1}),
// which one launch of the GEMM's kEpiChain computes (gemm_bf16.cu): each
// output tile walks all the slices, its running output held in registers
// and cast at every slice boundary, so K8a and K8b launch as many device
// kernels as K1 and K2 (four and three).  K1 and K2 are the one-chunk
// case of the same entry points (kEpiResidual).
#include "common.cuh"

using vp::bf16;

namespace {

// The last product over a[rows, k_total] (row pitch lda) and w[k_total, d]
// in `chunks` K-slices chained as above, into out.
cudaError_t residual_chain(const bf16* a, int lda, const bf16* w, const bf16* bias,
                           const bf16* pads, const bf16* x, bf16* out, int rows, int d,
                           int k_total, int chunks, cudaStream_t s) {
  return vp::launch_gemm_bf16(a, w, bias, pads, x, out, rows, d, k_total, lda,
                              chunks > 1 ? vp::kEpiChain : vp::kEpiResidual, vp::kActNone, 1.f, 0,
                              chunks, s);
}

}  // namespace

extern "C" {

// K1 (chunks = 1) and K8a.
int vp_attention_block(const void* x, const void* mask, const void* ln_scale,
                       const void* ln_bias, const void* wqkv, const void* bqkv, const void* wo,
                       const void* bo, void* h, void* qkv, void* ctx, void* out,
                       int batch, int t, int d, int num_heads, int head_dim, int mask_b,
                       int mask_t, int chunks, float logit_cap, float epsilon, float query_scale,
                       void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const int rows = batch * t, nh = num_heads * head_dim;
  cudaError_t err = vp::launch_ln_rows(static_cast<const bf16*>(x),
                                       static_cast<const bf16*>(ln_scale),
                                       static_cast<const bf16*>(ln_bias), nullptr,
                                       static_cast<bf16*>(h), rows, 1, 1, d, 1.f, epsilon, s);
  if (err != cudaSuccess) return err;
  err = vp::launch_gemm_bf16(static_cast<const bf16*>(h), static_cast<const bf16*>(wqkv),
                             static_cast<const bf16*>(bqkv), nullptr, nullptr,
                             static_cast<bf16*>(qkv), rows, 3 * nh, d, d, vp::kEpiQkv,
                             vp::kActNone, query_scale, nh, 1, s);
  if (err != cudaSuccess) return err;
  err = vp::launch_capped_attention(static_cast<const bf16*>(qkv), static_cast<const float*>(mask),
                                    static_cast<bf16*>(ctx), batch, t, num_heads, head_dim,
                                    mask_b, mask_t, logit_cap, s);
  if (err != cudaSuccess) return err;
  return residual_chain(static_cast<const bf16*>(ctx), nh, static_cast<const bf16*>(wo),
                        static_cast<const bf16*>(bo), nullptr, static_cast<const bf16*>(x),
                        static_cast<bf16*>(out), rows, d, nh, chunks, s);
}

// K2 (chunks = 1) and K8b.
int vp_ffn_block(const void* x, const void* pads, const void* ln_scale, const void* ln_bias,
                 const void* w1, const void* b1, const void* w2, const void* b2, void* h, void* a,
                 void* out, int rows, int d, int f, int chunks, int activation,
                 float epsilon, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const bf16* p = static_cast<const bf16*>(pads);
  cudaError_t err = vp::launch_ln_rows(static_cast<const bf16*>(x),
                                       static_cast<const bf16*>(ln_scale),
                                       static_cast<const bf16*>(ln_bias), nullptr,
                                       static_cast<bf16*>(h), rows, 1, 1, d, 1.f, epsilon, s);
  if (err != cudaSuccess) return err;
  err = vp::launch_gemm_bf16(static_cast<const bf16*>(h), static_cast<const bf16*>(w1),
                             static_cast<const bf16*>(b1), p, nullptr, static_cast<bf16*>(a),
                             rows, f, d, d, vp::kEpiActKeep, activation, 1.f, 0, 1, s);
  if (err != cudaSuccess) return err;
  return residual_chain(static_cast<const bf16*>(a), f, static_cast<const bf16*>(w2),
                        static_cast<const bf16*>(b2), p, static_cast<const bf16*>(x),
                        static_cast<bf16*>(out), rows, d, f, chunks, s);
}

}  // extern "C"

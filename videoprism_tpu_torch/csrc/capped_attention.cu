// Soft-capped softmax attention core of the fused attention block.
//
// Replaces _heads_attention inside K1 (_attn_block_kernel,
// videoprism_tpu/ops/pallas/transformer_block.py): per head, fp32 logits of
// the pre-scaled q against k, cap * tanh(logits / cap), select-mask against
// -0.7 * f32max * 0.5, exp, fp32 normalisation (fully-masked rows uniform
// 1/S), probs cast to bf16, probs @ v with fp32 accumulation, cast.  The op
// order is the TPU kernel's (normalise, cast, then P @ V); there is no
// online-softmax rescaling, which would round differently.  With a cap the
// logits are bounded by |cap| so no row max is taken; without one the row
// max is subtracted as on the TPU.
//
// Bound: at the base model's shapes (S = 256 or 16, H = 64) the two
// products are small (2*S*H FLOPs per logit) and the per-logit tanh/exp
// weigh as much as the tensor-core work; q, k, v and ctx cross device memory
// once.  What limits the kernel is latency: each warp walks its rows through
// dependent shared-memory, special-function and reduction steps, so it needs
// many warps per SM to hide them.
// Design: one block per (sequence, head, tile of up to 128 queries), one
// warp per 16 query rows, K and V of the head resident in shared memory.
// The TPU kernel holds a [T, S] fp32 logit block in VMEM; here a warp never
// holds more than one 16x16 logit tile: it walks the keys 16 at a time in
// two passes (three without a cap), recomputing each tile with nvcuda::wmma
// bf16 fragments.  Pass one sums exp(capped logits) per row; pass two
// recomputes them, normalises, casts the 16x16 probs tile to bf16 and
// multiplies it into the ctx accumulators at once.  Recomputation gives
// bit-identical logits, and the small footprint (~104 KB at S = 256, 8 KB at
// S = 16) lets 16 to 32 warps share an SM.  S and T need not be multiples
// of 16: tails are zero-filled and left out of the softmax, so T = S = 16
// (the temporal stack) runs unpacked and any frame count runs too.
#include <mma.h>

#include "common.cuh"

namespace vp {
namespace {

using namespace nvcuda;

constexpr int kMaxSmem = 232448;  // 227 KB per block on sm_90
constexpr int kMaxWarps = 8;

struct AttnLayout {
  int qt, sp, hl;
  size_t k, v, q, stage, probs, total;
};

// Shared memory: K and V [sp, hl], the q tile [qt, hl] (bf16; head dim
// zero-padded to a multiple of 16, rows padded by 16 bytes), and per warp a
// 16x16 fp32 stage and a 16x16 bf16 probs tile.
__host__ __device__ inline AttnLayout attn_layout(int T, int H, int warps) {
  AttnLayout L;
  L.qt = 16 * warps;
  L.sp = (T + 15) / 16 * 16;
  L.hl = (H + 15) / 16 * 16 + 8;
  L.k = 0;
  L.v = L.k + sizeof(bf16) * L.sp * L.hl;
  L.q = L.v + sizeof(bf16) * L.sp * L.hl;
  L.stage = L.q + sizeof(bf16) * L.qt * L.hl;
  L.probs = L.stage + sizeof(float) * warps * 256;
  L.total = L.probs + sizeof(bf16) * warps * 256;
  return L;
}

// Warps per block: enough for T query rows, at most 8, within 227 KB.
inline int attn_warps(int T, int H) {
  int w = (T + 15) / 16;
  w = w < kMaxWarps ? w : kMaxWarps;
  for (; w >= 1; --w)
    if (attn_layout(T, H, w).total <= static_cast<size_t>(kMaxSmem)) return w;
  return 0;
}

// HT = head dim / 16 (rounded up), a template constant so that the ctx
// accumulators stay in registers.
template <int HT>
__global__ void capped_attention_kernel(const bf16* __restrict__ qkv,
                                        const float* __restrict__ mask,
                                        bf16* __restrict__ ctx, int T, int num_heads, int H,
                                        int mask_b, int mask_t, float cap, float inv_cap) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warps = blockDim.x / 32;
  const AttnLayout L = attn_layout(T, H, warps);
  const bf16* Ks = reinterpret_cast<const bf16*>(smem + L.k);
  const bf16* Vs = reinterpret_cast<const bf16*>(smem + L.v);

  const int b = blockIdx.x, n = blockIdx.y, q0 = blockIdx.z * L.qt;
  const int nh = num_heads * H;
  const size_t row_pitch = 3 * static_cast<size_t>(nh);
  const bf16* base = qkv + static_cast<size_t>(b) * T * row_pitch + n * H;
  const int chunks = 2 * HT;  // 16-byte chunks per padded head row
  const uint4 zero = make_uint4(0, 0, 0, 0);
  {
    bf16* kw = reinterpret_cast<bf16*>(smem + L.k);
    bf16* vw = reinterpret_cast<bf16*>(smem + L.v);
    bf16* qw = reinterpret_cast<bf16*>(smem + L.q);
    for (int i = threadIdx.x; i < L.sp * chunks; i += blockDim.x) {
      const int s = i / chunks, c = (i % chunks) * 8;
      const bool ok = s < T && c < H;
      const bf16* src = base + s * row_pitch + c;
      *reinterpret_cast<uint4*>(kw + s * L.hl + c) =
          ok ? *reinterpret_cast<const uint4*>(src + nh) : zero;
      *reinterpret_cast<uint4*>(vw + s * L.hl + c) =
          ok ? *reinterpret_cast<const uint4*>(src + 2 * nh) : zero;
    }
    for (int i = threadIdx.x; i < L.qt * chunks; i += blockDim.x) {
      const int r = i / chunks, c = (i % chunks) * 8;
      const bool ok = q0 + r < T && c < H;
      *reinterpret_cast<uint4*>(qw + r * L.hl + c) =
          ok ? *reinterpret_cast<const uint4*>(base + (q0 + r) * row_pitch + c) : zero;
    }
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = q0 + warp * 16;
  if (row0 >= T) return;  // no block-wide barrier follows
  const bf16* Qw = reinterpret_cast<const bf16*>(smem + L.q) + warp * 16 * L.hl;
  float* stage = reinterpret_cast<float*>(smem + L.stage) + warp * 256;
  bf16* probs = reinterpret_cast<bf16*>(smem + L.probs) + warp * 256;

  // This lane's share of every 16x16 tile: 8 columns of one row.
  const int r = lane / 2, c0 = (lane % 2) * 8;
  const int t = row0 + r;
  const float* mrow = mask + static_cast<size_t>(mask_b > 1 ? b : 0) * mask_t * T +
                      static_cast<size_t>(mask_t > 1 && t < T ? t : 0) * T;

  // Logits of key tile j into `stage` (row-major 16x16); the caller syncs.
  auto logit_tile = [&](int j) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < HT; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
      wmma::load_matrix_sync(fa, Qw + kk * 16, L.hl);
      wmma::load_matrix_sync(fb, Ks + j * 16 * L.hl + kk * 16, L.hl);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(stage, acc, 16, wmma::mem_row_major);
    __syncwarp();
  };
  // Unnormalised weight of logit l at key s (kNegInf-masked with no cap).
  auto weight = [&](float l, int s, float mx) {
    const bool ok = mrow[s] >= kMaskThreshold;
    if (cap > 0.f) return ok ? expf(cap * tanhf(l * inv_cap)) : 0.f;
    return expf((ok ? l : kNegInf) - mx);
  };

  const int tiles = L.sp / 16;
  float mx = 0.f;
  if (cap <= 0.f) {  // row max, as the TPU kernel takes it without a cap
    float m = -FLT_MAX;
    for (int j = 0; j < tiles; ++j) {
      logit_tile(j);
      for (int e = 0; e < 8; ++e) {
        const int s = j * 16 + c0 + e;
        if (s < T) m = fmaxf(m, mrow[s] >= kMaskThreshold ? stage[r * 16 + c0 + e] : kNegInf);
      }
      __syncwarp();
    }
    mx = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
  }
  float sum = 0.f;
  for (int j = 0; j < tiles; ++j) {
    logit_tile(j);
    for (int e = 0; e < 8; ++e) {
      const int s = j * 16 + c0 + e;
      if (s < T) sum += weight(stage[r * 16 + c0 + e], s, mx);
    }
    __syncwarp();
  }
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  const bool uniform = sum == 0.f;  // fully masked row (capped path)

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> out[HT];
#pragma unroll
  for (int hj = 0; hj < HT; ++hj) wmma::fill_fragment(out[hj], 0.f);
  for (int j = 0; j < tiles; ++j) {
    logit_tile(j);
    for (int e = 0; e < 8; ++e) {
      const int s = j * 16 + c0 + e;
      float p = 0.f;
      if (s < T && t < T)
        p = uniform ? 1.f / static_cast<float>(T) : weight(stage[r * 16 + c0 + e], s, mx) / sum;
      probs[r * 16 + c0 + e] = __float2bfloat16(p);
    }
    __syncwarp();
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fp;
    wmma::load_matrix_sync(fp, probs, 16);
#pragma unroll
    for (int hj = 0; hj < HT; ++hj) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fv;
      wmma::load_matrix_sync(fv, Vs + j * 16 * L.hl + hj * 16, L.hl);
      wmma::mma_sync(out[hj], fp, fv, out[hj]);
    }
    __syncwarp();
  }

#pragma unroll
  for (int hj = 0; hj < HT; ++hj) {
    wmma::store_matrix_sync(stage, out[hj], 16, wmma::mem_row_major);
    __syncwarp();
    if (t < T && hj * 16 + c0 < H)
      *reinterpret_cast<uint4*>(ctx + (static_cast<size_t>(b) * T + t) * nh + n * H + hj * 16 +
                                c0) = pack8(stage + r * 16 + c0);
    __syncwarp();
  }
}

}  // namespace

template <int HT>
cudaError_t launch(const bf16* qkv, const float* mask, bf16* ctx, int batch, int T,
                   int num_heads, int H, int mask_b, int mask_t, float cap, int warps,
                   size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(capped_attention_kernel<HT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid(batch, num_heads, (T + 16 * warps - 1) / (16 * warps));
  const float inv_cap = cap > 0.f ? static_cast<float>(1.0 / cap) : 0.f;
  capped_attention_kernel<HT><<<grid, warps * 32, smem, stream>>>(
      qkv, mask, ctx, T, num_heads, H, mask_b, mask_t, cap, inv_cap);
  return cudaGetLastError();
}

size_t capped_attention_smem_bytes(int T, int H) {
  if (H % 8 != 0 || H > 128) return 0;
  const int w = attn_warps(T, H);
  return w ? attn_layout(T, H, w).total : 0;
}

// The longest sequence the kernel holds at head dim H: the last T (a
// multiple of 16, since K and V rows are padded to 16) whose one-warp
// layout fits; 0 when H is not taken at all.
int capped_attention_max_t(int H) {
  if (H % 8 != 0 || H > 128) return 0;
  int t = 0;
  while (attn_layout(t + 16, H, 1).total <= static_cast<size_t>(kMaxSmem)) t += 16;
  return t;
}

cudaError_t launch_capped_attention(const bf16* qkv, const float* mask, bf16* ctx, int batch,
                                    int T, int num_heads, int head_dim, int mask_b, int mask_t,
                                    float logit_cap, cudaStream_t stream) {
  const size_t smem = capped_attention_smem_bytes(T, head_dim);
  if (smem == 0) return cudaErrorInvalidValue;
  const int warps = attn_warps(T, head_dim);
#define VP_ATTN_CASE(ht)                                                                    \
  case ht:                                                                                  \
    return launch<ht>(qkv, mask, ctx, batch, T, num_heads, head_dim, mask_b, mask_t,       \
                      logit_cap, warps, smem, stream);
  switch ((head_dim + 15) / 16) {
    VP_ATTN_CASE(1) VP_ATTN_CASE(2) VP_ATTN_CASE(3) VP_ATTN_CASE(4)
    VP_ATTN_CASE(5) VP_ATTN_CASE(6) VP_ATTN_CASE(7) VP_ATTN_CASE(8)
    default: return cudaErrorInvalidValue;
  }
#undef VP_ATTN_CASE
}

}  // namespace vp

extern "C" int vp_attention_max_t(int head_dim) {
  return vp::capped_attention_max_t(head_dim);
}

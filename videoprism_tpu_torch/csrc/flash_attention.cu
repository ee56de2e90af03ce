// K5: head-major soft-capped softmax attention over long key sequences.
//
// Replaces fused_attention (_attention_kernel) in
// videoprism_tpu/ops/pallas/flash_attention.py: q, k, v [B, N, T|S, H] bf16,
// an additive fp32 mask [B|1, T|1, S]; fp32 logits, cap * tanh(l / cap)
// before the select-mask against -0.7 * f32max * 0.5, exp with masked
// entries zeroed, fp32 normalisation (fully masked rows uniform 1/S; the
// row max is taken only without a cap), probs cast to bf16, probs @ v with
// fp32 accumulation, one cast.  Out [B, N, T, H] bf16.
//
// Bound: at the auxiliary encoder's shape ([B, 12, 4096, 64], S = 4096)
// the two products are 4*T*S*H FLOPs per head against 2*T*H + 2*S*H bytes
// of q, k, v and out, far above the card's ~295 FLOPs per byte, so the
// tensor cores bound it on paper; in practice the per-logit tanh and exp,
// paid again in every pass, set its time, not the products.
// Design: the TPU kernel keeps a head's whole K and V (1 MB at S = 4096) in
// VMEM and the [T, S] fp32 logit block with them.  A Hopper block has
// 227 KB, and online-softmax rescaling (FlashAttention proper) would round
// differently from the TPU kernel's exact softmax.  So this kernel keeps
// the TPU op order and streams instead: one block per (query tile of 128
// rows, head, batch), one warp per 16 query rows, q held in registers, K
// and V tiles of 64 keys streamed through a two-stage cp.async ring.  Pass
// one sums the exponentials of each row, pass two recomputes each logit
// tile (the same mma.sync instructions on the same inputs give
// bit-identical logits), normalises, casts and multiplies it into the
// output accumulators at once; a pass zero takes the row max when there is
// no cap.  Logits live in mma.sync m16n8k16 accumulators and become the
// A operand of the P @ V product in registers, so nothing of the [T, S]
// block touches shared or device memory.  Ragged T and S are zero-filled
// and left out of the softmax.
#include "mma_sync.cuh"

namespace vp {
namespace {

constexpr int kWarps = 8;
constexpr int kBlockM = 16 * kWarps;  // query rows per block
constexpr int kBlockN = 64;           // keys per streamed tile

template <int HT>
constexpr size_t flash_smem_bytes() {
  return sizeof(bf16) * (16 * HT + 8) * (kBlockM + 4 * kBlockN);
}

// HT = H / 16.  Shared memory: the q tile [kBlockM, LD], then two stages
// each of K and V [kBlockN, LD] (LD = H + 8 bf16: rows 16-byte aligned and
// ldmatrix free of bank conflicts).
//
// Fragment layouts: mma_sync.cuh.  Logits of a 16 x 64 tile stay in
// mma.sync accumulators and become the A operand of the P @ V product.
template <int HT>
__global__ void __launch_bounds__(kWarps * 32)
    flash_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, const float* __restrict__ mask,
                           bf16* __restrict__ out, int N, int T, int S, int mask_b, int mask_t,
                           float cap, float inv_cap) {
  constexpr int H = 16 * HT;
  constexpr int LD = H + 8;
  constexpr int CH = H / 8;  // 16-byte chunks per row
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + kBlockM * LD;
  bf16* Vs = Ks + 2 * kBlockN * LD;

  const int q0 = blockIdx.x * kBlockM, n = blockIdx.y, b = blockIdx.z;
  const size_t head = static_cast<size_t>(b) * N + n;
  const bf16* qh = q + head * T * H;
  const bf16* kh = k + head * S * H;
  const bf16* vh = v + head * S * H;
  bf16* oh = out + head * T * H;
  const int tid = threadIdx.x;

  for (int i = tid; i < kBlockM * CH; i += blockDim.x) {
    const int r = i / CH, c = (i % CH) * 8;
    const bool ok = q0 + r < T;
    cp_async16(Qs + r * LD + c, qh + static_cast<size_t>(ok ? q0 + r : 0) * H + c, ok);
  }
  cp_async_commit();

  auto load_tile = [&](int tile, int stage, bool with_v) {
    const int s0 = tile * kBlockN;
    for (int i = tid; i < kBlockN * CH; i += blockDim.x) {
      const int r = i / CH, c = (i % CH) * 8;
      const bool ok = s0 + r < S;
      const size_t src = static_cast<size_t>(ok ? s0 + r : 0) * H + c;
      cp_async16(Ks + (stage * kBlockN + r) * LD + c, kh + src, ok);
      if (with_v) cp_async16(Vs + (stage * kBlockN + r) * LD + c, vh + src, ok);
    }
    cp_async_commit();
  };
  const int tiles = (S + kBlockN - 1) / kBlockN;
  // Streams every key tile through the two stages and calls body(tile,
  // stage) on each in order, the next tile's copy in flight meanwhile.
  auto stream = [&](bool with_v, auto&& body) {
    load_tile(0, 0, with_v);
    for (int j = 0; j < tiles; ++j) {
      if (j + 1 < tiles) {
        load_tile(j + 1, (j + 1) & 1, with_v);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      body(j, j & 1);
      __syncthreads();  // the stage is refilled by the next iteration
    }
  };

  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c2 = 2 * (lane % 4);
  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;
  const float* mbase = mask + static_cast<size_t>(mask_b > 1 ? b : 0) * mask_t * S;
  const float* mrow[2] = {
      mbase + static_cast<size_t>(mask_t > 1 ? min(row0, T - 1) : 0) * S,
      mbase + static_cast<size_t>(mask_t > 1 ? min(row1, T - 1) : 0) * S};

  cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[HT][4];
  load_rows<HT>(qf, Qs + warp * 16 * LD, LD, lane);

  float sc[8][4];  // logits of one 16 x 64 tile
  auto logits = [&](int stage) {
    tile_logits<HT>(sc, qf, Ks + stage * kBlockN * LD, LD, lane);
  };
  // Unnormalised weight of logit l at key s of row half h (kNegInf-masked
  // with no cap, relative to the row max mx).
  auto weight = [&](float l, int s, int h, float mx) {
    const bool ok = __ldg(mrow[h] + s) >= kMaskThreshold;
    if (cap > 0.f) return ok ? expf(cap * tanhf(l * inv_cap)) : 0.f;
    return expf((ok ? l : kNegInf) - mx);
  };

  float mx[2] = {0.f, 0.f};
  if (cap <= 0.f) {  // row max, as the TPU kernel takes it without a cap
    float m[2] = {-FLT_MAX, -FLT_MAX};
    stream(false, [&](int j, int stage) {
      logits(stage);
#pragma unroll
      for (int jn = 0; jn < 8; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int s = j * kBlockN + jn * 8 + c2 + (e & 1), h = e >> 1;
          if (s < S)
            m[h] = fmaxf(m[h], __ldg(mrow[h] + s) >= kMaskThreshold ? sc[jn][e] : kNegInf);
        }
    });
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m[h] = fmaxf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 1));
      mx[h] = fmaxf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 2));
    }
  }

  float sum[2] = {0.f, 0.f};
  stream(false, [&](int j, int stage) {
    logits(stage);
#pragma unroll
    for (int jn = 0; jn < 8; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int s = j * kBlockN + jn * 8 + c2 + (e & 1), h = e >> 1;
        if (s < S) sum[h] += weight(sc[jn][e], s, h, mx[h]);
      }
  });
  bool uniform[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
    uniform[h] = sum[h] == 0.f;  // fully masked row (capped path)
  }
  const float inv_s = 1.f / static_cast<float>(S);

  float acc[2 * HT][4];
#pragma unroll
  for (int i = 0; i < 2 * HT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  stream(true, [&](int j, int stage) {
    logits(stage);
    const bf16* vb = Vs + stage * kBlockN * LD;
#pragma unroll
    for (int p = 0; p < 4; ++p) {  // 16 keys: n-tiles 2p and 2p + 1
      float pr[2][4];
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int jn = 2 * p + half;
          const int s = j * kBlockN + jn * 8 + c2 + (e & 1), h = e >> 1;
          float w = 0.f;
          if (s < S) w = uniform[h] ? inv_s : weight(sc[jn][e], s, h, mx[h]) / sum[h];
          pr[half][e] = w;
        }
      const uint32_t a[4] = {pack_bf16x2(pr[0][0], pr[0][1]), pack_bf16x2(pr[0][2], pr[0][3]),
                             pack_bf16x2(pr[1][0], pr[1][1]), pack_bf16x2(pr[1][2], pr[1][3])};
#pragma unroll
      for (int hp = 0; hp < HT; ++hp) {
        uint32_t vf[4];
        const int m = lane / 8;
        ldsm_x4_trans(vf, vb + (p * 16 + lane % 8 + 8 * (m & 1)) * LD + hp * 16 + 8 * (m >> 1));
        mma16816(acc[2 * hp], a, vf[0], vf[1]);
        mma16816(acc[2 * hp + 1], a, vf[2], vf[3]);
      }
    }
  });
  store_rows<HT>(oh, acc, row0, T, lane);
}

template <int HT>
cudaError_t launch_flash(const bf16* q, const bf16* k, const bf16* v, const float* mask,
                         bf16* out, int batch, int heads, int T, int S, int mask_b, int mask_t,
                         float cap, cudaStream_t stream) {
  constexpr size_t smem = flash_smem_bytes<HT>();
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<HT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((T + kBlockM - 1) / kBlockM, heads, batch);
  const float inv_cap = cap > 0.f ? static_cast<float>(1.0 / cap) : 0.f;
  flash_attention_kernel<HT><<<grid, kWarps * 32, smem, stream>>>(
      q, k, v, mask, out, heads, T, S, mask_b, mask_t, cap, inv_cap);
  return cudaGetLastError();
}

}  // namespace
}  // namespace vp

extern "C" {

// K5: q [b, heads, t, h], k and v [b, heads, s, h], mask [mask_b, mask_t,
// s] -> out [b, heads, t, h].  head_dim must be a multiple of 16, at most
// 128.
int vp_flash_attention(const void* q, const void* k, const void* v, const void* mask, void* out,
                       int batch, int heads, int t, int s, int head_dim, int mask_b, int mask_t,
                       float logit_cap, void* stream) {
  using vp::bf16;
  const auto* qp = static_cast<const bf16*>(q);
  const auto* kp = static_cast<const bf16*>(k);
  const auto* vp_ = static_cast<const bf16*>(v);
  const auto* mp = static_cast<const float*>(mask);
  auto* op = static_cast<bf16*>(out);
  auto st = static_cast<cudaStream_t>(stream);
#define VP_FLASH_CASE(ht)                                                                    \
  case 16 * ht:                                                                              \
    return vp::launch_flash<ht>(qp, kp, vp_, mp, op, batch, heads, t, s, mask_b, mask_t,    \
                                logit_cap, st);
  switch (head_dim) {
    VP_FLASH_CASE(1) VP_FLASH_CASE(2) VP_FLASH_CASE(3) VP_FLASH_CASE(4)
    VP_FLASH_CASE(5) VP_FLASH_CASE(6) VP_FLASH_CASE(7) VP_FLASH_CASE(8)
    default: return cudaErrorInvalidValue;
  }
#undef VP_FLASH_CASE
}

}  // extern "C"

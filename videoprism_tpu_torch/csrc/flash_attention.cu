// K5: head-major soft-capped softmax attention over long key sequences.
//
// Replaces fused_attention (_attention_kernel) in
// videoprism_tpu/ops/pallas/flash_attention.py: q, k, v [B, N, T|S, H] bf16,
// an additive fp32 mask [B|1, T|1, S]; fp32 logits, cap * tanh(l / cap)
// before the select-mask against -0.7 * f32max * 0.5, exp with masked
// entries zeroed, fp32 normalisation (fully masked rows uniform 1/S; the
// row max is taken only without a cap), probs cast to bf16 after the
// normalisation, probs @ v with fp32 accumulation, one cast.  Out [B, N, T,
// H] bf16.  Optionally (under autograd) each row's max and sum, for K7.
//
// Bound: at the auxiliary encoder's shape ([B, 12, 4096, 64], S = 4096)
// the two products the work needs (Q K^T and P @ V, 4 T S H FLOPs) are far
// above the card's ~295 FLOPs per byte of q, k, v and out, so the bound is
// the tensor cores' time for them (cases.bound: bytes and tensor-core
// operations, nothing else).  Beyond it the kernel recomputes the logits
// in every pass (two with a cap, three without) and pays each logit's
// weight in each pass: three special-function operations (mma_sync.cuh
// logit_weight), which the bound does not count.
// Design: the TPU kernel keeps a head's whole K and V (1 MB at S = 4096) in
// VMEM and the [T, S] fp32 logit block with them.  A Hopper block has
// 227 KB, and online-softmax rescaling (FlashAttention proper) or a final
// normalisation would round bf16 probabilities differently from the TPU
// kernel's exact softmax.  So this kernel keeps the TPU op order and
// streams instead: one block per (query tile of 128 rows, head, batch), one
// warp per 16 query rows (q in shared memory, its fragments read per key
// tile, so that two blocks fit an SM), K and V tiles of 64 keys streamed
// through a two-stage cp.async ring.  Pass one sums the weights of each row
// (per lane over the 64-key tiles in order, then two shuffles: K7's order,
// so K7 given these sums computes what it would compute itself), pass two
// recomputes each logit tile, in two halves of 32 keys that leave the
// registers to the output accumulators (tile_logits: the same mma.sync
// instructions on the same inputs give bit-identical logits), normalises
// by the row's reciprocal, casts and multiplies 16 keys at a time into the
// output; a pass zero takes the row max when there is no cap.  The cap is
// a template constant, so each loop holds one formula;
// the mask is one 64-bit word per tile and row half (two ballots of values
// fetched a tile ahead where one mask row serves every query, the
// auxiliary encoder's case), and ragged key tiles skip their dead 8-key
// n-tiles by a warp-uniform test, so no loop branches per logit.  Logits
// live in mma.sync m16n8k16 accumulators and become the A operand of the P
// @ V product in registers, so nothing of the [T, S] block touches shared
// or device memory.  The head dim is zero-padded to a multiple of 16
// inside (giant's 88 runs as 96); ragged T and S are zero-filled and left
// out of the softmax.
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

// HT = H / 16 rounded up.  Shared memory: the q tile [kBlockM, LD], then
// two stages each of K and V [kBlockN, LD] (LD = 16 * HT + 8 bf16: rows
// 16-byte aligned and ldmatrix free of bank conflicts).  `stats`, when not
// null, gets [2][B * N][t_pad] fp32: each row's max (0 under a cap) and sum
// of weights, rows up to t_pad (kStatRows) written.
//
// Fragment layouts: mma_sync.cuh.  Logits of a 16 x 64 tile stay in
// mma.sync accumulators and become the A operand of the P @ V product.
template <int HT, bool kCapped>
__global__ void __launch_bounds__(kWarps * 32, HT <= 4 ? 2 : 1)
    flash_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, const float* __restrict__ mask,
                           bf16* __restrict__ out, float* __restrict__ stats, int N, int T,
                           int S, int H, int mask_b, int mask_t, CapConsts cc) {
  constexpr int LD = 16 * HT + 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + kBlockM * LD;
  bf16* Vs = Ks + 2 * kBlockN * LD;

  const int q0 = blockIdx.x * kBlockM, n = blockIdx.y, b = blockIdx.z;
  const size_t head = static_cast<size_t>(b) * N + n;
  const bf16* kh = k + head * S * H;
  const bf16* vh = v + head * S * H;
  const int tid = threadIdx.x, threads = kWarps * 32;

  copy_rows<HT>(Qs, q + head * T * H, q0, kBlockM, T, H, tid, threads);
  cp_async_commit();

  const int warp = tid / 32, lane = tid % 32;
  const int row0 = q0 + warp * 16 + lane / 4;  // this thread's rows: row0, row0 + 8
  KeyTileMask mask_words(mask, b, mask_b, mask_t, T, S, row0, lane);

  auto load_tile = [&](int tile, int stage, bool with_v) {
    copy_rows<HT>(Ks + stage * kBlockN * LD, kh, tile * kBlockN, kBlockN, S, H, tid, threads);
    if (with_v)
      copy_rows<HT>(Vs + stage * kBlockN * LD, vh, tile * kBlockN, kBlockN, S, H, tid, threads);
    cp_async_commit();
  };
  const int tiles = (S + kBlockN - 1) / kBlockN;
  // Streams every key tile through the two stages and calls body(stage,
  // bits, live) on each in order, the next tile's copy (and mask) in
  // flight meanwhile; `live` counts the n-tiles holding keys below S.
  auto stream = [&](bool with_v, auto&& body) {
    load_tile(0, 0, with_v);
    mask_words.fetch(0);
    for (int j = 0; j < tiles; ++j) {
      const float mcur[2] = {mask_words.next[0], mask_words.next[1]};
      if (j + 1 < tiles) {
        load_tile(j + 1, (j + 1) & 1, with_v);
        mask_words.fetch(j + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      uint64_t bits[2];
      mask_words.words(j, mcur, bits);
      body(j & 1, bits, min(8, (S - j * kBlockN + 7) / 8));
      __syncthreads();  // the stage is refilled by the next iteration
    }
  };

  cp_async_wait<0>();
  __syncthreads();

  // Logits of one 16 x 64 tile; q's fragments are read from shared memory
  // for each tile, not held across it, which leaves two blocks an SM.
  float sc[8][4];
  auto logits = [&](int stage) {
    uint32_t qf[HT][4];
    load_rows<HT>(qf, Qs + warp * 16 * LD, LD, lane);
    tile_logits<HT>(sc, qf, Ks + stage * kBlockN * LD, LD, lane);
  };

  float mx[2] = {0.f, 0.f};
  if constexpr (!kCapped) {  // row max, as the TPU kernel takes it without a cap
    float m[2] = {-FLT_MAX, -FLT_MAX};
    stream(false, [&](int stage, const uint64_t (&bits)[2], int live) {
      logits(stage);
#pragma unroll
      for (int jn = 0; jn < 8; ++jn) {
        if (jn >= live) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          m[e >> 1] = fmaxf(m[e >> 1], mask_bit(bits[e >> 1], jn, e) ? sc[jn][e] : -FLT_MAX);
      }
    });
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m[h] = fmaxf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 1));
      mx[h] = fmaxf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 2));
    }
  }

  // Pass one: the row sums, in K7's order.
  float sum[2] = {0.f, 0.f};
  stream(false, [&](int stage, const uint64_t (&bits)[2], int live) {
    logits(stage);
#pragma unroll
    for (int jn = 0; jn < 8; ++jn) {
      if (jn >= live) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float r;
        const float w = logit_weight<kCapped>(sc[jn][e], mx[e >> 1], cc, r);
        sum[e >> 1] += mask_bit(bits[e >> 1], jn, e) ? w : 0.f;
      }
    }
  });
  RowScale rs[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
    rs[h] = row_scale(sum[h], S);
  }
  if (stats != nullptr && lane % 4 == 0) {
    const int tp = (T + kStatRows - 1) / kStatRows * kStatRows;
    const size_t plane = static_cast<size_t>(gridDim.y) * gridDim.z * tp;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + 8 * h;
      if (r < tp) {
        stats[head * tp + r] = mx[h];
        stats[plane + head * tp + r] = sum[h];
      }
    }
  }

  // Pass two: the same weights, normalised, cast and multiplied into the
  // output.
  float acc[2 * HT][4];
#pragma unroll
  for (int i = 0; i < 2 * HT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  // Each tile's logits in two halves of 32 keys (the same bits as whole:
  // tile_logits), which keeps the registers of a half-tile of logits free
  // beside the output accumulators.
  stream(true, [&](int stage, const uint64_t (&bits)[2], int live) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float lh[4][4];
      {
        uint32_t qf[HT][4];
        load_rows<HT>(qf, Qs + warp * 16 * LD, LD, lane);
        tile_logits<HT, 4>(lh, qf, Ks + (stage * kBlockN + 32 * half) * LD, LD, lane);
      }
#pragma unroll
      for (int p = 0; p < 2; ++p) {  // 16 keys at a time
        float pr[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int jn = 4 * half + 2 * p + i;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int h = e >> 1;
            float w = 0.f;
            if (jn < live) {
              float r;
              w = logit_weight<kCapped>(lh[2 * p + i][e], mx[h], cc, r);
              w = mask_bit(bits[h], jn, e) ? w : 0.f;
            }
            pr[i][e] = normalise(w, rs[h]);
          }
        }
        uint32_t a[4];
        pack_block(a, pr[0], pr[1]);
        mma_rows<HT>(acc, a, Vs + stage * kBlockN * LD, LD, 2 * half + p, lane);
      }
    }
  });
  store_rows<HT>(out + head * T * H, acc, row0, T, H, lane);
}

template <int HT, bool kCapped>
cudaError_t launch_flash(const bf16* q, const bf16* k, const bf16* v, const float* mask,
                         bf16* out, float* stats, int batch, int heads, int T, int S, int H,
                         int mask_b, int mask_t, float cap, cudaStream_t stream) {
  constexpr size_t smem = flash_smem_bytes<HT>();
  cudaError_t err = set_max_dynamic_smem<flash_attention_kernel<HT, kCapped>>(smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + kBlockM - 1) / kBlockM, heads, batch);
  flash_attention_kernel<HT, kCapped><<<grid, kWarps * 32, smem, stream>>>(
      q, k, v, mask, out, stats, heads, T, S, H, mask_b, mask_t, cap_consts(cap));
  return cudaGetLastError();
}

}  // namespace
}  // namespace vp

extern "C" {

// K5: q [b, heads, t, h], k and v [b, heads, s, h], mask [mask_b, mask_t,
// s] -> out [b, heads, t, h], and (stats not null) each row's max and sum
// of weights into stats [2][b * heads][t rounded up to 64].  head_dim must
// be a multiple of 8, at most 128 (zero-padded to a multiple of 16 inside).
int vp_flash_attention(const void* q, const void* k, const void* v, const void* mask, void* out,
                       void* stats, int batch, int heads, int t, int s, int head_dim,
                       int mask_b, int mask_t, float logit_cap, void* stream) {
  using vp::bf16;
  const auto* qp = static_cast<const bf16*>(q);
  const auto* kp = static_cast<const bf16*>(k);
  const auto* vp_ = static_cast<const bf16*>(v);
  const auto* mp = static_cast<const float*>(mask);
  auto* op = static_cast<bf16*>(out);
  auto* sp = static_cast<float*>(stats);
  auto st = static_cast<cudaStream_t>(stream);
  if (t <= 0 || s <= 0 || head_dim <= 0 || head_dim % 8) return cudaErrorInvalidValue;
#define VP_FLASH_CASE(ht)                                                                     \
  case ht:                                                                                    \
    return logit_cap > 0.f                                                                    \
               ? vp::launch_flash<ht, true>(qp, kp, vp_, mp, op, sp, batch, heads, t, s,      \
                                            head_dim, mask_b, mask_t, logit_cap, st)          \
               : vp::launch_flash<ht, false>(qp, kp, vp_, mp, op, sp, batch, heads, t, s,     \
                                             head_dim, mask_b, mask_t, logit_cap, st);
  switch ((head_dim + 15) / 16) {
    VP_FLASH_CASE(1) VP_FLASH_CASE(2) VP_FLASH_CASE(3) VP_FLASH_CASE(4)
    VP_FLASH_CASE(5) VP_FLASH_CASE(6) VP_FLASH_CASE(7) VP_FLASH_CASE(8)
    default: return cudaErrorInvalidValue;
  }
#undef VP_FLASH_CASE
}

// The capped weight of mma_sync.cuh on n logits l (fp32), as every kernel
// computes it at this cap (> 0): w = exp(cap tanh(l / cap)) and dt = 1 -
// tanh(l / cap)^2; the check of the helper's accuracy.
int vp_capped_weight(const void* l, void* w, void* dt, int n, float logit_cap, void* stream);

}  // extern "C"

namespace vp {
namespace {

__global__ void capped_weight_kernel(const float* __restrict__ l, float* __restrict__ w,
                                     float* __restrict__ dt, int n, CapConsts cc) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float r;
  w[i] = logit_weight<true>(l[i], 0.f, cc, r);
  dt[i] = tanh_grad(r);
}

}  // namespace
}  // namespace vp

extern "C" int vp_capped_weight(const void* l, void* w, void* dt, int n, float logit_cap,
                                void* stream) {
  if (n <= 0 || !(logit_cap > 0.f)) return cudaErrorInvalidValue;
  vp::capped_weight_kernel<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(l), static_cast<float*>(w), static_cast<float*>(dt), n,
      vp::cap_consts(logit_cap));
  return cudaGetLastError();
}

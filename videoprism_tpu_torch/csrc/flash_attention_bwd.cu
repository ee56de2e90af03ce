// K7: the backward of K5, soft-capped softmax attention over long keys.
//
// Replaces fused_attention_bwd (_attention_bwd_kernel) in
// videoprism_tpu/ops/pallas/flash_attention.py: from q, k, v [B, N, T|S, H]
// bf16, the additive fp32 mask [B|1, T|1, S] and the output cotangent dO
// [B, N, T, H] bf16 it gives dq, dk, dv (and, with ctx, the forward's
// context probs @ v) without the [T, S] probabilities ever reaching device
// memory.  The arithmetic is the TPU kernel's: fp32 logits, cap * tanh(l /
// cap) before the select-mask, exp with masked entries zeroed, fully masked
// rows uniform 1/S (the row max only without a cap); probs cast to bf16
// before P @ V (ctx) and P^T @ dO (dv); dP = dO @ V^T and row_dot =
// sum_s dP * P in fp32; dl = P * (dP - row_dot), zeroed where masked, times
// 1 - tanh^2 under a cap, cast to bf16 before dl @ K (dq) and dl^T @ Q
// (dk); dk and dv summed in fp32 over all T and cast once.  A fully masked
// row still feeds dv through its uniform probs; its dl is zero.
//
// Bound: at the auxiliary encoder's shape ([B, 12, 4096, 64]) the five
// products (six with ctx) are far above the card's ~295 FLOPs per byte, so
// on paper the tensor cores bound it; as in K5, the per-logit tanh and exp,
// paid again in every pass, set its time.
// Design: the TPU kernel keeps a head's whole K and V in VMEM, walks the
// query blocks in order and carries dk and dv in scratch from one grid
// step to the next.  Hopper blocks run in no order, so the work is split
// in two kernels that each own their outputs:
//  * query-major (one block per 64-query tile, head and batch; a warp per
//    16 rows, q and dO in registers, K and V tiles of 64 keys streamed
//    through a two-stage cp.async ring as in K5): a pass for the row max
//    (no cap only), one for the row sum of the exponentials (the
//    statistics), one for row_dot = sum_s P * dP, and one that forms P and
//    dl per tile and multiplies them into ctx and dq.  It also writes each
//    row's max, sum and row_dot (fp32) to a scratch buffer.
//  * key-major (one block per 64-key tile, head and batch; a warp per 16
//    keys, k and v in registers, q and dO tiles of 64 queries and their
//    rows' statistics streamed): per tile it recomputes the transposed
//    logits K Q^T and dP^T = V dO^T, forms P^T and dl^T from the saved
//    statistics and adds them into dv and dk, held in fp32 registers for
//    the whole sweep.
// Every logit goes through mma_sync.cuh's tile_logits, the instructions K5
// uses, and every weight through K5's expressions, so the query-major
// kernel's probabilities are the forward's.  Ragged T and S are
// zero-filled and left out of the softmax.
#include "mma_sync.cuh"

namespace vp {
namespace {

constexpr int kWarps = 4;
constexpr int kTile = 16 * kWarps;  // rows per block and per streamed tile (64)

// Row statistics of the query-major kernel, [3][B * N][t_pad] fp32 with
// t_pad = T rounded up to kTile: the row max (0 with a cap), the row sum
// (0 for a fully masked capped row, whose probs are uniform) and row_dot.
__device__ __forceinline__ int padded_rows(int T) { return (T + kTile - 1) / kTile * kTile; }

template <int HT>
constexpr size_t bwd_smem_bytes() {
  // Two [kTile, LD] tiles held for the block, two stages of two streamed
  // [kTile, LD] tiles, and two stages of three statistics per row.
  return sizeof(bf16) * (16 * HT + 8) * (6 * kTile) + sizeof(float) * 2 * 3 * kTile;
}

// Unnormalised weight of logit l (K5's expressions) and, under a cap, the
// tanh it passed through (for the 1 - tanh^2 factor).
__device__ __forceinline__ float weight(float l, bool ok, float mx, float cap, float inv_cap,
                                        float& th) {
  if (cap > 0.f) {
    th = tanhf(l * inv_cap);
    return ok ? expf(cap * th) : 0.f;
  }
  th = 0.f;
  return expf((ok ? l : kNegInf) - mx);
}

// Copies rows [r0, r0 + kTile) of a [rows, H] bf16 matrix into a [kTile,
// LD] shared tile, zero-filling rows at or past `rows`.
template <int HT>
__device__ __forceinline__ void copy_tile(bf16* dst, const bf16* src, int r0, int rows, int tid,
                                          int threads) {
  constexpr int H = 16 * HT, LD = H + 8, CH = H / 8;
  for (int i = tid; i < kTile * CH; i += threads) {
    const int r = i / CH, c = (i % CH) * 8;
    const bool ok = r0 + r < rows;
    cp_async16(dst + r * LD + c, src + static_cast<size_t>(ok ? r0 + r : 0) * H + c, ok);
  }
}

template <int HT>
__device__ __forceinline__ void zero_acc(float (&acc)[2 * HT][4]) {
#pragma unroll
  for (int i = 0; i < 2 * HT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
}

template <int HT>
__global__ void __launch_bounds__(kWarps * 32)
    flash_bwd_query_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, const float* __restrict__ mask,
                           const bf16* __restrict__ dout, bf16* __restrict__ ctx,
                           bf16* __restrict__ dq, float* __restrict__ stats, int N, int T,
                           int S, int mask_b, int mask_t, float cap, float inv_cap) {
  constexpr int H = 16 * HT;
  constexpr int LD = H + 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ds = Qs + kTile * LD;
  bf16* Ks = Ds + kTile * LD;
  bf16* Vs = Ks + 2 * kTile * LD;

  const int q0 = blockIdx.x * kTile, n = blockIdx.y, b = blockIdx.z;
  const size_t head = static_cast<size_t>(b) * N + n;
  const bf16* kh = k + head * S * H;
  const bf16* vh = v + head * S * H;
  const int tid = threadIdx.x, threads = blockDim.x;

  copy_tile<HT>(Qs, q + head * T * H, q0, T, tid, threads);
  copy_tile<HT>(Ds, dout + head * T * H, q0, T, tid, threads);
  cp_async_commit();

  const int tiles = (S + kTile - 1) / kTile;
  auto load_tile = [&](int tile, int stage, bool with_v) {
    copy_tile<HT>(Ks + stage * kTile * LD, kh, tile * kTile, S, tid, threads);
    if (with_v) copy_tile<HT>(Vs + stage * kTile * LD, vh, tile * kTile, S, tid, threads);
    cp_async_commit();
  };
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
  const int row0 = q0 + warp * 16 + g;
  const float* mbase = mask + static_cast<size_t>(mask_b > 1 ? b : 0) * mask_t * S;
  const float* mrow[2] = {
      mbase + static_cast<size_t>(mask_t > 1 ? min(row0, T - 1) : 0) * S,
      mbase + static_cast<size_t>(mask_t > 1 ? min(row0 + 8, T - 1) : 0) * S};
  auto unmasked = [&](int s, int h) { return __ldg(mrow[h] + s) >= kMaskThreshold; };

  cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[HT][4], df[HT][4];
  load_rows<HT>(qf, Qs + warp * 16 * LD, LD, lane);
  load_rows<HT>(df, Ds + warp * 16 * LD, LD, lane);

  float sc[8][4], dp[8][4];
  float mx[2] = {0.f, 0.f};
  if (cap <= 0.f) {  // row max over the unmasked logits, as K5 takes it
    float m[2] = {-FLT_MAX, -FLT_MAX};
    stream(false, [&](int j, int stage) {
      tile_logits<HT>(sc, qf, Ks + stage * kTile * LD, LD, lane);
#pragma unroll
      for (int jn = 0; jn < 8; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int s = j * kTile + jn * 8 + c2 + (e & 1), h = e >> 1;
          if (s < S) m[h] = fmaxf(m[h], unmasked(s, h) ? sc[jn][e] : kNegInf);
        }
    });
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m[h] = fmaxf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 1));
      mx[h] = fmaxf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 2));
    }
  }

  // The row sums, as K5 takes them.
  float sum[2] = {0.f, 0.f};
  stream(false, [&](int j, int stage) {
    tile_logits<HT>(sc, qf, Ks + stage * kTile * LD, LD, lane);
#pragma unroll
    for (int jn = 0; jn < 8; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int s = j * kTile + jn * 8 + c2 + (e & 1), h = e >> 1;
        float th;
        if (s < S) sum[h] += weight(sc[jn][e], unmasked(s, h), mx[h], cap, inv_cap, th);
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
  // P of logit l in row half h, as K5 forms it; th gets its tanh.
  auto prob = [&](float l, int h, bool ok, float& th) {
    const float w = weight(l, ok, mx[h], cap, inv_cap, th);
    return uniform[h] ? inv_s : w / sum[h];
  };

  // row_dot = sum_s P * dP in fp32.
  float rd[2] = {0.f, 0.f};
  stream(true, [&](int j, int stage) {
    tile_logits<HT>(sc, qf, Ks + stage * kTile * LD, LD, lane);
    tile_logits<HT>(dp, df, Vs + stage * kTile * LD, LD, lane);
#pragma unroll
    for (int jn = 0; jn < 8; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int s = j * kTile + jn * 8 + c2 + (e & 1), h = e >> 1;
        float th;
        if (s < S) rd[h] += prob(sc[jn][e], h, unmasked(s, h), th) * dp[jn][e];
      }
  });
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    rd[h] += __shfl_xor_sync(0xffffffffu, rd[h], 1);
    rd[h] += __shfl_xor_sync(0xffffffffu, rd[h], 2);
  }
  if (lane % 4 == 0) {
    const int tp = padded_rows(T);
    float* st = stats + head * tp;
    const size_t plane = static_cast<size_t>(gridDim.y) * gridDim.z * tp;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + 8 * h;  // < tp always; rows past T are zero q
      st[r] = mx[h];
      st[plane + r] = sum[h];
      st[2 * plane + r] = rd[h];
    }
  }

  float acc_dq[2 * HT][4], acc_ctx[2 * HT][4];
  zero_acc<HT>(acc_dq);
  zero_acc<HT>(acc_ctx);
  stream(true, [&](int j, int stage) {
    const bf16* kb = Ks + stage * kTile * LD;
    const bf16* vb = Vs + stage * kTile * LD;
    tile_logits<HT>(sc, qf, kb, LD, lane);
    tile_logits<HT>(dp, df, vb, LD, lane);
#pragma unroll
    for (int jn = 0; jn < 8; ++jn)  // probs into sc, dl into dp
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int s = j * kTile + jn * 8 + c2 + (e & 1), h = e >> 1;
        float p = 0.f, dl = 0.f;
        if (s < S) {
          const bool ok = unmasked(s, h);
          float th;
          p = prob(sc[jn][e], h, ok, th);
          if (ok) dl = p * (dp[jn][e] - rd[h]) * (cap > 0.f ? 1.f - th * th : 1.f);
        }
        sc[jn][e] = p;
        dp[jn][e] = dl;
      }
    if (ctx != nullptr) mma_block_tile<HT>(acc_ctx, sc, vb, LD, lane);
    mma_block_tile<HT>(acc_dq, dp, kb, LD, lane);
  });
  store_rows<HT>(dq + head * T * H, acc_dq, row0, T, lane);
  if (ctx != nullptr) store_rows<HT>(ctx + head * T * H, acc_ctx, row0, T, lane);
}

template <int HT>
__global__ void __launch_bounds__(kWarps * 32)
    flash_bwd_key_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const float* __restrict__ mask,
                         const bf16* __restrict__ dout, const float* __restrict__ stats,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, int N, int T, int S,
                         int mask_b, int mask_t, float cap, float inv_cap) {
  constexpr int H = 16 * HT;
  constexpr int LD = H + 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + kTile * LD;
  bf16* Qs = Vs + kTile * LD;
  bf16* Ds = Qs + 2 * kTile * LD;
  float* Ss = reinterpret_cast<float*>(Ds + 2 * kTile * LD);  // [2][3][kTile]

  const int s0 = blockIdx.x * kTile, n = blockIdx.y, b = blockIdx.z;
  const size_t head = static_cast<size_t>(b) * N + n;
  const bf16* qh = q + head * T * H;
  const bf16* dh = dout + head * T * H;
  const int tp = padded_rows(T);
  const float* st = stats + head * tp;
  const size_t plane = static_cast<size_t>(gridDim.y) * gridDim.z * tp;
  const int tid = threadIdx.x, threads = blockDim.x;

  copy_tile<HT>(Ks, k + head * S * H, s0, S, tid, threads);
  copy_tile<HT>(Vs, v + head * S * H, s0, S, tid, threads);
  cp_async_commit();

  const int tiles = tp / kTile;
  auto load_tile = [&](int tile, int stage) {
    const int t0 = tile * kTile;
    copy_tile<HT>(Qs + stage * kTile * LD, qh, t0, T, tid, threads);
    copy_tile<HT>(Ds + stage * kTile * LD, dh, t0, T, tid, threads);
    for (int i = tid; i < 3 * kTile / 4; i += threads) {  // 16-byte chunks
      const int which = i / (kTile / 4), c = (i % (kTile / 4)) * 4;
      cp_async16(Ss + (stage * 3 + which) * kTile + c, st + which * plane + t0 + c, true);
    }
    cp_async_commit();
  };

  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c2 = 2 * (lane % 4);
  const int key0 = s0 + warp * 16 + g;  // this thread's keys: key0, key0 + 8
  const float* mbase = mask + static_cast<size_t>(mask_b > 1 ? b : 0) * mask_t * S;

  cp_async_wait<0>();
  __syncthreads();
  uint32_t kf[HT][4], vf[HT][4];
  load_rows<HT>(kf, Ks + warp * 16 * LD, LD, lane);
  load_rows<HT>(vf, Vs + warp * 16 * LD, LD, lane);

  const float inv_s = 1.f / static_cast<float>(S);
  float sc[8][4], dp[8][4];
  float acc_dk[2 * HT][4], acc_dv[2 * HT][4];
  zero_acc<HT>(acc_dk);
  zero_acc<HT>(acc_dv);
  load_tile(0, 0);
  for (int j = 0; j < tiles; ++j) {
    if (j + 1 < tiles) {
      load_tile(j + 1, (j + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int stage = j & 1;
    const bf16* qb = Qs + stage * kTile * LD;
    const bf16* db = Ds + stage * kTile * LD;
    const float* sb = Ss + stage * 3 * kTile;
    tile_logits<HT>(sc, kf, qb, LD, lane);  // logits^T: rows keys, columns queries
    tile_logits<HT>(dp, vf, db, LD, lane);  // dP^T
#pragma unroll
    for (int jn = 0; jn < 8; ++jn)  // P^T into sc, dl^T into dp
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int tl = jn * 8 + c2 + (e & 1), t = j * kTile + tl, s = key0 + 8 * (e >> 1);
        float p = 0.f, dl = 0.f;
        if (t < T && s < S) {
          const float* mrow = mbase + static_cast<size_t>(mask_t > 1 ? t : 0) * S;
          const bool ok = __ldg(mrow + s) >= kMaskThreshold;
          const float sum = sb[kTile + tl];
          float th;
          const float w = weight(sc[jn][e], ok, sb[tl], cap, inv_cap, th);
          p = sum == 0.f ? inv_s : w / sum;
          if (ok) dl = p * (dp[jn][e] - sb[2 * kTile + tl]) * (cap > 0.f ? 1.f - th * th : 1.f);
        }
        sc[jn][e] = p;
        dp[jn][e] = dl;
      }
    mma_block_tile<HT>(acc_dv, sc, db, LD, lane);
    mma_block_tile<HT>(acc_dk, dp, qb, LD, lane);
    __syncthreads();  // the stage is refilled by the next iteration
  }
  store_rows<HT>(dk + head * S * H, acc_dk, key0, S, lane);
  store_rows<HT>(dv + head * S * H, acc_dv, key0, S, lane);
}

template <int HT>
cudaError_t launch_flash_bwd(const bf16* q, const bf16* k, const bf16* v, const float* mask,
                             const bf16* dout, bf16* ctx, bf16* dq, bf16* dk, bf16* dv,
                             float* stats, int batch, int heads, int T, int S, int mask_b,
                             int mask_t, float cap, cudaStream_t stream) {
  constexpr size_t smem = bwd_smem_bytes<HT>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_query_kernel<HT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_key_kernel<HT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const float inv_cap = cap > 0.f ? static_cast<float>(1.0 / cap) : 0.f;
  const dim3 qgrid((T + kTile - 1) / kTile, heads, batch);
  flash_bwd_query_kernel<HT><<<qgrid, kWarps * 32, smem, stream>>>(
      q, k, v, mask, dout, ctx, dq, stats, heads, T, S, mask_b, mask_t, cap, inv_cap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 kgrid((S + kTile - 1) / kTile, heads, batch);
  flash_bwd_key_kernel<HT><<<kgrid, kWarps * 32, smem, stream>>>(
      q, k, v, mask, dout, stats, dk, dv, heads, T, S, mask_b, mask_t, cap, inv_cap);
  return cudaGetLastError();
}

}  // namespace
}  // namespace vp

extern "C" {

// K7: q and dout [b, heads, t, h], k and v [b, heads, s, h], mask [mask_b,
// mask_t, s] -> ctx (when not null) and dq [b, heads, t, h], dk and dv [b,
// heads, s, h]; stats is fp32 scratch of 3 * b * heads * t_pad floats (t
// rounded up to 64).  head_dim must be a multiple of 16, at most 64.
int vp_flash_attention_bwd(const void* q, const void* k, const void* v, const void* mask,
                           const void* dout, void* ctx, void* dq, void* dk, void* dv,
                           void* stats, int batch, int heads, int t, int s, int head_dim,
                           int mask_b, int mask_t, float logit_cap, void* stream) {
  using vp::bf16;
  const auto* qp = static_cast<const bf16*>(q);
  const auto* kp = static_cast<const bf16*>(k);
  const auto* vp_ = static_cast<const bf16*>(v);
  const auto* mp = static_cast<const float*>(mask);
  const auto* dp = static_cast<const bf16*>(dout);
  auto* cp = static_cast<bf16*>(ctx);
  auto* dqp = static_cast<bf16*>(dq);
  auto* dkp = static_cast<bf16*>(dk);
  auto* dvp = static_cast<bf16*>(dv);
  auto* sp = static_cast<float*>(stats);
  auto st = static_cast<cudaStream_t>(stream);
#define VP_FLASH_BWD_CASE(ht)                                                                \
  case 16 * ht:                                                                              \
    return vp::launch_flash_bwd<ht>(qp, kp, vp_, mp, dp, cp, dqp, dkp, dvp, sp, batch,      \
                                    heads, t, s, mask_b, mask_t, logit_cap, st);
  switch (head_dim) {
    VP_FLASH_BWD_CASE(1) VP_FLASH_BWD_CASE(2) VP_FLASH_BWD_CASE(3) VP_FLASH_BWD_CASE(4)
    default: return cudaErrorInvalidValue;
  }
#undef VP_FLASH_BWD_CASE
}

}  // extern "C"

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
// products the work needs (the logits, dP, dq, dk and dv; ctx a sixth) are
// far above the card's ~295 FLOPs per byte, so the bound is the tensor
// cores' time for them (cases.flash_backward_bound: bytes and tensor-core
// operations, nothing else).  Beyond it the kernels recompute the logits
// and dP in every sweep (given K5's statistics: three times each, nine
// products in all; computing them, one or two logit sweeps more) and pay
// each logit's weight in each sweep: three special-function operations
// (mma_sync.cuh logit_weight), which the bound does not count.
// Design: the TPU kernel keeps a head's whole K and V in VMEM, walks the
// query blocks in order and carries dk and dv in scratch from one grid
// step to the next.  Hopper blocks run in no order, so the work is split
// in two kernels that each own their outputs:
//  * query-major (one block per 64-query tile, head and batch; a warp per
//    16 rows, q and dO in shared memory, their fragments read per key tile;
//    K and V tiles of 64 keys streamed through a two-stage cp.async ring as
//    in K5): given K5's row statistics (`in_stats`, each row's max and sum,
//    written by the forward under autograd) it sweeps the keys twice: once
//    for row_dot = sum_s P * dP, once to form P and dl per tile and multiply
//    them into ctx and dq.  Without them (K1's and K8a's backward, with ctx)
//    it first takes the max (no cap only) and the sum itself, in K5's order
//    (per lane over the 64-key tiles, then two shuffles), so both routes
//    give the same bits.  It writes each row's max, sum, reciprocal and
//    row_dot (fp32) to a scratch buffer.
//  * key-major (one block per 64-key tile, head and batch; a warp per 16
//    keys, k and v in shared memory, their fragments read per query tile,
//    so the fp32 dk and dv accumulators keep the registers; q and dO tiles
//    of 64 queries and their rows' statistics streamed): per tile it
//    recomputes the transposed logits K Q^T and dP^T = V dO^T, forms P^T
//    and dl^T from the saved statistics and adds them into dv and dk.
// Every logit goes through mma_sync.cuh's tile_logits, the instructions K5
// uses, and every weight through its logit_weight, so the query-major
// kernel's probabilities are the forward's.  The cap is a template
// constant and the mask a 64-bit word per tile and row half, as in K5.
// The head dim is zero-padded to a multiple of 16 inside (giant's 88 runs
// as 96); ragged T and S are zero-filled and left out of the softmax.
#include "mma_sync.cuh"

namespace vp {
namespace {

constexpr int kWarps = 4;
constexpr int kTile = 16 * kWarps;  // rows per block and per streamed tile (64)
static_assert(kTile == kStatRows, "K5's statistics are laid out for K7's query tile");
// Planes of the scratch statistics, [kPlanes][B * N][t_pad] fp32 (t_pad =
// T rounded up to kTile; rows past T hold finite values of zero q rows).
constexpr int kPlanes = 4;
enum Plane : int { kMax = 0, kSum = 1, kScale = 2, kRowDot = 3 };

__device__ __forceinline__ int padded_rows(int T) { return (T + kTile - 1) / kTile * kTile; }

template <int HT>
constexpr size_t bwd_smem_bytes() {
  // Two [kTile, LD] tiles held for the block, two stages of two streamed
  // [kTile, LD] tiles, and two stages of the statistics of kTile rows.
  return sizeof(bf16) * (16 * HT + 8) * (6 * kTile) + sizeof(float) * 2 * kPlanes * kTile;
}

template <int HT>
__device__ __forceinline__ void zero_acc(float (&acc)[2 * HT][4]) {
#pragma unroll
  for (int i = 0; i < 2 * HT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
}

// Two blocks an SM: with the block size alone as its bound, ptxas trades
// a few spilled bytes for a third (168 registers) at some head dims.
template <int HT, bool kCapped>
__global__ void __launch_bounds__(kWarps * 32, 2)
    flash_bwd_query_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, const float* __restrict__ mask,
                           const bf16* __restrict__ dout, const float* __restrict__ in_stats,
                           bf16* __restrict__ ctx, bf16* __restrict__ dq,
                           float* __restrict__ stats, int N, int T, int S, int H, int mask_b,
                           int mask_t, CapConsts cc) {
  constexpr int LD = 16 * HT + 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ds = Qs + kTile * LD;
  bf16* Ks = Ds + kTile * LD;
  bf16* Vs = Ks + 2 * kTile * LD;

  const int q0 = blockIdx.x * kTile, n = blockIdx.y, b = blockIdx.z;
  const size_t head = static_cast<size_t>(b) * N + n;
  const bf16* kh = k + head * S * H;
  const bf16* vh = v + head * S * H;
  const int tid = threadIdx.x, threads = kWarps * 32;

  copy_rows<HT>(Qs, q + head * T * H, q0, kTile, T, H, tid, threads);
  copy_rows<HT>(Ds, dout + head * T * H, q0, kTile, T, H, tid, threads);
  cp_async_commit();

  const int warp = tid / 32, lane = tid % 32;
  const int row0 = q0 + warp * 16 + lane / 4;  // this thread's rows: row0, row0 + 8
  KeyTileMask mask_words(mask, b, mask_b, mask_t, T, S, row0, lane);

  const int tiles = (S + kTile - 1) / kTile;
  auto load_tile = [&](int tile, int stage, bool with_v) {
    copy_rows<HT>(Ks + stage * kTile * LD, kh, tile * kTile, kTile, S, H, tid, threads);
    if (with_v) copy_rows<HT>(Vs + stage * kTile * LD, vh, tile * kTile, kTile, S, H, tid, threads);
    cp_async_commit();
  };
  // body(stage, bits, live) on every key tile in order, as K5's stream.
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
      body(j & 1, bits, min(8, (S - j * kTile + 7) / 8));
      __syncthreads();  // the stage is refilled by the next iteration
    }
  };

  cp_async_wait<0>();
  __syncthreads();
  const bf16* qrows = Qs + warp * 16 * LD;
  const bf16* drows = Ds + warp * 16 * LD;
  float sc[8][4], dp[8][4];
  // Logits (and dP) of the key tile in `stage`; the q and dO fragments are
  // read from shared memory for each tile, not held across it.
  auto logits = [&](int stage) {
    uint32_t af[HT][4];
    load_rows<HT>(af, qrows, LD, lane);
    tile_logits<HT>(sc, af, Ks + stage * kTile * LD, LD, lane);
  };
  auto dprobs = [&](int stage) {
    uint32_t af[HT][4];
    load_rows<HT>(af, drows, LD, lane);
    tile_logits<HT>(dp, af, Vs + stage * kTile * LD, LD, lane);
  };

  const int tp = padded_rows(T);
  const size_t plane = static_cast<size_t>(gridDim.y) * gridDim.z * tp;
  float mx[2] = {0.f, 0.f}, sum[2] = {0.f, 0.f};
  if (in_stats != nullptr) {  // K5's, for these rows
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = in_stats[head * tp + row0 + 8 * h];
      sum[h] = in_stats[plane + head * tp + row0 + 8 * h];
    }
  } else {
    if constexpr (!kCapped) {  // row max over the unmasked logits, as K5 takes it
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
    // The row sums, as K5 takes them.
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
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
    }
  }
  const RowScale rs[2] = {row_scale(sum[0], S), row_scale(sum[1], S)};

  // row_dot = sum_s P * dP in fp32.
  float rd[2] = {0.f, 0.f};
  stream(true, [&](int stage, const uint64_t (&bits)[2], int live) {
    logits(stage);
    dprobs(stage);
#pragma unroll
    for (int jn = 0; jn < 8; ++jn) {
      if (jn >= live) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        float r;
        const float w = logit_weight<kCapped>(sc[jn][e], mx[h], cc, r);
        const float p = normalise(mask_bit(bits[h], jn, e) ? w : 0.f, rs[h]);
        rd[h] = fmaf(p, dp[jn][e], rd[h]);
      }
    }
  });
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    rd[h] += __shfl_xor_sync(0xffffffffu, rd[h], 1);
    rd[h] += __shfl_xor_sync(0xffffffffu, rd[h], 2);
  }
  if (lane % 4 == 0) {
    float* st = stats + head * tp;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + 8 * h;  // < tp always; rows past T are zero q
      st[kMax * plane + r] = mx[h];
      st[kSum * plane + r] = rs[h].sum;
      st[kScale * plane + r] = rs[h].scale;
      st[kRowDot * plane + r] = rd[h];
    }
  }

  float acc_dq[2 * HT][4], acc_ctx[2 * HT][4];
  zero_acc<HT>(acc_dq);
  if (ctx != nullptr) zero_acc<HT>(acc_ctx);
  // Each tile in two halves of 32 keys (the same bits as whole:
  // tile_logits), which keeps the registers of a half-tile of logits and dP
  // free beside the dq and ctx accumulators.
  stream(true, [&](int stage, const uint64_t (&bits)[2], int live) {
    const bf16* kb = Ks + stage * kTile * LD;
    const bf16* vb = Vs + stage * kTile * LD;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float lh[4][4], dh[4][4];
      {
        uint32_t af[HT][4];
        load_rows<HT>(af, qrows, LD, lane);
        tile_logits<HT, 4>(lh, af, kb + 32 * half * LD, LD, lane);
        load_rows<HT>(af, drows, LD, lane);
        tile_logits<HT, 4>(dh, af, vb + 32 * half * LD, LD, lane);
      }
#pragma unroll
      for (int p = 0; p < 2; ++p) {  // 16 keys at a time
        float pr[2][4], dl[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int jn = 4 * half + 2 * p + i;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int h = e >> 1;
            pr[i][e] = rs[h].shift;
            dl[i][e] = 0.f;
            if (jn < live) {
              float r;
              const float w = logit_weight<kCapped>(lh[2 * p + i][e], mx[h], cc, r);
              const bool ok = mask_bit(bits[h], jn, e);
              pr[i][e] = normalise(ok ? w : 0.f, rs[h]);
              float d = pr[i][e] * (dh[2 * p + i][e] - rd[h]);
              if constexpr (kCapped) d *= tanh_grad(r);
              dl[i][e] = ok ? d : 0.f;
            }
          }
        }
        uint32_t a[4];
        if (ctx != nullptr) {
          pack_block(a, pr[0], pr[1]);
          mma_rows<HT>(acc_ctx, a, vb, LD, 2 * half + p, lane);
        }
        pack_block(a, dl[0], dl[1]);
        mma_rows<HT>(acc_dq, a, kb, LD, 2 * half + p, lane);
      }
    }
  });
  store_rows<HT>(dq + head * T * H, acc_dq, row0, T, H, lane);
  if (ctx != nullptr) store_rows<HT>(ctx + head * T * H, acc_ctx, row0, T, H, lane);
}

template <int HT, bool kCapped>
__global__ void __launch_bounds__(kWarps * 32)
    flash_bwd_key_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const float* __restrict__ mask,
                         const bf16* __restrict__ dout, const float* __restrict__ stats,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, int N, int T, int S,
                         int H, int mask_b, int mask_t, CapConsts cc) {
  constexpr int LD = 16 * HT + 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + kTile * LD;
  bf16* Qs = Vs + kTile * LD;
  bf16* Ds = Qs + 2 * kTile * LD;
  float* Ss = reinterpret_cast<float*>(Ds + 2 * kTile * LD);  // [2][kPlanes][kTile]

  const int s0 = blockIdx.x * kTile, n = blockIdx.y, b = blockIdx.z;
  const size_t head = static_cast<size_t>(b) * N + n;
  const bf16* qh = q + head * T * H;
  const bf16* dh = dout + head * T * H;
  const int tp = padded_rows(T);
  const float* st = stats + head * tp;
  const size_t plane = static_cast<size_t>(gridDim.y) * gridDim.z * tp;
  const int tid = threadIdx.x, threads = kWarps * 32;

  copy_rows<HT>(Ks, k + head * S * H, s0, kTile, S, H, tid, threads);
  copy_rows<HT>(Vs, v + head * S * H, s0, kTile, S, H, tid, threads);
  cp_async_commit();

  const int tiles = tp / kTile;
  auto load_tile = [&](int tile, int stage) {
    const int t0 = tile * kTile;
    copy_rows<HT>(Qs + stage * kTile * LD, qh, t0, kTile, T, H, tid, threads);
    copy_rows<HT>(Ds + stage * kTile * LD, dh, t0, kTile, T, H, tid, threads);
    for (int i = tid; i < kPlanes * kTile / 4; i += threads) {  // 16-byte chunks
      const int which = i / (kTile / 4), c = (i % (kTile / 4)) * 4;
      cp_async16(Ss + (stage * kPlanes + which) * kTile + c, st + which * plane + t0 + c, true);
    }
    cp_async_commit();
  };

  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c2 = 2 * (lane % 4);
  const int key0 = s0 + warp * 16 + g;  // this thread's keys: key0, key0 + 8
  const float* mbase = mask + static_cast<size_t>(mask_b > 1 ? b : 0) * mask_t * S;
  // One mask row for every query: this thread's two keys, masked or not
  // for every query, as all-ones or zero words.
  uint64_t key_bits[2] = {0, 0};
  if (mask_t == 1) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int s = key0 + 8 * h;
      key_bits[h] = s < S && __ldg(mbase + s) >= kMaskThreshold ? ~0ull : 0ull;
    }
  }
  // The mask words of query tile j (pre-shifted by c2): per-query rows.
  auto tile_bits = [&](int j, uint64_t (&bits)[2]) {
    if (mask_t == 1) {
      bits[0] = key_bits[0];
      bits[1] = key_bits[1];
      return;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int s = key0 + 8 * h;
      uint64_t word = 0;
#pragma unroll
      for (int jn = 0; jn < 8; ++jn)
#pragma unroll
        for (int e1 = 0; e1 < 2; ++e1) {
          const int t = j * kTile + jn * 8 + c2 + e1;
          if (s < S && t < T &&
              __ldg(mbase + static_cast<size_t>(t) * S + s) >= kMaskThreshold)
            word |= 1ull << (jn * 8 + e1);
        }
      bits[h] = word;
    }
  };

  const float inv_s = 1.f / static_cast<float>(S);
  const bf16* krows = Ks + warp * 16 * LD;
  const bf16* vrows = Vs + warp * 16 * LD;
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
    const float* sb = Ss + stage * kPlanes * kTile;
    uint64_t bits[2];
    tile_bits(j, bits);
    {
      uint32_t af[HT][4];
      load_rows<HT>(af, krows, LD, lane);
      tile_logits<HT>(sc, af, qb, LD, lane);  // logits^T: rows keys, columns queries
    }
    {
      uint32_t af[HT][4];
      load_rows<HT>(af, vrows, LD, lane);
      tile_logits<HT>(dp, af, db, LD, lane);  // dP^T
    }
#pragma unroll
    for (int jn = 0; jn < 8; ++jn) {  // P^T into sc, dl^T into dp
      const int tl = jn * 8 + c2;     // this lane's queries tl, tl + 1
      const float2 mx2 = *reinterpret_cast<const float2*>(sb + kMax * kTile + tl);
      const float2 sum2 = *reinterpret_cast<const float2*>(sb + kSum * kTile + tl);
      const float2 sc2 = *reinterpret_cast<const float2*>(sb + kScale * kTile + tl);
      const float2 rd2 = *reinterpret_cast<const float2*>(sb + kRowDot * kTile + tl);
      // The query rows' normalisations (row_scale's, from the saved sum and
      // reciprocal: the reciprocal is 0 exactly where a row is fully masked).
      const RowScale rs[2] = {{sc2.x, sc2.x == 0.f ? inv_s : 0.f, sum2.x},
                              {sc2.y, sc2.y == 0.f ? inv_s : 0.f, sum2.y}};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool odd = e & 1;
        float r;
        const float w = logit_weight<kCapped>(sc[jn][e], odd ? mx2.y : mx2.x, cc, r);
        const bool ok = mask_bit(bits[e >> 1], jn, e);
        const float p = normalise(ok ? w : 0.f, rs[odd]);
        float dl = p * (dp[jn][e] - (odd ? rd2.y : rd2.x));
        if constexpr (kCapped) dl *= tanh_grad(r);
        sc[jn][e] = p;
        dp[jn][e] = ok ? dl : 0.f;
      }
    }
    mma_block_tile<HT>(acc_dv, sc, db, LD, lane);
    mma_block_tile<HT>(acc_dk, dp, qb, LD, lane);
    __syncthreads();  // the stage is refilled by the next iteration
  }
  store_rows<HT>(dk + head * S * H, acc_dk, key0, S, H, lane);
  store_rows<HT>(dv + head * S * H, acc_dv, key0, S, H, lane);
}

template <int HT, bool kCapped>
cudaError_t launch_flash_bwd(const bf16* q, const bf16* k, const bf16* v, const float* mask,
                             const bf16* dout, const float* in_stats, bf16* ctx, bf16* dq,
                             bf16* dk, bf16* dv, float* stats, int batch, int heads, int T,
                             int S, int H, int mask_b, int mask_t, float cap,
                             cudaStream_t stream) {
  constexpr size_t smem = bwd_smem_bytes<HT>();
  cudaError_t err = set_max_dynamic_smem<flash_bwd_query_kernel<HT, kCapped>>(smem);
  if (err != cudaSuccess) return err;
  err = set_max_dynamic_smem<flash_bwd_key_kernel<HT, kCapped>>(smem);
  if (err != cudaSuccess) return err;
  const CapConsts cc = cap_consts(cap);
  const dim3 qgrid((T + kTile - 1) / kTile, heads, batch);
  flash_bwd_query_kernel<HT, kCapped><<<qgrid, kWarps * 32, smem, stream>>>(
      q, k, v, mask, dout, in_stats, ctx, dq, stats, heads, T, S, H, mask_b, mask_t, cc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 kgrid((S + kTile - 1) / kTile, heads, batch);
  flash_bwd_key_kernel<HT, kCapped><<<kgrid, kWarps * 32, smem, stream>>>(
      q, k, v, mask, dout, stats, dk, dv, heads, T, S, H, mask_b, mask_t, cc);
  return cudaGetLastError();
}

}  // namespace
}  // namespace vp

extern "C" {

// K7: q and dout [b, heads, t, h], k and v [b, heads, s, h], mask [mask_b,
// mask_t, s] -> ctx (when not null) and dq [b, heads, t, h], dk and dv [b,
// heads, s, h].  in_stats, when not null, is K5's [2][b * heads][t_pad]
// (each row's max and sum of weights; t_pad = t rounded up to 64); stats is
// fp32 scratch of 4 * b * heads * t_pad floats.  head_dim must be a
// multiple of 8, at most 96 (zero-padded to a multiple of 16 inside).
int vp_flash_attention_bwd(const void* q, const void* k, const void* v, const void* mask,
                           const void* dout, const void* in_stats, void* ctx, void* dq, void* dk,
                           void* dv, void* stats, int batch, int heads, int t, int s,
                           int head_dim, int mask_b, int mask_t, float logit_cap, void* stream) {
  using vp::bf16;
  const auto* qp = static_cast<const bf16*>(q);
  const auto* kp = static_cast<const bf16*>(k);
  const auto* vp_ = static_cast<const bf16*>(v);
  const auto* mp = static_cast<const float*>(mask);
  const auto* dp = static_cast<const bf16*>(dout);
  const auto* ip = static_cast<const float*>(in_stats);
  auto* cp = static_cast<bf16*>(ctx);
  auto* dqp = static_cast<bf16*>(dq);
  auto* dkp = static_cast<bf16*>(dk);
  auto* dvp = static_cast<bf16*>(dv);
  auto* sp = static_cast<float*>(stats);
  auto st = static_cast<cudaStream_t>(stream);
  if (t <= 0 || s <= 0 || head_dim <= 0 || head_dim % 8) return cudaErrorInvalidValue;
#define VP_FLASH_BWD_CASE(ht)                                                                  \
  case ht:                                                                                     \
    return logit_cap > 0.f                                                                     \
               ? vp::launch_flash_bwd<ht, true>(qp, kp, vp_, mp, dp, ip, cp, dqp, dkp, dvp, sp, \
                                                batch, heads, t, s, head_dim, mask_b, mask_t,  \
                                                logit_cap, st)                                 \
               : vp::launch_flash_bwd<ht, false>(qp, kp, vp_, mp, dp, ip, cp, dqp, dkp, dvp,   \
                                                 sp, batch, heads, t, s, head_dim, mask_b,     \
                                                 mask_t, logit_cap, st);
  switch ((head_dim + 15) / 16) {
    VP_FLASH_BWD_CASE(1) VP_FLASH_BWD_CASE(2) VP_FLASH_BWD_CASE(3)
    VP_FLASH_BWD_CASE(4) VP_FLASH_BWD_CASE(5) VP_FLASH_BWD_CASE(6)
    default: return cudaErrorInvalidValue;
  }
#undef VP_FLASH_BWD_CASE
}

}  // extern "C"

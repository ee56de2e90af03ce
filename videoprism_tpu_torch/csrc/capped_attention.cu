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
// max is subtracted as on the TPU.  K10 and K11 (int8_blocks.cu) call the
// same core.
//
// Bound: at the base model's shapes (S = 256 or 16, H = 64) the two
// products are small (2*S*H FLOPs per logit), and the per-logit weight
// (three special-function operations, mma_sync.cuh logit_weight), which
// no bound counts, weighs as much as the tensor-core work; q, k, v and ctx
// cross device memory once.  What limits the kernel is that work per
// logit, paid in each pass, and latency, hidden by many warps per SM.
// Design: the structure of K5 (flash_attention.cu) over the fused q|k|v
// buffer.  One block of 8 warps per (sequence, head, tile of 128 queries), a
// warp per 16 query rows (q in shared memory, its fragments read per key
// tile, so that two blocks fit an SM); K and V of the head streamed in tiles
// of 64 keys through a two-stage cp.async ring, so shared memory does not
// grow with T and every T runs; the last tile of a pass prefetches the next
// pass's first.  Logits come from mma_sync.cuh's tile_logits, the instructions
// K5 and K7 use, so the probabilities are the bits K7 recomputes in K1's
// backward; the weight (logit_weight, shared with K5 and K7), the mask, the
// row sums and the normalisation (by a reciprocal of the row sum taken once
// per row) act on the mma.sync accumulator fragments where they are, and the
// bf16 probs become the A operand of P @ V in registers.  Pass one sums the
// weights of each row, pass two recomputes each logit tile (bit-identical),
// normalises, casts and multiplies; a pass zero takes the row max when there
// is no cap.  The cap is a template constant, so each loop holds one formula,
// and the mask becomes a 64-bit word per tile and row half (two ballots where
// one mask row serves every query), so the loops branch on nothing per
// logit.  A single key tile (T <= 64) is loaded once with q and kept, with its
// logits and weights held in registers from pass to pass.  At T <= 16 (the
// temporal stack) one warp takes one (sequence, head): each of the two 64-row
// key stages holds four pairs' keys, 16 each, and each warp keeps only its
// own pair's 16 columns in the softmax (n-tiles without them are skipped by a
// warp-uniform test), so a block is eight busy warps.  The head dim is
// zero-padded to a multiple of 16 inside (giant's 88 runs as 96); ragged T is
// zero-filled and left out of the softmax.  At head dims 88 and 96 and T <=
// 256 (the vc giant stacks) launch_capped_attention takes
// resident_attention.cu instead, whose K and V stay in shared memory.
#include "mma_sync.cuh"

namespace vp {
namespace {

constexpr int kWarps = 8;
constexpr int kBlockM = 16 * kWarps;  // query rows per block
constexpr int kBlockN = 64;           // keys per streamed tile
constexpr int kPackT = 16;            // longest T run one (sequence, head) per warp

template <int HT>
constexpr size_t attn_smem_bytes() {
  return sizeof(bf16) * (16 * HT + 8) * (kBlockM + 4 * kBlockN);
}

// HT = head dim / 16 rounded up.  Shared memory: the q tile [128, LD], then
// two stages each of K and V [64, LD] (LD = 16 * HT + 8 bf16: rows 16-byte
// aligned and ldmatrix free of bank conflicts).  `packed`: T <= 16, block
// x covers (sequence, head) pairs 8x .. 8x + 7 (pair = sequence * N +
// head), warp w the pair 8x + w, whose queries are rows 16w.. of the q
// tile and whose keys are rows 16 (w % 4).. of stage w / 4.  Otherwise block x
// is (sequence, query tile) = (x / tiles, x % tiles) and y the head.
template <int HT, bool kCapped>
__global__ void __launch_bounds__(kWarps * 32, HT <= 4 ? 2 : 1)
    capped_attention_kernel(const bf16* __restrict__ qkv, const float* __restrict__ mask,
                            bf16* __restrict__ ctx, int T, int num_heads, int H, int mask_b,
                            int mask_t, CapConsts cc, bool packed, int pairs) {
  constexpr int LD = 16 * HT + 8;
  constexpr int CH = 2 * HT;  // 16-byte chunks per padded head row
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + kBlockM * LD;
  bf16* Vs = Ks + 2 * kBlockN * LD;

  const int nh = num_heads * H;
  const size_t pitch = 3 * static_cast<size_t>(nh);
  const int qtiles = (T + kBlockM - 1) / kBlockM;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // Row r of a q or key tile: its (sequence, head, token), valid or not.
  auto source = [&](int r, int tile, int& b, int& n, int& t) {
    if (packed) {
      const int pair = blockIdx.x * kWarps + r / 16;
      t = r % 16;
      b = min(pair, pairs - 1) / num_heads;
      n = min(pair, pairs - 1) % num_heads;
      return pair < pairs && t < T;
    }
    b = blockIdx.x / qtiles;
    n = blockIdx.y;
    t = tile + r;
    return t < T;
  };
  // Copies rows [0, rows) of q (part 0), k (1) or v (2) into dst, token
  // offset `tile` (unpacked), zero-filling invalid rows and padded columns.
  auto load = [&](bf16* dst, int rows, int tile, int part) {
    for (int i = tid; i < rows * CH; i += blockDim.x) {
      const int r = i / CH, c = (i % CH) * 8;
      int b, n, t;
      const bool ok = source(r, tile, b, n, t) && c < H;
      const bf16* src = qkv + (static_cast<size_t>(b) * T + (ok ? t : 0)) * pitch + part * nh +
                        n * H + (ok ? c : 0);
      cp_async16(dst + r * LD + c, src, ok);
    }
  };

  // One key tile (T <= 64, and the packed pairs) is loaded once with q
  // and stays; longer sequences stream theirs in every pass.
  const int tiles = packed ? 1 : (T + kBlockN - 1) / kBlockN;
  const bool resident = tiles == 1;
  const int q0 = packed ? 0 : (blockIdx.x % qtiles) * kBlockM;
  load(Qs, kBlockM, q0, 0);
  if (resident) {  // packed: pairs 0-3 in stage 0, 4-7 in stage 1
    load(Ks, packed ? 2 * kBlockN : kBlockN, 0, 1);
    load(Vs, packed ? 2 * kBlockN : kBlockN, 0, 2);
  }
  cp_async_commit();

  // Key tile j of this block's (sequence, head) into `stage`: the address
  // arithmetic of a streamed tile, paid in every pass, is a row offset.
  const bf16* head = qkv + static_cast<size_t>(blockIdx.x / qtiles) * T * pitch + blockIdx.y * H;
  auto load_tile = [&](int j, int stage, bool with_v) {
    const int t0 = j * kBlockN;
    for (int i = tid; i < kBlockN * CH; i += kWarps * 32) {
      const int r = i / CH, c = (i % CH) * 8;
      const bool ok = t0 + r < T && c < H;
      const bf16* src = head + static_cast<size_t>(ok ? t0 + r : 0) * pitch + (ok ? c : 0);
      const int at = (stage * kBlockN + r) * LD + c;
      cp_async16(Ks + at, src + nh, ok);
      if (with_v) cp_async16(Vs + at, src + 2 * nh, ok);
    }
    cp_async_commit();
  };
  // Streams every key tile through the two stages and calls body(tile,
  // stage) on each in order, the next tile's copy in flight meanwhile;
  // across passes too: the last tile of a pass prefetches the next pass's
  // first (`next`: -1 no next pass, 0 its K, 1 its K and V).  `done`
  // counts the tiles streamed so far: tile `done` sits in stage done & 1.
  // The first pass's first tile is loaded with q.
  int done = 0;
  if (!resident) load_tile(0, 0, false);
  auto stream = [&](bool with_v, int next, auto&& body) {
    if (resident) {
      body(0, packed ? warp / 4 : 0);
      return;
    }
    for (int j = 0; j < tiles; ++j, ++done) {
      if (j + 1 < tiles)
        load_tile(j + 1, (done + 1) & 1, with_v);
      else if (next >= 0)
        load_tile(0, (done + 1) & 1, next == 1);
      if (j + 1 < tiles || next >= 0)
        cp_async_wait<1>();
      else
        cp_async_wait<0>();
      __syncthreads();
      body(j, done & 1);
      __syncthreads();  // the stage is refilled by the next iteration
    }
  };

  // This warp's (sequence, head) and its rows g and g + 8 of the tile.
  const int g = lane / 4, c2 = 2 * (lane % 4);
  int b, n, t0;
  const bool warp_ok = source(16 * warp, q0, b, n, t0);
  const int row[2] = {t0 + g, t0 + g + 8};
  const bool row_ok[2] = {warp_ok && row[0] < T, warp_ok && row[1] < T};
  const float* mbase = mask + static_cast<size_t>(mask_b > 1 ? b : 0) * mask_t * T;
  const float* mrow[2] = {mbase + static_cast<size_t>(mask_t > 1 ? min(row[0], T - 1) : 0) * T,
                          mbase + static_cast<size_t>(mask_t > 1 ? min(row[1], T - 1) : 0) * T};
  // Key of column col of tile j, negative or >= T where it is not this
  // warp's: packed, only columns 16 (w % 4).. + 15 of stage w / 4 are.
  const int key0 = packed ? -16 * (warp % 4) : 0;

  if (resident) {
    cp_async_wait<0>();
    __syncthreads();
  }

  // Logits of key tile `stage` for this warp's 16 rows; q's fragments are
  // read from shared memory for each tile, not held across it.
  float sc[8][4];
  auto logits = [&](int stage) {
    uint32_t qf[HT][4];
    load_rows<HT>(qf, Qs + warp * 16 * LD, LD, lane);
    tile_logits<HT>(sc, qf, Ks + stage * kBlockN * LD, LD, lane);
  };
  auto key = [&](int j, int jn, int e) { return key0 + j * kBlockN + jn * 8 + c2 + (e & 1); };
  auto valid = [&](int s) { return static_cast<unsigned>(s) < static_cast<unsigned>(T); };
  // Whether n-tile jn of tile j holds any of this warp's keys: a
  // warp-uniform test, so the n-tiles past T, and in a packed block the
  // other warps' 48 columns, cost no issue slots.
  auto live = [&](int j, int jn) {
    const int s0 = key0 + j * kBlockN + jn * 8;
    return s0 + 8 > 0 && s0 < T;
  };
  // The mask of tile j as one 64-bit word per row half, bit c set where
  // column c's key is in range and not masked, so that the loops over the
  // logits branch on nothing.  One mask row for every query (mask_t = 1):
  // two ballots; the causal text tower's per-row mask: this lane's columns.
  uint64_t bits[2];
  auto tile_bits = [&](int j) {
    if (mask_t == 1) {
      const int s0 = key0 + j * kBlockN + lane, s1 = s0 + 32;
      const bool lo = valid(s0) && __ldg(mrow[0] + s0) >= kMaskThreshold;
      const bool hi = valid(s1) && __ldg(mrow[0] + s1) >= kMaskThreshold;
      bits[0] = bits[1] = __ballot_sync(0xffffffffu, lo) |
                          static_cast<uint64_t>(__ballot_sync(0xffffffffu, hi)) << 32;
      return;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint64_t word = 0;
#pragma unroll
      for (int jn = 0; jn < 8; ++jn)
#pragma unroll
        for (int e1 = 0; e1 < 2; ++e1) {
          const int col = jn * 8 + c2 + e1, s = key0 + j * kBlockN + col;
          if (valid(s) && __ldg(mrow[h] + s) >= kMaskThreshold) word |= 1ull << col;
        }
      bits[h] = word;
    }
  };
  auto unmasked = [&](int jn, int e) {
    return ((bits[e >> 1] >> (jn * 8 + c2 + (e & 1))) & 1) != 0;
  };
  // Unnormalised weight of logit l (mma_sync.cuh logit_weight, the
  // expressions of K5 and K7; 0 where masked); the cap is a template
  // constant, so each loop holds one of the two formulas.
  auto weight = [&](float l, bool ok, float mx) {
    float r;
    const float w = logit_weight<kCapped>(l, mx, cc, r);
    return ok ? w : 0.f;
  };

  float mx[2] = {0.f, 0.f};
  if constexpr (!kCapped) {  // row max, as the TPU kernel takes it without a cap
    float m[2] = {-FLT_MAX, -FLT_MAX};
    stream(false, 0, [&](int j, int stage) {
      logits(stage);
      tile_bits(j);
#pragma unroll
      for (int jn = 0; jn < 8; ++jn) {
        if (!live(j, jn)) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int s = key(j, jn, e), h = e >> 1;
          if (valid(s)) m[h] = fmaxf(m[h], unmasked(jn, e) ? sc[jn][e] : -FLT_MAX);
        }
      }
    });
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m[h] = fmaxf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 1));
      mx[h] = fmaxf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 2));
    }
  }

  // Pass one: the row sums.  A resident tile's logits (and mask) are
  // still in sc (and bits) from pass zero, and its weights stay in sc for
  // pass two: the same values the recomputation would give.
  float sum[2] = {0.f, 0.f};
  stream(false, 1, [&](int j, int stage) {
    if (!resident || kCapped) {
      logits(stage);
      tile_bits(j);
    }
#pragma unroll
    for (int jn = 0; jn < 8; ++jn) {
      if (!live(j, jn)) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int s = key(j, jn, e), h = e >> 1;
        if (valid(s)) {
          sc[jn][e] = weight(sc[jn][e], unmasked(jn, e), mx[h]);
          sum[h] += sc[jn][e];
        }
      }
    }
  });
  RowScale rs[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
    rs[h] = row_scale(sum[h], T);  // a fully masked row sums to 0: uniform
  }

  // Pass two: the same weights (recomputed bit for bit, or kept for a
  // resident tile), normalised, cast and multiplied into the context.
  float acc[2 * HT][4];
#pragma unroll
  for (int i = 0; i < 2 * HT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  stream(true, -1, [&](int j, int stage) {
    if (!resident) {
      logits(stage);
      tile_bits(j);
    }
#pragma unroll
    for (int jn = 0; jn < 8; ++jn) {
      const bool any = live(j, jn);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int s = key(j, jn, e), h = e >> 1;
        float w = 0.f;
        if (any && valid(s)) {
          const float u = resident ? sc[jn][e] : weight(sc[jn][e], unmasked(jn, e), mx[h]);
          w = normalise(u, rs[h]);
        }
        sc[jn][e] = w;
      }
    }
    mma_block_tile<HT>(acc, sc, Vs + stage * kBlockN * LD, LD, lane);
  });

  // ctx rows of this warp: columns 8i + c2 (+1) of the head, those < H.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!row_ok[h]) continue;
    bf16* out = ctx + (static_cast<size_t>(b) * T + row[h]) * nh + n * H;
#pragma unroll
    for (int i = 0; i < 2 * HT; ++i) {
      const int col = 8 * i + c2;
      if (col < H)
        *reinterpret_cast<bf162*>(out + col) =
            __floats2bfloat162_rn(acc[i][2 * h], acc[i][2 * h + 1]);
    }
  }
}

template <int HT, bool kCapped>
cudaError_t launch(const bf16* qkv, const float* mask, bf16* ctx, int batch, int T,
                   int num_heads, int H, int mask_b, int mask_t, float cap,
                   cudaStream_t stream) {
  constexpr size_t smem = attn_smem_bytes<HT>();
  cudaError_t err = set_max_dynamic_smem<capped_attention_kernel<HT, kCapped>>(smem);
  if (err != cudaSuccess) return err;
  const bool packed = T <= kPackT;
  const int pairs = batch * num_heads;
  const dim3 grid = packed ? dim3((pairs + kWarps - 1) / kWarps)
                           : dim3(batch * ((T + kBlockM - 1) / kBlockM), num_heads);
  capped_attention_kernel<HT, kCapped><<<grid, kWarps * 32, smem, stream>>>(
      qkv, mask, ctx, T, num_heads, H, mask_b, mask_t, cap_consts(cap), packed, pairs);
  return cudaGetLastError();
}

}  // namespace

cudaError_t launch_capped_attention(const bf16* qkv, const float* mask, bf16* ctx, int batch,
                                    int T, int num_heads, int head_dim, int mask_b, int mask_t,
                                    float logit_cap, cudaStream_t stream) {
  if (T <= 0 || head_dim <= 0 || head_dim % 8) return cudaErrorInvalidValue;
  if (resident_attention_takes(T, head_dim))
    return launch_resident_attention(qkv, mask, ctx, batch, T, num_heads, head_dim, mask_b, mask_t,
                                     logit_cap, stream);
#define VP_ATTN_CASE(ht)                                                                    \
  case ht:                                                                                  \
    return logit_cap > 0.f ? launch<ht, true>(qkv, mask, ctx, batch, T, num_heads, head_dim, \
                                              mask_b, mask_t, logit_cap, stream)            \
                           : launch<ht, false>(qkv, mask, ctx, batch, T, num_heads,         \
                                               head_dim, mask_b, mask_t, logit_cap, stream);
  switch ((head_dim + 15) / 16) {
    VP_ATTN_CASE(1) VP_ATTN_CASE(2) VP_ATTN_CASE(3) VP_ATTN_CASE(4)
    VP_ATTN_CASE(5) VP_ATTN_CASE(6) VP_ATTN_CASE(7) VP_ATTN_CASE(8)
    default: return cudaErrorInvalidValue;
  }
#undef VP_ATTN_CASE
}

}  // namespace vp

// The longest sequence the core takes at head dim H: it streams K and V,
// so any length (a sentinel, far past the route's 1024) where it takes the
// head dim (a multiple of 8, at most 128), else 0.
extern "C" int vp_attention_max_t(int head_dim) {
  return head_dim > 0 && head_dim % 8 == 0 && head_dim <= 128 ? (1 << 30) : 0;
}

// K1's attention core at giant's head dims (88 and 96, HT = 6) for T <=
// 256: each (sequence, head)'s K and V loaded once into shared memory and
// held for every pass.
//
// Replaces, with capped_attention.cu, _heads_attention inside K1 and K8a
// (_attn_block_kernel, _attn_chunk_kernel in
// videoprism_tpu/ops/pallas/transformer_block.py) at the shapes of the vc
// giant stacks (spatial T = 256, temporal T = 8) and every T <= 256 at this
// head dim; launch_capped_attention dispatches here, and longer T stream
// through capped_attention_kernel.  The arithmetic and its order are that
// kernel's, so the bits are too (chip_smoke.py --outputs holds K1, K8a and
// K10 to the parent tree's): logits of the pre-scaled q against k by the
// mma.sync instructions of mma_sync.cuh tile_logits (the head dim in the
// same k-order, each n-tile summed alone), the weight by logit_weight, the
// row sum added per lane in key order (chunk by chunk, within one over
// n-tiles, then the element pair; keys past T add an exact 0) and then the
// two shuffles, row_scale and normalise, P @ V with fp32 accumulators over
// 16-key groups in key order.
//
// Bound: per logit three special-function operations in each of the two
// passes (16 a clock on an SM) and the ldmatrix reads of K and V (each warp
// reads all of its head's keys in each pass, 128 bytes a clock); both
// weigh more than the two products on the tensor cores, and q, k, v and
// ctx cross device memory once.  What capped_attention_kernel loses at
// this head dim is latency: its registers leave one block of 8 warps on an
// SM, every streamed tile costs two block barriers in each pass, and both
// 128-query blocks of a head fetch its K and V.  Latency rules here too
// (measured on an H100): a warp of 32 query rows, sharing each K and V
// fragment between its two row tiles, halved the ldmatrix reads and was
// 1.5x slower at 8 warps an SM (PERF.md, section 6).  Design:
// - one block per (sequence, head) at 16 < T <= 256, a warp per 16 query
//   rows (16 warps at T = 256), the whole K and V [T, 104] bf16 (106,496
//   bytes at T = 256) and q in shared memory;
// - each row of q, K and V one bulk copy (cp.async.bulk) completing on an
//   mbarrier, one per warp's q rows and per 64-key tile of K and of V, so
//   that a warp starts on the first tile while the rest arrive, and no
//   block barrier is taken after the one that publishes the mbarriers;
// - registers for 16 warps on an SM (__launch_bounds__ holds them to 128;
//   chip_smoke.py [build] fails on a spill): keys taken 32 at a time, q's
//   fragments read per 16-deep k-step (holding them through the first
//   pass measured no faster), and the zero n-tile of P @ V at H = 88
//   (columns 88-95, dropped at the store anyway) left out;
// - no branch per logit: a key past T or masked weighs an exact 0 by a
//   select (a branch around each logit's weight, with its convergence
//   barrier, cost more than the weight);
// - the weights of the first two 32-key chunks kept from pass one for
//   pass two in shared memory (all the room there is: keeping all 256 KB
//   of a (sequence, head)'s fp32 weights would need more than the SM's 227
//   KB), the rest recomputed bit for bit; a pass zero takes the row max
//   when there is no cap;
// - T <= 16 (the temporal stack): eight (sequence, head) pairs a block, a
//   warp each, its 16 keys alone (where capped_attention_kernel multiplies
//   a warp's rows against its whole 64-row key stage), 80 KB of shared
//   memory so that two blocks share an SM.
// The head dim is zero-padded to 96 inside; ragged T is zero-filled and
// left out of the softmax.
#include "mma_sync.cuh"

namespace vp {
namespace {

constexpr int kMaxWarps = 16;
constexpr int kResidentT = 16 * kMaxWarps;  // the longest T held whole: 256
constexpr int kPackT = 16;                  // the longest T run a (sequence, head) per warp
constexpr int kPackWarps = 8;               // warps (pairs) of a block at T <= 16
constexpr int kTile = 64;                   // keys per mbarrier
constexpr int kTiles = kResidentT / kTile;

template <int HT>
constexpr size_t resident_smem_bytes() {
  return sizeof(bf16) * (16 * HT + 8) * 3 * kResidentT;
}

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
// Waits for phase 0 of the barrier; traps (a launch error, not a hung
// card) after ~10 s.
__device__ __forceinline__ void bar_wait(uint64_t* bar) {
  const uint32_t addr = smem_u32(bar);
  const long long start = clock64();
  uint32_t done = 0;
  while (!done) {
    if (clock64() - start > 20000000000LL) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr)
        : "memory");
  }
}
// Arrives on the barrier expecting `bytes` more to land on it.
__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// One bulk copy of `bytes` (a multiple of 16; both addresses 16-byte
// aligned) from global to shared memory, its bytes completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Two 8x8 bf16 matrices, transposed: lanes 0-15 give the row addresses.
__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

// tile_logits (mma_sync.cuh) over NT n-tiles with q's fragment of each
// 16-deep slice read from shared memory (`qrows`, a warp's 16 rows) just
// before its products instead of held: the same mma.sync operands in the
// same order for every n-tile, so the same bits.
template <int HT, int NT>
__device__ __forceinline__ void chunk_logits(float (&sc)[NT][4], const bf16* qrows,
                                             const bf16* keys, int ld, int lane) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HT; ++kk) {
    uint32_t af[4];
    ldsm_x4(af, qrows + (lane % 16) * ld + kk * 16 + (lane / 16) * 8);
#pragma unroll
    for (int p = 0; p < NT / 2; ++p) {
      uint32_t kf[4];
      const int m = lane / 8;
      ldsm_x4(kf, keys + (p * 16 + lane % 8 + 8 * (m >> 1)) * ld + kk * 16 + 8 * (m & 1));
      mma16816(sc[2 * p], af, kf[0], kf[1]);
      mma16816(sc[2 * p + 1], af, kf[2], kf[3]);
    }
  }
}

// mma_rows (mma_sync.cuh) over the first NV 8-column n-tiles of V only:
// at H = 88 the twelfth (columns 88-95, zero) is left out, its half of the
// last ldmatrix with it.
template <int HT, int NV>
__device__ __forceinline__ void mma_rows_nv(float (&acc)[NV][4], const uint32_t (&a)[4],
                                            const bf16* tile, int ld, int p, int lane) {
  const int m = lane / 8;
#pragma unroll
  for (int hp = 0; hp < HT; ++hp) {
    const bf16* at = tile + (p * 16 + lane % 8 + 8 * (m & 1)) * ld + hp * 16 + 8 * (m >> 1);
    if (2 * hp + 1 < NV) {
      uint32_t vf[4];
      ldsm_x4_trans(vf, at);
      mma16816(acc[2 * hp], a, vf[0], vf[1]);
      mma16816(acc[2 * hp + 1], a, vf[2], vf[3]);
    } else if (2 * hp < NV) {
      uint32_t vf[2];
      ldsm_x2_trans(vf, at);
      mma16816(acc[2 * hp], a, vf[0], vf[1]);
    }
  }
}

constexpr int kKeep = 2;    // leading 32-key chunks whose weights pass one keeps
constexpr int kChunk = 32;  // keys per step at T > 16
// Shared memory of the kept weights per warp: kKeep chunks of a lane's 16
// values, lane-major (no bank conflict).
constexpr int kKeptBytes = sizeof(float) * kKeep * 16 * 32;

// HT = 6; NV = H / 8 (11 at H = 88, 12 at H = 96).  Shared memory: q [16
// warps, LD], then K and V [krows, LD] each (LD = 16 HT + 8 bf16: rows
// 16-byte aligned and ldmatrix free of bank conflicts; krows = T rounded
// up to a tile), then at T > 16 the weights pass one keeps, kKeptBytes a
// warp.  kPacked (T <= 16): block x takes the (sequence, head) pairs 8x ..
// 8x + 7 (pair = sequence * N + head), warp w the pair 8x + w, whose
// queries and keys are rows 16w.. of q, K and V; otherwise block x is the
// pair x, warp w its queries 16w...
template <int HT, int NV, bool kPacked, bool kCapped>
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
    resident_attention_kernel(const bf16* __restrict__ qkv, const float* __restrict__ mask,
                              bf16* __restrict__ ctx, int T, int num_heads, int H, int mask_b,
                              int mask_t, CapConsts cc, int pairs) {
  constexpr int LD = 16 * HT + 8;
  constexpr int NT = kPacked ? 2 : kChunk / 8;  // n-tiles of a chunk of keys
  constexpr int SPAN = 8 * NT;                  // keys of a chunk
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ uint64_t bars[kMaxWarps + 2 * kTiles];  // q of each warp, K tiles, V tiles
  __shared__ uint32_t mwords[kMaxWarps][kResidentT / kChunk];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int warps = blockDim.x / 32;
  const int krows = kPacked ? 16 * warps : (T + kTile - 1) / kTile * kTile;
  const int tiles = krows / kTile;
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + 16 * warps * LD;
  bf16* Vs = Ks + krows * LD;
  uint64_t* qbar = bars;
  uint64_t* kbar = bars + kMaxWarps;
  uint64_t* vbar = kbar + kTiles;

  const int nh = num_heads * H;
  const size_t pitch = 3 * static_cast<size_t>(nh);
  // Row r of the q, K or V rows: its pair and token, valid or not.
  auto source = [&](int r, int& pair, int& t) {
    pair = kPacked ? blockIdx.x * warps + r / 16 : blockIdx.x;
    t = kPacked ? r % 16 : r;
    return pair < pairs && t < T;
  };
  // Valid rows of 16-row group gr (of the q rows, or of K and V).
  auto group_rows = [&](int gr) {
    return kPacked ? (blockIdx.x * warps + gr < pairs ? min(T, 16) : 0)
                   : max(0, min(T - 16 * gr, 16));
  };

  // The loads: one bulk copy per valid row of q, K and V (H bf16, 16-byte
  // aligned: H is a multiple of 8), completing on the barrier of its
  // warp's q rows or of its 64-row tile of K or V; zeros stored where no
  // copy lands (the padded columns, rows past T or past the last pair).
  const uint32_t row_bytes = sizeof(bf16) * H;
  if (tid == 0) {
    for (int w = 0; w < warps; ++w) bar_init(qbar + w, 1);
    for (int j = 0; j < tiles; ++j) {
      bar_init(kbar + j, 1);
      bar_init(vbar + j, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int w = 0; w < warps; ++w) bar_expect(qbar + w, group_rows(w) * row_bytes);
    for (int j = 0; j < tiles; ++j) {
      int n = 0;
      for (int gr = 4 * j; gr < 4 * j + 4; ++gr) n += group_rows(gr);
      bar_expect(kbar + j, n * row_bytes);
      bar_expect(vbar + j, n * row_bytes);
    }
  }
  // Row i of the q rows, then of K, then of V: its part and row there.
  const int all_rows = 16 * warps + 2 * krows;
  auto place = [&](int i, int& part, int& r) {
    part = i < 16 * warps ? 0 : i < 16 * warps + krows ? 1 : 2;
    r = part == 0 ? i : part == 1 ? i - 16 * warps : i - 16 * warps - krows;
    return (part == 0 ? Qs : part == 1 ? Ks : Vs) + r * LD;
  };
  for (int i = tid; i < all_rows; i += blockDim.x) {
    int part, r, pair, t;
    bf16* dst = place(i, part, r);
    for (int c = source(r, pair, t) ? H : 0; c < 16 * HT; c += 8)
      *reinterpret_cast<uint4*>(dst + c) = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();  // the barriers and the zeros, before any copy or wait
  for (int i = tid; i < all_rows; i += blockDim.x) {
    int part, r, pair, t;
    bf16* dst = place(i, part, r);
    if (source(r, pair, t))
      bulk_copy(dst,
                qkv + (static_cast<size_t>(pair / num_heads) * T + t) * pitch + part * nh +
                    (pair % num_heads) * H,
                row_bytes, part == 0 ? qbar + r / 16 : (part == 1 ? kbar : vbar) + r / kTile);
  }

  // This warp's pair and its rows g and g + 8.
  const int g = lane / 4, c2 = 2 * (lane % 4);
  int pair, t0;
  source(16 * warp, pair, t0);
  if (pair >= pairs) return;  // past the last pair: no copy to wait for
  const int b = pair / num_heads, n = pair % num_heads;
  const int row[2] = {t0 + g, t0 + g + 8};
  // The mask row of query row r (addressed where it is read, so that no
  // pointer stays live across the passes).
  auto mask_row = [&](int r) {
    return mask + (static_cast<size_t>(mask_b > 1 ? b : 0) * mask_t +
                   (mask_t > 1 ? min(r, T - 1) : 0)) *
                      T;
  };
  // Key rows of this warp in K and V: all T (32 a chunk), or, packed, its
  // own 16 (one chunk).
  const int kr0 = kPacked ? 16 * warp : 0;
  const int chunks = (T + SPAN - 1) / SPAN;
  const int keep = kPacked ? 0 : min(kKeep, chunks);
  float* kept = reinterpret_cast<float*>(Vs + krows * LD) + warp * (kKeptBytes / 4) + lane;
  auto kept_at = [&](int c, int jn, int e) { return kept + (c * 16 + jn * 4 + e) * 32; };
  const bf16* qrows = Qs + 16 * warp * LD;

  // The mask of chunk c (keys from s0) as one word per row half, bit 8 jn
  // + e1 set where the lane's column 8 jn + c2 + e1 is a key below T and
  // not masked.  One mask row for every query (mask_t = 1): a ballot per
  // chunk, taken once before the passes into this warp's words; per-row
  // masks: this lane's columns, per chunk and pass.
  const bool one_row = mask_t == 1;
  if (one_row) {
    for (int c = 0; c < chunks; ++c) {
      const int s = c * SPAN + lane;
      const uint32_t word = __ballot_sync(
          0xffffffffu, lane < SPAN && s < T && __ldg(mask_row(0) + s) >= kMaskThreshold);
      if (lane == 0) mwords[warp][c] = word;
    }
    __syncwarp();
  }
  auto chunk_bits = [&](int c, int s0, uint32_t (&bits)[2]) {
    if (one_row) {
      bits[0] = bits[1] = mwords[warp][c] >> c2;
      return;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float* mrow = mask_row(row[h]);
      uint32_t word = 0;
#pragma unroll
      for (int jn = 0; jn < NT; ++jn)
#pragma unroll
        for (int e1 = 0; e1 < 2; ++e1) {
          const int s = s0 + jn * 8 + c2 + e1;
          const bool ok = s < T && __ldg(mrow + min(s, T - 1)) >= kMaskThreshold;
          word |= static_cast<uint32_t>(ok) << (jn * 8 + e1);
        }
      bits[h] = word;
    }
  };
  // Whether element e of n-tile jn of the chunk is a key below T and not
  // masked: such a logit weighs logit_weight's w, the others an exact 0.
  auto counts = [&](const uint32_t (&bits)[2], int jn, int e) {
    return ((bits[e >> 1] >> (jn * 8 + (e & 1))) & 1) != 0;
  };
  auto weight = [&](float l, bool ok, float mx) {
    float r;
    const float w = logit_weight<kCapped>(l, mx, cc, r);
    return ok ? w : 0.f;
  };
  // Whether n-tile jn of the chunk from s0 holds any key below T: a
  // warp-uniform test, so that the packed path's second n-tile at T <= 8
  // costs no issue slots.  Past T the weights are 0 by their select, so
  // the other path, whose n-tiles past T are at most three of a row's last
  // chunk, tests nothing.
  auto live = [&](int s0, int jn) { return !kPacked || s0 + jn * 8 < T; };
  // Waits, where the chunk from key s0 starts a tile, for its K tile
  // (`wait_k`: the first pass) and its V tile (`wait_v`: the last).
  auto wait_tile = [&](int s0, bool wait_k, bool wait_v) {
    if (kPacked || (kr0 + s0) % kTile == 0) {
      const int tile = (kr0 + s0) / kTile;
      if (wait_k) bar_wait(kbar + tile);
      if (wait_v) bar_wait(vbar + tile);
    }
  };
  // Runs body(sc, bits, c, s0) on the logits of chunks first.. of this
  // warp's keys in key order (s0 the chunk's first key).
  auto pass = [&](bool wait_k, bool wait_v, int first, auto&& body) {
    for (int c = first; c < chunks; ++c) {
      const int s0 = c * SPAN;
      wait_tile(s0, wait_k, wait_v);
      float sc[NT][4];
      chunk_logits<HT, NT>(sc, qrows, Ks + (kr0 + s0) * LD, LD, lane);
      uint32_t bits[2];
      chunk_bits(c, s0, bits);
      body(sc, bits, c, s0);
    }
  };

  bar_wait(qbar + warp);
  float mx[2] = {0.f, 0.f};
  bool k_waited = false;
  if constexpr (!kCapped) {  // row max, as the TPU kernel takes it without a cap
    float m[2] = {-FLT_MAX, -FLT_MAX};
    pass(true, false, 0, [&](float (&sc)[NT][4], const uint32_t (&bits)[2], int, int s0) {
#pragma unroll
      for (int jn = 0; jn < NT; ++jn) {
        if (!live(s0, jn)) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          m[e >> 1] = fmaxf(m[e >> 1], counts(bits, jn, e) ? sc[jn][e] : -FLT_MAX);
      }
    });
    k_waited = true;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m[h] = fmaxf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 1));
      mx[h] = fmaxf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 2));
    }
  }

  // Pass one: the row sums; the weights of the first `keep` chunks are
  // kept for pass two.
  float sum[2] = {0.f, 0.f};
  pass(!k_waited, false, 0, [&](float (&sc)[NT][4], const uint32_t (&bits)[2], int c, int s0) {
#pragma unroll
         for (int jn = 0; jn < NT; ++jn) {
           if (!live(s0, jn)) continue;
#pragma unroll
           for (int e = 0; e < 4; ++e) {
             sc[jn][e] = weight(sc[jn][e], counts(bits, jn, e), mx[e >> 1]);
             sum[e >> 1] += sc[jn][e];
           }
         }
         if (c < keep) {
#pragma unroll
           for (int jn = 0; jn < NT; ++jn)
#pragma unroll
             for (int e = 0; e < 4; ++e) *kept_at(c, jn, e) = sc[jn][e];
         }
       });
  RowScale rs[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
    rs[h] = row_scale(sum[h], T);  // a fully masked row sums to 0: uniform
  }

  // Pass two: the same weights (kept, or recomputed bit for bit),
  // normalised, cast and multiplied into the context 16 keys at a time.
  float acc[NV][4];
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  // sc: the chunk's weights (`weighed`) or logits.
  auto product = [&](float (&sc)[NT][4], const uint32_t (&bits)[2], int s0, bool weighed) {
#pragma unroll
    for (int jn = 0; jn < NT; ++jn) {
      if (!live(s0, jn)) {
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[jn][e] = 0.f;
        continue;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const bool key = s0 + jn * 8 + c2 + (e & 1) < T;
        const float u = weighed ? sc[jn][e] : weight(sc[jn][e], counts(bits, jn, e), mx[h]);
        const float w = normalise(u, rs[h]);
        sc[jn][e] = key ? w : 0.f;
      }
    }
#pragma unroll
    for (int p = 0; p < NT / 2; ++p) {
      uint32_t a[4];
      pack_block(a, sc[2 * p], sc[2 * p + 1]);
      mma_rows_nv<HT, NV>(acc, a, Vs + (kr0 + s0) * LD, LD, p, lane);
    }
  };
  for (int c = 0; c < keep; ++c) {
    const int s0 = c * SPAN;
    wait_tile(s0, false, true);
    float sc[NT][4];
#pragma unroll
    for (int jn = 0; jn < NT; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[jn][e] = *kept_at(c, jn, e);
    const uint32_t none[2] = {0u, 0u};
    product(sc, none, s0, true);
  }
  pass(false, true, keep, [&](float (&sc)[NT][4], const uint32_t (&bits)[2], int, int s0) {
         product(sc, bits, s0, false);
       });

  // ctx rows of this warp: columns 8i + c2 (+1) of the head, those < H.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row[h] >= T) continue;
    bf16* out = ctx + (static_cast<size_t>(b) * T + row[h]) * nh + n * H;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int col = 8 * i + c2;
      if (col < H)
        *reinterpret_cast<bf162*>(out + col) =
            __floats2bfloat162_rn(acc[i][2 * h], acc[i][2 * h + 1]);
    }
  }
}

template <int HT, int NV, bool kPacked, bool kCapped>
cudaError_t launch(const bf16* qkv, const float* mask, bf16* ctx, int batch, int T,
                   int num_heads, int H, int mask_b, int mask_t, float cap,
                   cudaStream_t stream) {
  constexpr int LD = 16 * HT + 8;
  cudaError_t err = set_max_dynamic_smem<resident_attention_kernel<HT, NV, kPacked, kCapped>>(
      resident_smem_bytes<HT>() + kMaxWarps * kKeptBytes);
  if (err != cudaSuccess) return err;
  const int pairs = batch * num_heads;
  const int warps = kPacked ? kPackWarps : (T + 15) / 16;
  const int krows = kPacked ? 16 * warps : (T + kTile - 1) / kTile * kTile;
  const size_t smem = sizeof(bf16) * LD * (16 * warps + 2 * krows) +
                      (kPacked ? 0 : static_cast<size_t>(warps) * kKeptBytes);
  const int grid = kPacked ? (pairs + warps - 1) / warps : pairs;
  resident_attention_kernel<HT, NV, kPacked, kCapped><<<grid, warps * 32, smem, stream>>>(
      qkv, mask, ctx, T, num_heads, H, mask_b, mask_t, cap_consts(cap), pairs);
  return cudaGetLastError();
}

// The four instantiations of one head dim's (NV's) kernel.
template <int NV>
cudaError_t dispatch(const bf16* qkv, const float* mask, bf16* ctx, int batch, int T,
                     int num_heads, int H, int mask_b, int mask_t, float cap,
                     cudaStream_t stream) {
  const bool packed = T <= kPackT, capped = cap > 0.f;
  if (packed)
    return capped ? launch<6, NV, true, true>(qkv, mask, ctx, batch, T, num_heads, H, mask_b,
                                              mask_t, cap, stream)
                  : launch<6, NV, true, false>(qkv, mask, ctx, batch, T, num_heads, H, mask_b,
                                               mask_t, cap, stream);
  return capped ? launch<6, NV, false, true>(qkv, mask, ctx, batch, T, num_heads, H, mask_b,
                                             mask_t, cap, stream)
                : launch<6, NV, false, false>(qkv, mask, ctx, batch, T, num_heads, H, mask_b,
                                              mask_t, cap, stream);
}

}  // namespace

bool resident_attention_takes(int T, int head_dim) {
  return T > 0 && T <= kResidentT && (head_dim == 88 || head_dim == 96);
}

cudaError_t launch_resident_attention(const bf16* qkv, const float* mask, bf16* ctx, int batch,
                                      int T, int num_heads, int head_dim, int mask_b, int mask_t,
                                      float logit_cap, cudaStream_t stream) {
  if (!resident_attention_takes(T, head_dim)) return cudaErrorInvalidValue;
  return head_dim == 88 ? dispatch<11>(qkv, mask, ctx, batch, T, num_heads, head_dim, mask_b,
                                       mask_t, logit_cap, stream)
                        : dispatch<12>(qkv, mask, ctx, batch, T, num_heads, head_dim, mask_b,
                                       mask_t, logit_cap, stream);
}

}  // namespace vp

"""K9, K10, K11, K12a and K12b: the int8 (W8A8) serving blocks.

Ports ``videoprism_tpu/ops/pallas/int8_blocks.py``:
``int8_ffn_block_chunked`` (K9), ``int8_attention_block_chunked`` (K10),
``int8_layer_block`` (K11), ``int8_qkv_projection`` (K12a),
``int8_out_projection`` (K12b) and ``int8_projected_flash_attention``
(K12a, then K5, then K12b).  On a CUDA tensor each wrapper runs its chain
of hand-written kernels (``csrc/int8_blocks.cu``); on a CPU tensor, or with
``impl='reference'``, the plain PyTorch twin beside it, which computes the
JAX kernel body step by step:

  quant_rows(h): s = max|h| * (1/127), s = max(s, 1e-12),
      q = clip(round_half_even(h * (1/s)), -127, 127) as int8.
  Products int8 x int8 exactly (float64 here, int32 on the card), then
      (float(acc) * row_scale) * col_scale in fp32.
  K12a: h8 = quant_rows(LN(x) in fp32); q = ((h8 @ Wq) + bq) * query_scale,
      k, v likewise without the scale, each cast to the activation dtype.
  K10: K12a's q, k, v; the capped-softmax core of K1 -> ctx in the
      activation dtype; per head group c: quant_rows(ctx_c in fp32) @ Wo_c,
      + bo + x in group 0, + the previous output after, cast after each.
  K12b: quant_rows(ctx) @ Wo + bo + resid, cast.
  K9: h8 = quant_rows(LN(x)); per F-chunk c: a = act((h8 @ W1_c) + b1_c) *
      keep in fp32, quant_rows(a) @ W2_c, + b2 in chunk 0, * keep, + the
      previous output (x in chunk 0), cast after each.
  K11: K10's attention half and K9's FFN half, but each half sums its
      chunks' products in fp32 and casts once:
      x1 = cast((sum_c part_c + bo) + x),
      out = cast(((sum_c part_c + b2) * keep) + x1).

The chunk counts are part of the arithmetic (the scale of ctx and of the
hidden activation is taken over a chunk's columns, and chained blocks cast
after every chunk), so the reference's rule for them is copied below.
GELU is the exact erf form (the TPU's bf16 kernels use a polynomial).  The
kernels take bf16 activations and raise on fp32 CUDA tensors; fp32 on the
card runs with ``impl='reference'``.

On the card K11's, K12a's and K12b's products quantize their own
activation rows (the LN'd x, or ctx per head group) in a prologue into
shared memory, and a product over several K-chunks sums them in fp32 on
chip: K12a and K12b are one launch each, K11 six at any chunk counts
(q|k|v, K1's core, Wo, W1, the quantizer of the hidden activation, W2).
Those rows are at most 2048 codes (16 k-tiles of 128) in chunks of at most
1536, which every model's D and N*H are.  The chains K9 and K10 quantize
with the standalone quantizer and read the codes by TMA.

The kernels read their int8 weights K-major (the s8 ``wgmma`` takes no
transposed operand): q|k|v as one [3*N*H', D] matrix, so that K10, K11
and K12a make one q|k|v product, Wo as [D, N*H'], W1 as [F, D] and W2 as
[D, F], each head zero-padded to H' (a multiple of 8).
``io.checkpoints.prepare_for_kernels`` writes them once at load (the
``int8_*_kmajor`` helpers below build the same from [K, N] weights); the
wrappers take them as ``kmajor``.  :func:`gemm_i8`, :func:`quantize_rows`
and :func:`capped_core` run the primitives alone (measurement, and the
blocks composed from them in ``cases.int8_composed``).
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from videoprism_tpu_torch.ops.kernels import _lib
from videoprism_tpu_torch.ops.kernels import flash_attention as flash
from videoprism_tpu_torch.ops.kernels.transformer_block import (
    ACTIVATIONS,
    attention_core,
    check_partial_out,
    ln_f32,
    pad_heads,
    padded_head_dim,
)

_INT8 = ('w1', 'w2', 'wq', 'wk', 'wv', 'wo', 'wqkv')
_FP32 = ('mask', 's1', 's2', 'sq', 'sk', 'sv', 'so', 'sqkv')
# The widest row (in int8 codes, over all its K-chunks) that a quantizing
# prologue holds: 16 k-tiles of 128 in shared memory beside the B ring; and
# the widest chunk a warp quantizes from its registers (six 16-byte chunks
# a lane).
PROLOGUE_MAX_K = 2048
PROLOGUE_MAX_CHUNK = 1536


def quant_rows(h: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
  """Symmetric per-row int8 quantization of fp32 rows -> (q int8, scale
  fp32 [..., 1]).  All-zero rows get the clamped scale and quantize to 0."""
  s = h.abs().amax(-1, keepdim=True) * (1.0 / 127.0)
  s = torch.clamp_min(s, 1e-12)
  q = torch.clamp(torch.round(h * (1.0 / s)), -127.0, 127.0)
  return q.to(torch.int8), s


def _i8_matmul(a8: torch.Tensor, w8: torch.Tensor) -> torch.Tensor:
  """The exact int8 product as fp32: float64 holds every int32 sum
  (|acc| <= 127^2 * K) exactly, and the one cast to fp32 rounds it to
  nearest even as the card's int32 -> fp32 conversion does."""
  return (a8.double() @ w8.double()).float()


def _activate(a: torch.Tensor, activation: str) -> torch.Tensor:
  return F.gelu(a) if activation == 'gelu' else torch.relu(a)


def _check_activation(activation: str) -> None:
  if activation not in ACTIVATIONS:
    raise ValueError(f'activation must be gelu or relu, got {activation!r}')


# ---------------------------------------------------------------------------
# Plain twins.
# ---------------------------------------------------------------------------


def _reference_qkv(x, ln_scale, ln_bias, wq, sq, bq, wk, sk, bk, wv, sv, bv,
                   *, epsilon, query_scale):
  """K12a's twin on x [..., D] -> q, k, v [..., N*H] in x's dtype."""
  h8, hs = quant_rows(ln_f32(x, ln_scale, ln_bias, epsilon))
  proj = lambda w, s, b: _i8_matmul(h8, w) * hs * s.float() + b.float()
  q = (proj(wq, sq, bq) * query_scale).to(x.dtype)
  return q, proj(wk, sk, bk).to(x.dtype), proj(wv, sv, bv).to(x.dtype)


def _parts(a, w, ws, chunks):
  """The fp32 products of the last matmul over ``chunks`` K-slices, each
  slice of ``a`` quantized over its own columns."""
  kc = a.shape[-1] // chunks
  for c in range(chunks):
    a8, as_ = quant_rows(a[..., c * kc:(c + 1) * kc].float())
    yield _i8_matmul(a8, w[c * kc:(c + 1) * kc]) * as_ * ws.float()


def _chain(parts, bias, x, keep=None):
  """K9/K10/K12b: bias in the first part, times keep, plus the residual (x,
  then the previous output), cast to x's dtype after each part."""
  out = x
  for c, part in enumerate(parts):
    if c == 0:
      part = part + bias.float()
    if keep is not None:
      part = part * keep
    out = (part + out.float()).to(x.dtype)
  return out


def _sum(parts, bias, x, keep=None):
  """K11: the parts summed in fp32, + bias, times keep, + x, one cast."""
  acc = None
  for part in parts:
    acc = part if acc is None else acc + part
  acc = acc + bias.float()
  if keep is not None:
    acc = acc * keep
  return (acc + x.float()).to(x.dtype)


def _reference_ctx(x, mask, ln_scale, ln_bias, wq, sq, bq, wk, sk, bk, wv, sv,
                   bv, *, num_heads, dim_per_head, logit_cap, epsilon,
                   query_scale):
  """K12a's q, k, v and K1's attention core -> ctx [B, T, N*H] in x's
  dtype."""
  b, t, _ = x.shape
  q, k, v = _reference_qkv(x, ln_scale, ln_bias, wq, sq, bq, wk, sk, bk, wv,
                           sv, bv, epsilon=epsilon, query_scale=query_scale)
  heads = lambda a: a.reshape(b, t, num_heads, dim_per_head).transpose(1, 2)
  ctx = attention_core(heads(q), heads(k), heads(v), mask,
                       logit_cap=logit_cap, dtype=x.dtype)
  return ctx.transpose(1, 2).reshape(b, t, num_heads * dim_per_head)


def _reference_hidden_parts(x, keep, ln_scale, ln_bias, w1, s1, b1, w2, s2, *,
                            chunks, activation, epsilon):
  """K9's and K11's FFN products per F-chunk, in fp32."""
  h8, hs = quant_rows(ln_f32(x, ln_scale, ln_bias, epsilon))
  fc = w1.shape[1] // chunks
  for c in range(chunks):
    sl = slice(c * fc, (c + 1) * fc)
    a = _i8_matmul(h8, w1[:, sl]) * hs * s1[sl].float()
    a = _activate(a + b1[sl].float(), activation) * keep
    yield from _parts(a, w2[sl], s2, 1)


# ---------------------------------------------------------------------------
# The kernels' weight layout.
# ---------------------------------------------------------------------------


def int8_qkv_kmajor(wq, sq, bq, wk, sk, bk, wv, sv, bv, *, num_heads: int,
                    dim_per_head: int) -> dict[str, torch.Tensor]:
  """The q|k|v operands the int8 kernels read, from the JAX layout's [..,
  D, N*H] weights and [.., N*H] scales and biases: ``wqkv`` int8 [..,
  3*N*H', D] (K-major), ``sqkv`` and ``bqkv`` [.., 3*N*H'], each head
  zero-padded to H' = ``padded_head_dim(H)`` (zero weights, scales and
  biases: the padded q, k, v columns are exact zeros)."""
  pad = lambda a: pad_heads(a, num_heads, dim_per_head, -1)
  return {
      'wqkv': torch.cat([pad(wq), pad(wk), pad(wv)], -1
                        ).transpose(-1, -2).contiguous(),
      'sqkv': torch.cat([pad(sq), pad(sk), pad(sv)], -1).contiguous(),
      'bqkv': torch.cat([pad(bq), pad(bk), pad(bv)], -1).contiguous(),
  }


def int8_out_kmajor(wo, *, num_heads: int, dim_per_head: int
                    ) -> dict[str, torch.Tensor]:
  """``wo`` int8 [.., D, N*H'] (K-major) from the JAX layout's [.., N*H, D],
  zero columns for the padded ctx columns."""
  return {'wo': pad_heads(wo, num_heads, dim_per_head, -2
                          ).transpose(-1, -2).contiguous()}


def int8_ffn_kmajor(w1, w2) -> dict[str, torch.Tensor]:
  """``w1`` int8 [.., F, D] and ``w2`` [.., D, F] (K-major) from the JAX
  layout's [.., D, F] and [.., F, D]."""
  return {'w1': w1.transpose(-1, -2).contiguous(),
          'w2': w2.transpose(-1, -2).contiguous()}


def _qkv_views(kmajor, nh):
  """The K-major q|k|v operands as the twins' (wq, sq, bq, wk, .., bv):
  [D, nh] views of ``wqkv`` and slices of ``sqkv`` and ``bqkv``."""
  w = kmajor['wqkv'].transpose(-1, -2)
  views = []
  for i in range(3):
    cols = slice(i * nh, (i + 1) * nh)
    views += [w[:, cols], kmajor['sqkv'][cols], kmajor['bqkv'][cols]]
  return views


# ---------------------------------------------------------------------------
# Wrappers.  Each takes the JAX package's signature, whose weights are [K,
# N]; ``kmajor`` (``prepare_for_kernels``' ``fused`` operands, or the
# ``int8_*_kmajor`` helpers') is the kernels' layout, and when it is given
# the [K, N] weights it replaces are not read (they may be None): the
# layer stack always gives it.  Given [K, N] weights on the card, a wrapper
# builds the K-major operands itself, a copy off the model path.  The
# twins read whichever layout they are given, the same products.
# ---------------------------------------------------------------------------


# The checks below run on every launch: each builds its message only when
# it fails.


def _check_multiple(**dims: int) -> None:
  for name, value in dims.items():
    if value <= 0 or value % 16:
      raise ValueError(f'{name}={value} must be a positive multiple of 16 '
                       '(int8 rows of 16 bytes)')


def _check_shapes(cond: bool, what: str) -> None:
  if not cond:
    raise ValueError(f'{what} shapes do not match x')


def _check_prologue(chunks: int = 1, **dims: int) -> None:
  """The rows a product quantizes in its prologue (``chunks`` chunks of
  each width in ``dims``) fit its shared memory."""
  for name, value in dims.items():
    if (value > PROLOGUE_MAX_CHUNK
        or chunks * -(-value // 128) * 128 > PROLOGUE_MAX_K):
      raise ValueError(
          f'{name}={value} in {chunks} chunk(s): the kernels quantize rows '
          f'of at most {PROLOGUE_MAX_K} int8 codes (16 k-tiles of 128), '
          f'chunks of at most {PROLOGUE_MAX_CHUNK}')


def int8_ffn_block_chunked(
    x: torch.Tensor, paddings: torch.Tensor,   # [rows, D], [rows, 1]
    ln_scale: torch.Tensor, ln_bias: torch.Tensor,       # [D]
    # int8 [D, F], fp32 [F], [F]
    w1: torch.Tensor | None, s1: torch.Tensor, b1: torch.Tensor,
    # int8 [F, D], fp32 [D], [D]
    w2: torch.Tensor | None, s2: torch.Tensor, b2: torch.Tensor,
    *,
    chunks: int,
    activation: str = 'gelu',
    epsilon: float = 1e-6,
    partial_out: bool = False,
    kmajor: dict[str, torch.Tensor] | None = None,   # w1 [F, D], w2 [D, F]
    impl: str = 'auto',
) -> torch.Tensor:
  """K9: ``x + keep * FFN(LN(x))`` in W8A8 over ``chunks`` F-chunks, cast
  after each -> [rows, D]."""
  check_partial_out(partial_out)
  _check_activation(activation)
  rows, d = x.shape
  f = s1.shape[0]
  if chunks < 1 or f % chunks:
    raise ValueError(f'{chunks} chunks do not divide F={f}')
  on_card = _lib.use_kernel(impl, x)
  if kmajor is None:
    if on_card:
      _check_shapes(w1.shape == (d, f) and w2.shape == (f, d), 'FFN operand')
      kmajor = int8_ffn_kmajor(w1, w2)
  else:
    w1, w2 = kmajor['w1'].transpose(-1, -2), kmajor['w2'].transpose(-1, -2)
  if not on_card:
    keep = 1.0 - paddings.float()
    parts = _reference_hidden_parts(x, keep, ln_scale, ln_bias, w1, s1, b1,
                                    w2, s2, chunks=chunks,
                                    activation=activation, epsilon=epsilon)
    return _chain(parts, b2, x, keep)
  w1, w2 = kmajor['w1'], kmajor['w2']
  _lib.check_tensors(x.device, int8=_INT8, fp32=_FP32, x=x, paddings=paddings,
                     ln_scale=ln_scale, ln_bias=ln_bias, w1=w1, s1=s1, b1=b1,
                     w2=w2, s2=s2, b2=b2)
  _check_shapes(paddings.shape == (rows, 1) and ln_scale.shape == (d,)
                and ln_bias.shape == (d,) and w1.shape == (f, d)
                and b1.shape == (f,) and w2.shape == (d, f)
                and s2.shape == (d,) and b2.shape == (d,), 'FFN operand')
  _check_multiple(D=d, F=f, F_chunk=f // chunks)
  dev = x.device
  out = torch.empty_like(x)
  _lib.launch('vp_int8_ffn_block', dev, x, paddings, ln_scale, ln_bias, w1, s1,
              b1, w2, s2, b2, *_front_scratch(rows, d, dev),
              torch.empty((rows, f), dtype=torch.float32, device=dev),
              torch.empty((rows, f), dtype=torch.int8, device=dev),
              torch.empty((rows, chunks), dtype=torch.float32, device=dev),
              torch.empty_like(x) if chunks > 1 else None, out, rows, d, f,
              chunks, ACTIVATIONS[activation], epsilon)
  _lib.LAUNCHES['int8_ffn_block_chunked'] += 1
  _lib.CHUNK_LAUNCHES['int8_ffn_block_chunked', chunks] += 1
  return out


def _attention_kmajor(qkv, wo, kmajor, x, num_heads, dim_per_head, on_card):
  """(K-major operands or None, the twin's q|k|v and Wo [NH', D], H'): the
  kernels' layout where the card needs it or ``kmajor`` was given, the
  [K, N] one (and the true head dim) otherwise."""
  hp = padded_head_dim(dim_per_head)
  nh = num_heads * dim_per_head
  if kmajor is None:
    if not on_card:
      return None, qkv, wo, dim_per_head
    d = x.shape[-1]
    _check_shapes(all(w.shape == (d, nh) for w in qkv[::3])
                  and all(v.shape == (nh,) for i, v in enumerate(qkv)
                          if i % 3) and (wo is None or wo.shape == (nh, d)),
                  'attention weight')
    kmajor = int8_qkv_kmajor(*qkv, num_heads=num_heads,
                             dim_per_head=dim_per_head)
    if wo is not None:
      kmajor.update(int8_out_kmajor(wo, num_heads=num_heads,
                                    dim_per_head=dim_per_head))
  wo_t = kmajor['wo'].transpose(-1, -2) if 'wo' in kmajor else None
  return kmajor, _qkv_views(kmajor, num_heads * hp), wo_t, hp


def _check_attention(x, mask, ln_scale, ln_bias, kmajor, so, bo, num_heads,
                     hp, chunks):
  b, t, d = x.shape
  nh = num_heads * hp
  _lib.check_tensors(x.device, int8=_INT8, fp32=_FP32, x=x, mask=mask,
                     ln_scale=ln_scale, ln_bias=ln_bias, wqkv=kmajor['wqkv'],
                     sqkv=kmajor['sqkv'], bqkv=kmajor['bqkv'],
                     wo=kmajor['wo'], so=so, bo=bo)
  _check_mask(mask, x)
  _check_shapes(ln_scale.shape == (d,) and ln_bias.shape == (d,)
                and kmajor['wqkv'].shape == (3 * nh, d)
                and kmajor['sqkv'].shape == (3 * nh,)
                and kmajor['bqkv'].shape == (3 * nh,)
                and kmajor['wo'].shape == (d, nh) and so.shape == (d,)
                and bo.shape == (d,), 'attention weight')
  _check_multiple(D=d, NH=nh, head_group=nh // chunks)
  _check_core(t, hp)


def _front_scratch(rows: int, d: int, dev) -> tuple[torch.Tensor, torch.Tensor]:
  """K9's and K10's codes [rows, D] and scales [rows] of the LN'd rows:
  their first product takes the standalone quantizer and reads the codes
  by TMA (``csrc/int8_blocks.cu`` ``first_product``)."""
  return (torch.empty((rows, d), dtype=torch.int8, device=dev),
          torch.empty(rows, dtype=torch.float32, device=dev))


def _check_mask(mask, x):
  b, t, _ = x.shape
  if not (mask.ndim == 3 and mask.shape[0] in (1, b)
          and mask.shape[1] in (1, t) and mask.shape[2] == t):
    raise ValueError(f'mask {tuple(mask.shape)} does not fit x '
                     f'{tuple(x.shape)}')


def _check_core(t, hp):
  if not _lib.attention_fits(t, hp):
    raise ValueError(f'T={t}, H={hp}: the attention core takes head dims of '
                     'at most 128')


def int8_attention_block_chunked(
    x: torch.Tensor,          # [B, T, D]
    mask: torch.Tensor,       # [B|1, T|1, T] additive fp32
    ln_scale: torch.Tensor, ln_bias: torch.Tensor,
    # int8 [D, N*H], fp32 [N*H], [N*H]
    wq: torch.Tensor | None, sq: torch.Tensor | None, bq: torch.Tensor | None,
    wk: torch.Tensor | None, sk: torch.Tensor | None, bk: torch.Tensor | None,
    wv: torch.Tensor | None, sv: torch.Tensor | None, bv: torch.Tensor | None,
    # int8 [N*H, D], fp32 [D], [D]
    wo: torch.Tensor | None, so: torch.Tensor, bo: torch.Tensor,
    *,
    num_heads: int,
    dim_per_head: int,
    chunks: int,
    logit_cap: float = 0.0,
    epsilon: float = 1e-6,
    query_scale: float = 1.0,
    partial_out: bool = False,
    # wqkv [3*N*H', D], sqkv, bqkv [3*N*H'], wo [D, N*H']
    kmajor: dict[str, torch.Tensor] | None = None,
    impl: str = 'auto',
) -> torch.Tensor:
  """K10: ``x + Attn(LN(x))`` in W8A8, the output product over ``chunks``
  head groups cast after each -> [B, T, D].  The reference's ``seq_group``
  is TPU tiling and is not ported."""
  check_partial_out(partial_out)
  if chunks < 1 or num_heads % chunks:
    raise ValueError(f'{chunks} chunks do not divide {num_heads} heads')
  on_card = _lib.use_kernel(impl, x)
  kmajor, qkv, wo_t, hp = _attention_kmajor(
      (wq, sq, bq, wk, sk, bk, wv, sv, bv), wo, kmajor, x, num_heads,
      dim_per_head, on_card)
  static = dict(num_heads=num_heads, dim_per_head=hp,
                logit_cap=float(logit_cap), epsilon=epsilon,
                query_scale=float(query_scale))
  if not on_card:
    ctx = _reference_ctx(x, mask, ln_scale, ln_bias, *qkv, **static)
    return _chain(_parts(ctx, wo_t, so, chunks), bo, x)
  _check_attention(x, mask, ln_scale, ln_bias, kmajor, so, bo, num_heads,
                   hp, chunks)
  b, t, d = x.shape
  rows, nh = b * t, num_heads * hp
  dev = x.device
  out = torch.empty_like(x)
  _lib.launch(
      'vp_int8_attention_block', dev, x, mask, ln_scale, ln_bias,
      kmajor['wqkv'], kmajor['sqkv'], kmajor['bqkv'], kmajor['wo'], so, bo,
      *_front_scratch(rows, d, dev),
      torch.empty((rows, 3 * nh), dtype=x.dtype, device=dev),
      torch.empty((rows, nh), dtype=x.dtype, device=dev),
      torch.empty((rows, nh), dtype=torch.int8, device=dev),
      torch.empty((rows, chunks), dtype=torch.float32, device=dev),
      torch.empty_like(x) if chunks > 1 else None, out,
      b, t, d, num_heads, hp, mask.shape[0], mask.shape[1], chunks,
      float(logit_cap), epsilon, float(query_scale))
  _lib.LAUNCHES['int8_attention_block_chunked'] += 1
  _lib.CHUNK_LAUNCHES['int8_attention_block_chunked', chunks] += 1
  return out


def int8_layer_block(
    x: torch.Tensor,          # [B, T, D]
    mask: torch.Tensor,       # [B|1, T|1, T] additive fp32
    paddings: torch.Tensor,   # [B, T, 1]
    ln1_scale: torch.Tensor, ln1_bias: torch.Tensor,
    # int8 [D, N*H], fp32 [N*H], [N*H]
    wq: torch.Tensor | None, sq: torch.Tensor | None, bq: torch.Tensor | None,
    wk: torch.Tensor | None, sk: torch.Tensor | None, bk: torch.Tensor | None,
    wv: torch.Tensor | None, sv: torch.Tensor | None, bv: torch.Tensor | None,
    # int8 [N*H, D], fp32 [D], [D]
    wo: torch.Tensor | None, so: torch.Tensor, bo: torch.Tensor,
    ln2_scale: torch.Tensor, ln2_bias: torch.Tensor,
    # int8 [D, F], fp32 [F], [F]
    w1: torch.Tensor | None, s1: torch.Tensor, b1: torch.Tensor,
    # int8 [F, D], fp32 [D], [D]
    w2: torch.Tensor | None, s2: torch.Tensor, b2: torch.Tensor,
    *,
    num_heads: int,
    dim_per_head: int,
    logit_cap: float = 0.0,
    epsilon: float = 1e-6,
    query_scale: float = 1.0,
    activation: str = 'gelu',
    head_chunks: int | None = None,
    ffn_chunks: int | None = None,
    # K10's and K9's operands together
    kmajor: dict[str, torch.Tensor] | None = None,
    impl: str = 'auto',
) -> torch.Tensor:
  """K11: a whole pre-norm layer in W8A8, each half's chunk products summed
  in fp32 and cast once -> [B, T, D].  Chunk counts default to the
  reference's ``_layer_int8_cfg``."""
  _check_activation(activation)
  b, t, d = x.shape
  nh = num_heads * dim_per_head
  f = s1.shape[0]
  if head_chunks is None or ffn_chunks is None:
    cfg = _layer_int8_cfg(t, d, nh, f, num_heads, x.element_size())
    if cfg is None:
      raise ValueError(f'no int8 layer configuration for T={t}, D={d}, '
                       f'N*H={nh}, F={f}')
    head_chunks, ffn_chunks = cfg
  if num_heads % head_chunks or f % ffn_chunks:
    raise ValueError(f'({head_chunks}, {ffn_chunks}) chunks do not divide '
                     f'{num_heads} heads and F={f}')
  on_card = _lib.use_kernel(impl, x)
  if not on_card or kmajor is None:
    attn_k, qkv, wo_t, hp = _attention_kmajor(
        (wq, sq, bq, wk, sk, bk, wv, sv, bv), wo, kmajor, x, num_heads,
        dim_per_head, on_card)
    if not on_card:
      static = dict(num_heads=num_heads, dim_per_head=hp,
                    logit_cap=float(logit_cap), epsilon=epsilon,
                    query_scale=float(query_scale))
      if kmajor is not None:
        w1, w2 = kmajor['w1'].transpose(-1, -2), kmajor['w2'].transpose(-1, -2)
      ctx = _reference_ctx(x, mask, ln1_scale, ln1_bias, *qkv, **static)
      x1 = _sum(_parts(ctx, wo_t, so, head_chunks), bo, x)
      keep = 1.0 - paddings.float()
      parts = _reference_hidden_parts(x1, keep, ln2_scale, ln2_bias, w1, s1,
                                      b1, w2, s2, chunks=ffn_chunks,
                                      activation=activation, epsilon=epsilon)
      return _sum(parts, b2, x1, keep)
    _check_shapes(w1.shape == (d, f) and w2.shape == (f, d), 'FFN operand')
    kmajor = dict(attn_k, **int8_ffn_kmajor(w1, w2))
  # The card: every operand checked in one pass, one scratch buffer (carved
  # by the C side), six launches.
  hp = padded_head_dim(dim_per_head)
  rows, nh = b * t, num_heads * hp
  wqkv, sqkv, bqkv = kmajor['wqkv'], kmajor['sqkv'], kmajor['bqkv']
  wo, w1, w2 = kmajor['wo'], kmajor['w1'], kmajor['w2']
  _lib.check_tensors(
      x.device, int8=_INT8, fp32=_FP32, x=x, mask=mask, paddings=paddings,
      ln1_scale=ln1_scale, ln1_bias=ln1_bias, wqkv=wqkv, sqkv=sqkv, bqkv=bqkv,
      wo=wo, so=so, bo=bo, ln2_scale=ln2_scale, ln2_bias=ln2_bias, w1=w1,
      s1=s1, b1=b1, w2=w2, s2=s2, b2=b2)
  _check_mask(mask, x)
  d1, n3 = (d,), (3 * nh,)
  _check_shapes(paddings.shape == (b, t, 1) and ln1_scale.shape == d1
                and ln1_bias.shape == d1 and wqkv.shape == (3 * nh, d)
                and sqkv.shape == n3 and bqkv.shape == n3
                and wo.shape == (d, nh) and so.shape == d1 and bo.shape == d1
                and ln2_scale.shape == d1 and ln2_bias.shape == d1
                and w1.shape == (f, d) and b1.shape == (f,)
                and w2.shape == (d, f) and s2.shape == d1 and b2.shape == d1,
                'layer operand')
  _check_multiple(D=d, NH=nh, head_group=nh // head_chunks, F=f,
                  F_chunk=f // ffn_chunks)
  _check_prologue(D=d)
  _check_prologue(head_chunks, head_group=nh // head_chunks)
  _check_core(t, hp)
  dev = x.device
  out = torch.empty_like(x)
  _lib.launch(
      'vp_int8_layer_block', dev, x, mask, paddings, ln1_scale, ln1_bias,
      wqkv, sqkv, bqkv, wo, so, bo, ln2_scale, ln2_bias, w1, s1, b1, w2, s2,
      b2, torch.empty(_layer_scratch_bytes(rows, d, nh, f, ffn_chunks),
                      dtype=torch.uint8, device=dev), out,
      b, t, d, num_heads, hp, f, mask.shape[0], mask.shape[1],
      head_chunks, ffn_chunks, ACTIVATIONS[activation], float(logit_cap),
      epsilon, float(query_scale))
  _lib.LAUNCHES['int8_layer_block'] += 1
  return out


@functools.lru_cache(maxsize=256)
def _layer_scratch_bytes(rows: int, d: int, nh: int, f: int,
                         ffn_chunks: int) -> int:
  """The bytes of K11's one scratch buffer (``csrc/int8_blocks.cu``
  ``layer_scratch``)."""
  return _lib.library().vp_int8_layer_scratch(rows, d, nh, f, ffn_chunks)


def int8_qkv_projection(
    x: torch.Tensor,                                       # [rows, D]
    ln_scale: torch.Tensor, ln_bias: torch.Tensor,         # [D]
    # int8 [D, N*H], fp32 [N*H], [N*H]
    wq: torch.Tensor | None, sq: torch.Tensor | None, bq: torch.Tensor | None,
    wk: torch.Tensor | None, sk: torch.Tensor | None, bk: torch.Tensor | None,
    wv: torch.Tensor | None, sv: torch.Tensor | None, bv: torch.Tensor | None,
    *,
    epsilon: float = 1e-6,
    query_scale: float = 1.0,
    kmajor: dict[str, torch.Tensor] | None = None,   # wqkv, sqkv, bqkv
    impl: str = 'auto',
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
  """K12a: LN + W8A8 q/k/v projections, the query scale folded into q ->
  q, k, v [rows, N*H] (on the card, column blocks of one [rows, 3*N*H]
  buffer, written by one product)."""
  weights = (wq, sq, bq, wk, sk, bk, wv, sv, bv)
  on_card = _lib.use_kernel(impl, x)
  nh = (kmajor['sqkv'].shape[0] // 3 if kmajor is not None
        else sq.shape[0])
  if kmajor is None and on_card:
    # One head of N*H: the projection has no head geometry to pad.
    kmajor, weights, _, _ = _attention_kmajor(weights, None, None, x, 1, nh,
                                              on_card)
  elif kmajor is not None:
    weights = _qkv_views(kmajor, nh)
  if not on_card:
    return _reference_qkv(x, ln_scale, ln_bias, *weights, epsilon=epsilon,
                          query_scale=float(query_scale))
  rows, d = x.shape
  wqkv, sqkv, bqkv = kmajor['wqkv'], kmajor['sqkv'], kmajor['bqkv']
  _lib.check_tensors(x.device, int8=('wqkv',), fp32=('sqkv',), x=x,
                     ln_scale=ln_scale, ln_bias=ln_bias, wqkv=wqkv, sqkv=sqkv,
                     bqkv=bqkv)
  _check_shapes(ln_scale.shape == (d,) and ln_bias.shape == (d,)
                and wqkv.shape == (3 * nh, d) and sqkv.shape == (3 * nh,)
                and bqkv.shape == (3 * nh,), 'projection weight')
  _check_multiple(D=d, NH=nh)
  _check_prologue(D=d)
  dev = x.device
  qkv = torch.empty((rows, 3 * nh), dtype=x.dtype, device=dev)
  _lib.launch('vp_int8_qkv_projection', dev, x, ln_scale, ln_bias, wqkv, sqkv,
              bqkv, qkv, rows, d, nh, epsilon, float(query_scale))
  _lib.LAUNCHES['int8_qkv_projection'] += 1
  return qkv[:, :nh], qkv[:, nh:2 * nh], qkv[:, 2 * nh:]


def int8_out_projection(
    ctx: torch.Tensor,        # [rows, N*H]
    resid: torch.Tensor,      # [rows, D] (the pre-attention input)
    # int8 [N*H, D], fp32 [D], [D]
    wo: torch.Tensor | None, so: torch.Tensor, bo: torch.Tensor,
    *,
    partial_out: bool = False,
    kmajor: dict[str, torch.Tensor] | None = None,   # wo [D, N*H]
    impl: str = 'auto',
) -> torch.Tensor:
  """K12b: W8A8 output projection + bias + residual -> [rows, D] in
  resid's dtype (on the card one launch: ctx quantized in the product's
  prologue)."""
  check_partial_out(partial_out)
  on_card = _lib.use_kernel(impl, ctx)
  if kmajor is not None:
    wo = kmajor['wo'].transpose(-1, -2)
  if not on_card:
    return _chain(_parts(ctx, wo, so, 1), bo, resid)
  rows, nh = ctx.shape
  d = resid.shape[1]
  if kmajor is None:
    _check_shapes(wo.shape == (nh, d), 'out-projection operand')
    kmajor = {'wo': wo.t().contiguous()}
  wo = kmajor['wo']
  _lib.check_tensors(ctx.device, int8=_INT8, fp32=_FP32, ctx=ctx, resid=resid,
                     wo=wo, so=so, bo=bo)
  _check_shapes(resid.shape == (rows, d) and wo.shape == (d, nh)
                and so.shape == (d,) and bo.shape == (d,),
                'out-projection operand')
  _check_multiple(D=d, NH=nh)
  _check_prologue(NH=nh)
  out = torch.empty_like(resid)
  _lib.launch('vp_int8_out_projection', ctx.device, ctx, resid, wo, so, bo,
              out, rows, nh, d)
  _lib.LAUNCHES['int8_out_projection'] += 1
  return out


def int8_projected_flash_attention(
    x: torch.Tensor,            # [B, T, D]
    atten_mask: torch.Tensor,   # [B|1, 1, T|1, T] additive fp32
    ln_scale: torch.Tensor, ln_bias: torch.Tensor,
    wq: torch.Tensor | None, sq: torch.Tensor | None, bq: torch.Tensor | None,
    wk: torch.Tensor | None, sk: torch.Tensor | None, bk: torch.Tensor | None,
    wv: torch.Tensor | None, sv: torch.Tensor | None, bv: torch.Tensor | None,
    wo: torch.Tensor | None, so: torch.Tensor, bo: torch.Tensor,
    *,
    num_heads: int,
    dim_per_head: int,
    logit_cap: float = 0.0,
    epsilon: float = 1e-6,
    query_scale: float = 1.0,
    partial_out: bool = False,
    kmajor: dict[str, torch.Tensor] | None = None,   # as K10's
    impl: str = 'auto',
) -> torch.Tensor:
  """The attention half for any T: K12a -> K5 (``flash_attention``) ->
  K12b; returns ``x + attn(x)`` [B, T, D]."""
  check_partial_out(partial_out)
  b, t, d = x.shape
  kmajor, _, _, h = _attention_kmajor(
      (wq, sq, bq, wk, sk, bk, wv, sv, bv), wo, kmajor, x, num_heads,
      dim_per_head, _lib.use_kernel(impl, x))
  n = num_heads
  x2d = x.reshape(b * t, d)
  q, k, v = int8_qkv_projection(
      x2d, ln_scale, ln_bias, wq, sq, bq, wk, sk, bk, wv, sv, bv,
      epsilon=epsilon, query_scale=query_scale, kmajor=kmajor, impl=impl)
  heads = lambda a: a.reshape(b, t, n, h).transpose(1, 2).contiguous()
  ctx = flash.fused_attention(heads(q), heads(k), heads(v),
                              atten_mask.squeeze(1).float().contiguous(),
                              logit_cap=logit_cap, impl=impl)
  ctx = ctx.transpose(1, 2).reshape(b * t, n * h)
  out = int8_out_projection(ctx, x2d, wo, so, bo, kmajor=kmajor, impl=impl)
  return out.reshape(b, t, d)


# ---------------------------------------------------------------------------
# The int8 GEMM alone.
# ---------------------------------------------------------------------------

GEMM_I8_EPILOGUES = {'qkv': 0, 'act_keep': 1, 'residual': 2, 'int32': 3}


def gemm_i8(a: torch.Tensor, b: torch.Tensor, *, epilogue: str = 'int32',
            a_scale: torch.Tensor | None = None,
            b_scale: torch.Tensor | None = None,
            bias: torch.Tensor | None = None,
            pads: torch.Tensor | None = None,
            residual: torch.Tensor | None = None,
            acc_in: torch.Tensor | None = None,
            acc_out: torch.Tensor | None = None,
            activation: str | None = None, col_scale: float = 1.0,
            scaled_cols: int = 0) -> torch.Tensor | None:
  """The product stage of K9-K12b alone, for measurement and for composing
  the blocks from their primitives: ``epilogue(a int8 [M, K] @ b int8 [N,
  K]^T)`` -> [M, N] through the hand-written s8 wgmma GEMM
  (``csrc/int8_blocks.cu``, A's codes by TMA): 'int32' the exact sums
  (int32), else v = (float(sum) * a_scale[m]) * b_scale[n] and 'qkv': v +
  bias, x ``col_scale`` on the first ``scaled_cols`` columns (bf16);
  'act_keep': act(v + bias) x keep (fp32); 'residual': ``acc_in`` + v
  when given, written to ``acc_out`` (fp32 [M, N]; returns None) when
  given, else (v [+ bias]) [x keep] [+ residual] (bf16).  CUDA tensors
  only: the blocks' twins are its plain versions."""
  m, k = a.shape
  n = b.shape[0]
  _lib.check(a.is_cuda, 'gemm_i8 runs on CUDA tensors only')
  operands = dict(a=a, b=b, a_scale=a_scale, b_scale=b_scale, bias=bias,
                  pads=pads, residual=residual, acc_in=acc_in,
                  acc_out=acc_out)
  _lib.check_tensors(a.device, int8=('a', 'b'),
                     fp32=('a_scale', 'b_scale', 'acc_in', 'acc_out'),
                     **{key: t for key, t in operands.items()
                        if t is not None})
  _lib.check(b.shape[1] == k and k % 16 == 0 and n % 8 == 0,
             f'a {tuple(a.shape)} @ b {tuple(b.shape)}^T: K must agree and '
             'be a multiple of 16, N of 8')
  _lib.check(epilogue == 'int32' or (a_scale is not None
                                     and b_scale is not None),
             f"epilogue {epilogue!r} needs a_scale and b_scale")
  _lib.check((acc_in is None and acc_out is None) or epilogue == 'residual',
             "acc_in and acc_out go with epilogue 'residual'")
  _lib.check(all(t is None or t.shape == (m, n) for t in (acc_in, acc_out)),
             f'acc_in and acc_out must be [{m}, {n}]')
  dtype = {'int32': torch.int32, 'act_keep': torch.float32}.get(
      epilogue, torch.bfloat16)
  out = None if acc_out is not None else torch.empty(
      (m, n), dtype=dtype, device=a.device)
  _lib.launch('vp_gemm_i8', a.device, a, b, a_scale, b_scale, bias, pads,
              residual, acc_in, acc_out, out, m, n, k,
              GEMM_I8_EPILOGUES[epilogue], ACTIVATIONS.get(activation, 0),
              col_scale, scaled_cols)
  return out


def quantize_rows(x: torch.Tensor, *, chunks: int = 1,
                  ln_scale: torch.Tensor | None = None,
                  ln_bias: torch.Tensor | None = None,
                  epsilon: float = 1e-6) -> tuple[torch.Tensor, torch.Tensor]:
  """The blocks' standalone quantizer alone (``quant_rows_kernel``, or
  ``quant_rows_f32_kernel`` for fp32 rows), for measurement and for
  composing the blocks from their primitives: x [rows, chunks * cols]
  (bf16 or fp32), with the fp32 LN in front when ``ln_scale`` is given ->
  (codes int8 [rows, chunks * cols], scales fp32 [rows, chunks]).  CUDA
  tensors only: :func:`quant_rows` is its plain version."""
  rows, width = x.shape
  _lib.check(x.is_cuda and width % chunks == 0,
             f'quantize_rows runs on CUDA tensors, {chunks} chunks dividing '
             f'{width} columns')
  fp32 = x.dtype == torch.float32
  _lib.check_tensors(x.device, fp32=('x',) if fp32 else (), x=x,
                     **({} if ln_scale is None
                        else dict(ln_scale=ln_scale, ln_bias=ln_bias)))
  q = torch.empty((rows, width), dtype=torch.int8, device=x.device)
  scale = torch.empty((rows, chunks), dtype=torch.float32, device=x.device)
  _lib.launch('vp_quant_rows', x.device, x, ln_scale, ln_bias, q, scale, rows,
              width // chunks, chunks, int(fp32), epsilon)
  return q, scale


def capped_core(qkv: torch.Tensor, mask: torch.Tensor, *, batch: int,
                num_heads: int, head_dim: int,
                logit_cap: float) -> torch.Tensor:
  """K1's attention core alone over the fused q|k|v [B*T, 3*N*H] (q
  already scaled), the additive fp32 mask [B|1, T|1, T] -> ctx [B*T, N*H]:
  for composing K10 and K11 from their primitives.  CUDA tensors only."""
  rows = qkv.shape[0]
  t = rows // batch
  _lib.check(qkv.is_cuda and qkv.shape[1] == 3 * num_heads * head_dim,
             'capped_core takes a CUDA q|k|v of 3 * N * H columns')
  _lib.check_tensors(qkv.device, qkv=qkv, mask=mask)
  ctx = torch.empty((rows, num_heads * head_dim), dtype=qkv.dtype,
                    device=qkv.device)
  _lib.launch('vp_capped_attention', qkv.device, qkv, mask, ctx, batch, t,
              num_heads, head_dim, mask.shape[0], mask.shape[1],
              float(logit_cap))
  return ctx


# ---------------------------------------------------------------------------
# The reference's rule for the int8 routes and chunk counts, copied as pure
# arithmetic (videoprism_tpu/ops/pallas/int8_blocks.py _INT8_BUDGET,
# _ffn_int8_row_block, ffn_int8_chunks_for, _attn_int8_chunk_fits,
# attention_int8_chunks_for, _LAYER_BUDGET, _LAYER_ATTN_GROUP_CAP,
# _layer_int8_cfg, int8_layer_supported, _qkv_int8_row_block,
# _out_int8_row_block, attn_int8_projection_supported).  The budgets are
# the TPU's VMEM and tile nothing on Hopper; they are kept because the
# route (K11 or K10 + K9 or K12) and the chunk counts change the rounding
# (the scale of ctx and of the hidden activation per chunk, a cast per
# chained chunk), so the port takes the reference's route to round as it
# does.
# ---------------------------------------------------------------------------

_INT8_BUDGET = 14 * 2**20


def _ffn_int8_row_block(rows: int, d: int, f_chunk: int,
                        act_itemsize: int) -> int | None:
  weights = 2 * d * f_chunk
  for block in (512, 256, 128, 64, 32, 16, 8):
    if rows % block:
      continue
    io = 2 * (3 * block * d * act_itemsize)
    scratch = (block * d * 5 + block * f_chunk * 9 + block * d * 4)
    if weights + io + scratch <= _INT8_BUDGET:
      return block
  return None


def ffn_int8_chunks_for(rows: int, d: int, f: int,
                        act_itemsize: int) -> int | None:
  for chunks in (1, 2, 4, 8):
    if f % chunks:
      continue
    if _ffn_int8_row_block(rows, d, f // chunks, act_itemsize) is not None:
      return chunks
  return None


def _attn_int8_chunk_fits(t: int, d: int, gh: int, act_itemsize: int) -> bool:
  weights = 4 * d * gh
  temps = (t * d * 5
           + 3 * t * gh * (4 + act_itemsize + 1)
           + t * t * 4
           + t * gh * (act_itemsize + 1)
           + t * d * 4)
  return weights + temps < _INT8_BUDGET


def attention_int8_chunks_for(t: int, d: int, num_heads: int,
                              dim_per_head: int,
                              act_itemsize: int) -> int | None:
  if not (t % 8 == 0 and t <= 1024 and d % 128 == 0):
    return None
  for chunks in (1, 2, 4):
    if num_heads % chunks:
      continue
    if _attn_int8_chunk_fits(t, d, (num_heads // chunks) * dim_per_head,
                             act_itemsize):
      return chunks
  return None


_LAYER_BUDGET = 17 * 2**20
_LAYER_ATTN_GROUP_CAP = int(2.5 * 2**20)


def _layer_int8_cfg(t: int, d: int, nh_total: int, f: int, num_heads: int,
                    act_itemsize: int) -> tuple[int, int] | None:
  """(head_chunks, ffn_chunks) of K11, or None where the reference does
  not run it."""
  if not (t % 8 == 0 and t <= 1024 and d % 128 == 0
          and nh_total % 128 == 0 and f % 128 == 0):
    return None
  weights = 4 * d * nh_total + 2 * d * f
  persistent = (2 * 2 * t * d * act_itemsize + 2 * t * t * 4 + t * d * 5
                + t * d * act_itemsize + t * d * 4)

  def attn_peak(gh):
    return (3 * t * gh * (4 + act_itemsize) + t * t * 4
            + t * gh * (act_itemsize + 1))

  head_chunks = None
  for hc in (1, 2, 4):
    if num_heads % hc or (nh_total // hc) % 128:
      continue
    if attn_peak(nh_total // hc) <= _LAYER_ATTN_GROUP_CAP:
      head_chunks = hc
      break
  if head_chunks is None:
    return None
  for fcks in (1, 2, 4, 8):
    if f % fcks or (f // fcks) % 128:
      continue
    ffn_peak = t * (f // fcks) * (4 + act_itemsize + 1)
    if (weights + persistent
        + max(attn_peak(nh_total // head_chunks), ffn_peak)
        <= _LAYER_BUDGET):
      return head_chunks, fcks
  return None


def int8_layer_supported(t: int, d: int, nh_total: int, f: int,
                         num_heads: int, act_itemsize: int) -> bool:
  return _layer_int8_cfg(t, d, nh_total, f, num_heads,
                         act_itemsize) is not None


def _qkv_int8_row_block(rows: int, d: int, nh: int,
                        act_itemsize: int) -> int | None:
  weights = 3 * d * nh
  for block in (512, 256, 128, 64, 32, 16, 8):
    if rows % block:
      continue
    io = 2 * (block * d + 3 * block * nh) * act_itemsize
    temps = block * d * 5 + 3 * block * nh * 4
    if weights + io + temps <= _INT8_BUDGET:
      return block
  return None


def _out_int8_row_block(rows: int, nh: int, d: int,
                        act_itemsize: int) -> int | None:
  weights = nh * d
  for block in (512, 256, 128, 64, 32, 16, 8):
    if rows % block:
      continue
    io = 2 * (block * nh + 2 * block * d) * act_itemsize
    temps = block * nh * 5 + block * d * 4
    if weights + io + temps <= _INT8_BUDGET:
      return block
  return None


def attn_int8_projection_supported(rows: int, d: int, nh: int,
                                   act_itemsize: int) -> bool:
  return (d % 128 == 0 and nh % 128 == 0
          and _qkv_int8_row_block(rows, d, nh, act_itemsize) is not None
          and _out_int8_row_block(rows, nh, d, act_itemsize) is not None)

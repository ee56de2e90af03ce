"""K1, K2, K8a and K8b: the fused pre-norm attention and FFN half-layers.

Ports ``videoprism_tpu/ops/pallas/transformer_block.py``
``fused_attention_block`` (K1), ``fused_ffn_block`` (K2) and their
chunked chains ``fused_attention_block_chunked`` (K8a, head groups) and
``fused_ffn_block_chunked`` (K8b, F-slices).  On a CUDA tensor each
wrapper runs its chain of hand-written kernels
(``csrc/transformer_block.cu``); on a CPU tensor, or with
``impl='reference'``, it runs the plain PyTorch twin beside it, which rounds
to the activation dtype at the same points as the kernels:

  K1: h = LN(x) in fp32 -> dtype; q|k|v = h @ W + b in fp32, q * query_scale,
      -> dtype; per-head fp32 logits, cap * tanh(l / cap), select mask, exp,
      fp32 normalisation (fully-masked rows uniform 1/S; row max when
      cap = 0) -> probs in dtype; ctx = probs @ v in fp32 -> dtype;
      out = ctx @ Wo + bo + x in fp32 -> dtype.
  K2: h = LN(x) -> dtype; a = act(h @ W1 + b1) * keep -> dtype;
      out = (a @ W2 + b2) * keep + x in fp32 -> dtype.
  K8a, K8b: as K1, K2 up to ctx or a; then the last product is split into
      ``chunks`` K-slices with a cast after each (:func:`_residual_chain`):
      out_0 = (a_0 @ W_0 + bias) [* keep] + x, out_c = a_c @ W_c [* keep]
      + out_{c-1}, each in fp32 -> dtype.  (The TPU recomputes LN and the
      head group's q|k|v per chunk; those are the same bits every time.)

GELU is the exact erf form (the TPU kernel's erf polynomial exists only
because Mosaic has no erf).  The kernels take bf16 (the served dtype) and
raise on fp32 CUDA tensors; fp32 on the card runs with
``impl='reference'``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from videoprism_tpu_torch.ops.kernels import _lib

# -0.7 * float32 max and the select threshold half of it (ops/masks.py).
NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)
MASK_THRESHOLD = NEG_INF * 0.5
ACTIVATIONS = {'gelu': 1, 'relu': 2}


def ln_f32(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
           epsilon: float, direct_scale: bool = False) -> torch.Tensor:
  """LayerNorm over the last axis in fp32 with the (scale + 1) convention
  (the scale itself with ``direct_scale``); returns fp32."""
  xf = x.float()
  mean = xf.mean(-1, keepdim=True)
  var = (xf - mean).square().mean(-1, keepdim=True)
  normed = (xf - mean) * torch.rsqrt(var + epsilon)
  scale = scale.float() if direct_scale else scale.float() + 1.0
  return normed * scale + bias.float()


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mask: torch.Tensor, *, logit_cap: float,
                   dtype: torch.dtype) -> torch.Tensor:
  """Head-major capped softmax attention, as the TPU kernels round it.

  q [B, N, T, H], k and v [B, N, S, H] (any float dtype), mask
  [B|1, T|1, S] additive; returns [B, N, T, H] in ``dtype``.  fp32 logits,
  ``cap * tanh(l / cap)`` before the select-mask, exp with masked entries
  zeroed and fully masked rows uniform 1/S (the row max only when cap = 0),
  fp32 normalisation, probs cast to ``dtype``, probs @ v in fp32.
  """
  s = k.shape[2]
  logits = q.float() @ k.float().transpose(-1, -2)        # [B, N, T, S]
  ok = (mask >= MASK_THRESHOLD)[:, None]                  # [B|1, 1, T|1, S]
  if logit_cap > 0.0:
    logits = logit_cap * torch.tanh(logits * (1.0 / logit_cap))
    unnorm = torch.where(ok, torch.exp(logits), 0.0)
    denom = unnorm.sum(-1, keepdim=True)
    unnorm = torch.where(denom == 0.0, 1.0, unnorm)
    denom = torch.where(denom == 0.0, float(s), denom)
  else:
    logits = torch.where(ok, logits, NEG_INF)
    unnorm = torch.exp(logits - logits.amax(-1, keepdim=True))
    denom = unnorm.sum(-1, keepdim=True)
  probs = (unnorm / denom).to(dtype)
  return (probs.float() @ v.float()).to(dtype)


def _residual_chain(a, w, bias, x, chunks, keep=None):
  """The last product of the twins: ``a @ w`` over ``chunks`` K-slices,
  bias in the first, times ``keep`` when given, plus the residual (``x``,
  then the previous chunk's output), in fp32 and cast after each slice."""
  kc = a.shape[-1] // chunks
  out = x
  for c in range(chunks):
    part = a[..., c * kc:(c + 1) * kc].float() @ w[c * kc:(c + 1) * kc].float()
    if c == 0:
      part = part + bias.float()
    if keep is not None:
      part = part * keep
    out = (part + out.float()).to(x.dtype)
  return out


def _reference_attention_ctx(x, mask, ln_scale, ln_bias, wqkv, bqkv, *,
                             num_heads, dim_per_head, logit_cap, epsilon,
                             query_scale):
  """LN, the fused q|k|v projection and the attention core of K1 and K8a
  -> ctx [B, T, N*H] in x's dtype."""
  b, t, _ = x.shape
  n, hd = num_heads, dim_per_head
  nh = n * hd
  h = ln_f32(x, ln_scale, ln_bias, epsilon).to(x.dtype)
  qkv = h.float() @ wqkv.float() + bqkv.float()
  q, k, v = qkv.split(nh, dim=-1)
  q, k, v = (q * query_scale).to(x.dtype), k.to(x.dtype), v.to(x.dtype)
  heads = lambda a: a.reshape(b, t, n, hd).transpose(1, 2)
  ctx = attention_core(heads(q), heads(k), heads(v), mask,
                       logit_cap=logit_cap, dtype=x.dtype)  # [B, N, T, H]
  return ctx.transpose(1, 2).reshape(b, t, nh)


def _reference_attention_block(x, mask, ln_scale, ln_bias, wqkv, bqkv, wo, bo,
                               **static):
  """Plain twin of K1 (same op order and rounding points)."""
  ctx = _reference_attention_ctx(x, mask, ln_scale, ln_bias, wqkv, bqkv,
                                 **static)
  return _residual_chain(ctx, wo, bo, x, 1)


def _reference_attention_block_chunked(x, mask, ln_scale, ln_bias, wqkv, bqkv,
                                       wo, bo, *, chunks, **static):
  """Plain twin of K8a (same op order and rounding points)."""
  ctx = _reference_attention_ctx(x, mask, ln_scale, ln_bias, wqkv, bqkv,
                                 **static)
  return _residual_chain(ctx, wo, bo, x, chunks)


def check_partial_out(partial_out: bool) -> None:
  if partial_out:
    raise NotImplementedError(
        'partial_out (tensor parallelism, primer_hybrid) is not ported yet; '
        'see ROADMAP.md, queue 1 items 3 and 13')


def _launch_attention(x, mask, ln_scale, ln_bias, wqkv, bqkv, wo, bo, *,
                      num_heads, dim_per_head, chunks, logit_cap, epsilon,
                      query_scale):
  """Checks K1's (``chunks=1``) or K8a's operands and launches it."""
  b, t, d = x.shape
  nh = num_heads * dim_per_head
  _lib.check_tensors(x.device, x=x, mask=mask, ln_scale=ln_scale,
                     ln_bias=ln_bias, wqkv=wqkv, bqkv=bqkv, wo=wo, bo=bo)
  _lib.check(mask.ndim == 3 and mask.shape[0] in (1, b)
             and mask.shape[1] in (1, t) and mask.shape[2] == t,
             f'mask {tuple(mask.shape)} does not fit x {tuple(x.shape)}')
  _lib.check(ln_scale.shape == (d,) and ln_bias.shape == (d,)
             and wqkv.shape == (d, 3 * nh) and bqkv.shape == (3 * nh,)
             and wo.shape == (nh, d) and bo.shape == (d,),
             'weight shapes do not match x and the head geometry')
  _lib.check(d % 8 == 0, f'model dim {d} must be a multiple of 8')
  _lib.check(dim_per_head % 8 == 0,
             f'dim_per_head {dim_per_head} must be a multiple of 8')
  _lib.check(_lib.attention_fits(t, dim_per_head),
             f"T={t}, H={dim_per_head} exceed the attention kernel's shared "
             f'memory (it holds T <= {_lib.max_attention_t(dim_per_head)} at '
             f'H={dim_per_head})')
  h = torch.empty((b * t, d), dtype=x.dtype, device=x.device)
  qkv = torch.empty((b * t, 3 * nh), dtype=x.dtype, device=x.device)
  ctx = torch.empty((b * t, nh), dtype=x.dtype, device=x.device)
  tmp = torch.empty_like(x) if chunks > 1 else None
  out = torch.empty_like(x)
  _lib.launch('vp_attention_block', x.device, x, mask, ln_scale, ln_bias,
              wqkv, bqkv, wo, bo, h, qkv, ctx, tmp, out, b, t, d, num_heads,
              dim_per_head, mask.shape[0], mask.shape[1], chunks,
              float(logit_cap), epsilon, float(query_scale))
  return out


def fused_attention_block(
    x: torch.Tensor,          # [B, T, D]
    mask: torch.Tensor,       # [B|1, T|1, T] additive fp32
    ln_scale: torch.Tensor, ln_bias: torch.Tensor,   # [D]
    wqkv: torch.Tensor, bqkv: torch.Tensor,          # [D, 3*N*H], [3*N*H]
    wo: torch.Tensor, bo: torch.Tensor,              # [N*H, D], [D]
    *,
    num_heads: int,
    dim_per_head: int,
    logit_cap: float = 0.0,
    epsilon: float = 1e-6,
    query_scale: float = 1.0,
    partial_out: bool = False,
    impl: str = 'auto',
) -> torch.Tensor:
  """Pre-LN attention half-layer: ``x + Attn(LN(x))`` -> [B, T, D].

  The JAX signature with the q/k/v weights fused along the output axis
  (``Wqkv = [Wq | Wk | Wv]``), as :func:`io.checkpoints.prepare_for_kernels`
  builds them once at load time.
  """
  check_partial_out(partial_out)
  static = dict(num_heads=num_heads, dim_per_head=dim_per_head,
                logit_cap=float(logit_cap), epsilon=epsilon,
                query_scale=float(query_scale))
  if not _lib.use_kernel(impl, x):
    return _reference_attention_block(
        x, mask, ln_scale, ln_bias, wqkv, bqkv, wo, bo, **static)
  out = _launch_attention(x, mask, ln_scale, ln_bias, wqkv, bqkv, wo, bo,
                          chunks=1, **static)
  _lib.LAUNCHES['fused_attention_block'] += 1
  return out


def fused_attention_block_chunked(
    x: torch.Tensor,          # [B, T, D]
    mask: torch.Tensor,       # [B|1, T|1, T] additive fp32
    ln_scale: torch.Tensor, ln_bias: torch.Tensor,   # [D]
    wqkv: torch.Tensor, bqkv: torch.Tensor,          # [D, 3*N*H], [3*N*H]
    wo: torch.Tensor, bo: torch.Tensor,              # [N*H, D], [D]
    *,
    num_heads: int,
    dim_per_head: int,
    chunks: int,
    logit_cap: float = 0.0,
    epsilon: float = 1e-6,
    query_scale: float = 1.0,
    partial_out: bool = False,
    impl: str = 'auto',
) -> torch.Tensor:
  """K1 over ``chunks`` head groups, each group's output cast and used as
  the next group's residual -> [B, T, D] (the JAX signature, with the
  fused weight layout of :func:`fused_attention_block`)."""
  check_partial_out(partial_out)
  static = dict(num_heads=num_heads, dim_per_head=dim_per_head,
                logit_cap=float(logit_cap), epsilon=epsilon,
                query_scale=float(query_scale))
  if chunks < 1 or num_heads % chunks:
    raise ValueError(f'{chunks} chunks do not divide {num_heads} heads')
  if not _lib.use_kernel(impl, x):
    return _reference_attention_block_chunked(
        x, mask, ln_scale, ln_bias, wqkv, bqkv, wo, bo, chunks=chunks,
        **static)
  out = _launch_attention(x, mask, ln_scale, ln_bias, wqkv, bqkv, wo, bo,
                          chunks=chunks, **static)
  _lib.LAUNCHES['fused_attention_block_chunked'] += 1
  return out


def _reference_ffn_hidden(x, paddings, ln_scale, ln_bias, w1, b1, *,
                          activation, epsilon):
  """LN, the first product, activation and padding keep of K2 and K8b ->
  (a [rows, F] in x's dtype, keep [rows, 1] fp32)."""
  keep = 1.0 - paddings.float()
  h = ln_f32(x, ln_scale, ln_bias, epsilon).to(x.dtype)
  a = h.float() @ w1.float() + b1.float()
  a = F.gelu(a) if activation == 'gelu' else torch.relu(a)
  return (a * keep).to(x.dtype), keep


def _reference_ffn_block(x, paddings, ln_scale, ln_bias, w1, b1, w2, b2, *,
                         chunks=1, **static):
  """Plain twin of K2 (``chunks=1``) and of K8b (same op order and
  rounding points)."""
  a, keep = _reference_ffn_hidden(x, paddings, ln_scale, ln_bias, w1, b1,
                                  **static)
  return _residual_chain(a, w2, b2, x, chunks, keep)


def _launch_ffn(x, paddings, ln_scale, ln_bias, w1, b1, w2, b2, *, chunks,
                activation, epsilon):
  """Checks K2's (``chunks=1``) or K8b's operands and launches it."""
  rows, d = x.shape
  f = w1.shape[1]
  _lib.check_tensors(x.device, x=x, paddings=paddings, ln_scale=ln_scale,
                     ln_bias=ln_bias, w1=w1, b1=b1, w2=w2, b2=b2)
  _lib.check(paddings.shape == (rows, 1) and ln_scale.shape == (d,)
             and ln_bias.shape == (d,) and w1.shape == (d, f)
             and b1.shape == (f,) and w2.shape == (f, d) and b2.shape == (d,),
             'FFN operand shapes do not match x')
  _lib.check(d % 8 == 0 and f % 8 == 0,
             f'model dim {d} and hidden dim {f} must be multiples of 8')
  # A chunk's F-slice is read in place from a [rows, F]: its offset must
  # keep 16-byte rows.  The GEMM masks a slice that is not a multiple of
  # its 32-deep tile.
  _lib.check((f // chunks) % 8 == 0,
             f'{chunks} chunks of hidden dim {f} must be multiples of 8')
  h = torch.empty_like(x)
  a = torch.empty((rows, f), dtype=x.dtype, device=x.device)
  tmp = torch.empty_like(x) if chunks > 1 else None
  out = torch.empty_like(x)
  _lib.launch('vp_ffn_block', x.device, x, paddings, ln_scale, ln_bias, w1,
              b1, w2, b2, h, a, tmp, out, rows, d, f, chunks,
              ACTIVATIONS[activation], epsilon)
  return out


def fused_ffn_block(
    x: torch.Tensor,                 # [rows, D]
    paddings: torch.Tensor,          # [rows, 1] (1.0 = padded row)
    ln_scale: torch.Tensor, ln_bias: torch.Tensor,   # [D]
    w1: torch.Tensor, b1: torch.Tensor,              # [D, F], [F]
    w2: torch.Tensor, b2: torch.Tensor,              # [F, D], [D]
    *,
    activation: str = 'gelu',
    epsilon: float = 1e-6,
    partial_out: bool = False,
    impl: str = 'auto',
) -> torch.Tensor:
  """Pre-LN FFN half-layer: ``x + keep * FFN(LN(x))`` -> [rows, D]."""
  check_partial_out(partial_out)
  if activation not in ACTIVATIONS:
    raise ValueError(f'activation must be gelu or relu, got {activation!r}')
  static = dict(activation=activation, epsilon=epsilon)
  if not _lib.use_kernel(impl, x):
    return _reference_ffn_block(x, paddings, ln_scale, ln_bias, w1, b1, w2,
                                b2, **static)
  out = _launch_ffn(x, paddings, ln_scale, ln_bias, w1, b1, w2, b2, chunks=1,
                    **static)
  _lib.LAUNCHES['fused_ffn_block'] += 1
  return out


def fused_ffn_block_chunked(
    x: torch.Tensor,                 # [rows, D]
    paddings: torch.Tensor,          # [rows, 1] (1.0 = padded row)
    ln_scale: torch.Tensor, ln_bias: torch.Tensor,   # [D]
    w1: torch.Tensor, b1: torch.Tensor,              # [D, F], [F]
    w2: torch.Tensor, b2: torch.Tensor,              # [F, D], [D]
    *,
    chunks: int,
    activation: str = 'gelu',
    epsilon: float = 1e-6,
    partial_out: bool = False,
    impl: str = 'auto',
) -> torch.Tensor:
  """K2 over ``chunks`` F-slices, each slice's output cast and used as the
  next slice's residual (b2 in the first only) -> [rows, D]."""
  check_partial_out(partial_out)
  if activation not in ACTIVATIONS:
    raise ValueError(f'activation must be gelu or relu, got {activation!r}')
  static = dict(activation=activation, epsilon=epsilon)
  if chunks < 1 or w1.shape[1] % chunks:
    raise ValueError(f'{chunks} chunks do not divide F={w1.shape[1]}')
  if not _lib.use_kernel(impl, x):
    return _reference_ffn_block(x, paddings, ln_scale, ln_bias, w1, b1, w2,
                                b2, chunks=chunks, **static)
  out = _launch_ffn(x, paddings, ln_scale, ln_bias, w1, b1, w2, b2,
                    chunks=chunks, **static)
  _lib.LAUNCHES['fused_ffn_block_chunked'] += 1
  return out


# ---------------------------------------------------------------------------
# The reference's rule for choosing the chunk counts of K8a and K8b, copied
# as pure arithmetic (videoprism_tpu/ops/pallas/transformer_block.py
# attention_block_supported, _attn_chunk_fits, attention_chunks_for,
# _ffn_row_block, ffn_block_supported, _ffn_chunk_row_block,
# ffn_chunks_for).  The budgets are the TPU's VMEM and mean nothing on
# Hopper; they are kept only because the chunk count changes the rounding
# (one more bf16 cast of the residual stream per extra chunk), so the port
# chains where the reference chains, as often, to round as it does.
# ---------------------------------------------------------------------------

_FFN_BUDGET = 15 * 2**20


def attention_block_supported(t: int, d: int, nh_total: int,
                              itemsize: int) -> bool:
  weights = 4 * d * nh_total * itemsize
  temps = (t * d + 4 * t * nh_total) * itemsize + t * t * 4 + t * d * 4
  return (
      t % 8 == 0 and t <= 1024 and d % 128 == 0 and nh_total % 128 == 0
      and weights + temps < 14 * 2**20)


def _attn_chunk_fits(t: int, d: int, gh: int, itemsize: int) -> bool:
  weights = 4 * d * gh * itemsize
  temps = (t * d * itemsize
           + 3 * t * gh * (4 + itemsize)
           + t * t * 4
           + t * gh * itemsize
           + t * d * 4)
  return weights + temps < 14 * 2**20


def attention_chunks_for(t: int, d: int, num_heads: int, dim_per_head: int,
                         itemsize: int) -> int | None:
  """The reference's head-group count for K8a; None where it runs K1 or
  no chunking fits."""
  nh_total = num_heads * dim_per_head
  if not (t % 8 == 0 and t <= 1024 and d % 128 == 0):
    return None
  if attention_block_supported(t, d, nh_total, itemsize):
    return None
  for chunks in (2, 4):
    if num_heads % chunks:
      continue
    if _attn_chunk_fits(t, d, (num_heads // chunks) * dim_per_head,
                        itemsize):
      return chunks
  return None


def _ffn_row_block(rows: int, d: int, f: int, itemsize: int) -> int | None:
  weights = 2 * d * f * itemsize
  for block in (512, 256, 128, 64, 32, 16, 8):
    if rows % block:
      continue
    io = 2 * (2 * block * d * itemsize)
    scratch = block * f * (4 + itemsize) + 2 * block * d * 4
    if weights + io + scratch <= _FFN_BUDGET:
      return block
  return None


def ffn_block_supported(rows: int, d: int, f: int, itemsize: int) -> bool:
  return (
      d % 128 == 0 and f % 128 == 0
      and _ffn_row_block(rows, d, f, itemsize) is not None)


def _ffn_chunk_row_block(rows: int, d: int, f_chunk: int,
                         itemsize: int) -> int | None:
  weights = 2 * d * f_chunk * itemsize
  for block in (512, 256, 128, 64, 32, 16, 8):
    if rows % block:
      continue
    io = 2 * (3 * block * d * itemsize)
    scratch = block * f_chunk * (4 + itemsize) + 2 * block * d * 4
    if weights + io + scratch <= _FFN_BUDGET:
      return block
  return None


def ffn_chunks_for(rows: int, d: int, f: int, itemsize: int) -> int | None:
  """The reference's F-slice count for K8b; None where no chunking fits."""
  for chunks in (2, 4, 8):
    if f % chunks:
      continue
    if _ffn_chunk_row_block(rows, d, f // chunks, itemsize) is not None:
      return chunks
  return None

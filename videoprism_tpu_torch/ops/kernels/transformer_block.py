"""K1 and K2: the fused pre-norm attention and FFN half-layers.

Ports ``videoprism_tpu/ops/pallas/transformer_block.py``
``fused_attention_block`` (K1) and ``fused_ffn_block`` (K2).  On a CUDA
tensor each wrapper runs its chain of hand-written kernels
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
_ACTIVATIONS = {'gelu': 1, 'relu': 2}


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


def _reference_attention_block(x, mask, ln_scale, ln_bias, wqkv, bqkv, wo, bo,
                               *, num_heads, dim_per_head, logit_cap,
                               epsilon, query_scale):
  """Plain twin of K1 (same op order and rounding points)."""
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
  ctx = ctx.transpose(1, 2).reshape(b, t, nh)
  out = ctx.float() @ wo.float() + bo.float() + x.float()
  return out.to(x.dtype)


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
  if partial_out:
    raise NotImplementedError(
        'partial_out (tensor parallelism, primer_hybrid) is not ported yet; '
        'see ROADMAP.md')
  static = dict(num_heads=num_heads, dim_per_head=dim_per_head,
                logit_cap=float(logit_cap), epsilon=epsilon,
                query_scale=float(query_scale))
  if not _lib.use_kernel(impl, x):
    return _reference_attention_block(
        x, mask, ln_scale, ln_bias, wqkv, bqkv, wo, bo, **static)

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
  _lib.check(_lib.library().vp_attention_smem_bytes(t, dim_per_head) > 0,
             f'T={t}, H={dim_per_head} exceed the attention kernel\'s '
             'shared memory')
  h = torch.empty((b * t, d), dtype=x.dtype, device=x.device)
  qkv = torch.empty((b * t, 3 * nh), dtype=x.dtype, device=x.device)
  ctx = torch.empty((b * t, nh), dtype=x.dtype, device=x.device)
  out = torch.empty_like(x)
  _lib.launch('vp_attention_block', x.device,
              x, mask, ln_scale, ln_bias, wqkv, bqkv, wo, bo, h, qkv, ctx,
              out, b, t, d, num_heads, dim_per_head, mask.shape[0],
              mask.shape[1], static['logit_cap'], epsilon,
              static['query_scale'])
  _lib.LAUNCHES['fused_attention_block'] += 1
  return out


def _reference_ffn_block(x, paddings, ln_scale, ln_bias, w1, b1, w2, b2, *,
                         activation, epsilon):
  """Plain twin of K2 (same op order and rounding points)."""
  keep = 1.0 - paddings.float()
  h = ln_f32(x, ln_scale, ln_bias, epsilon).to(x.dtype)
  a = h.float() @ w1.float() + b1.float()
  a = F.gelu(a) if activation == 'gelu' else torch.relu(a)
  a = (a * keep).to(x.dtype)
  out = (a.float() @ w2.float() + b2.float()) * keep + x.float()
  return out.to(x.dtype)


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
  if partial_out:
    raise NotImplementedError(
        'partial_out (tensor parallelism, primer_hybrid) is not ported yet; '
        'see ROADMAP.md')
  if activation not in _ACTIVATIONS:
    raise ValueError(f'activation must be gelu or relu, got {activation!r}')
  if not _lib.use_kernel(impl, x):
    return _reference_ffn_block(x, paddings, ln_scale, ln_bias, w1, b1, w2, b2,
                                activation=activation, epsilon=epsilon)

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
  h = torch.empty_like(x)
  a = torch.empty((rows, f), dtype=x.dtype, device=x.device)
  out = torch.empty_like(x)
  _lib.launch('vp_ffn_block', x.device,
              x, paddings, ln_scale, ln_bias, w1, b1, w2, b2, h, a, out,
              rows, d, f, _ACTIVATIONS[activation], epsilon)
  _lib.LAUNCHES['fused_ffn_block'] += 1
  return out

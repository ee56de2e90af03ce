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

Under autograd each wrapper runs through a ``torch.autograd.Function``
that saves only its inputs: the attention blocks' backward
(:func:`attention_block_bwd`) is one flash-backward (K7) call with the
context plus plain products, the FFN blocks' (:func:`ffn_block_bwd`) the
explicit VJP of the reference's composed twin; both ignore ``chunks``, as
the reference's ``attention_block_vjp`` and ``ffn_block_vjp`` do.

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


def ln_backward(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor,
                epsilon: float, direct_scale: bool = False
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
  """The VJP of :func:`ln_f32` (statistics recomputed in fp32) at the
  output cotangent ``g`` -> (dx, dscale, dbias), all fp32; dx has x's
  shape, dscale and dbias are [D]."""
  d = x.shape[-1]
  xf = x.float().reshape(-1, d)
  gf = g.float().reshape(-1, d)
  mean = xf.mean(-1, keepdim=True)
  var = (xf - mean).square().mean(-1, keepdim=True)
  inv_sigma = torch.rsqrt(var + epsilon)
  normed = (xf - mean) * inv_sigma
  dnormed = gf * (scale.float() if direct_scale else scale.float() + 1.0)
  dx = inv_sigma * (dnormed - dnormed.mean(-1, keepdim=True)
                    - normed * (dnormed * normed).mean(-1, keepdim=True))
  return dx.reshape(x.shape), (gf * normed).sum(0), gf.sum(0)


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


def padded_head_dim(head_dim: int) -> int:
  """The head dim the kernels run: ``head_dim`` rounded up to a multiple
  of 8, so that every row of a head is whole 16-byte chunks."""
  return -(-head_dim // 8) * 8


def pad_heads(a: torch.Tensor, num_heads: int, head_dim: int,
              axis: int) -> torch.Tensor:
  """``a`` with its ``num_heads * head_dim`` axis ``axis`` laid out head by
  head, each head zero-padded to :func:`padded_head_dim`; ``a`` itself
  where the head dim needs none.  Zero q and k columns add exact zeros to
  every logit, zero v columns give zero ctx columns, and those meet zero
  rows of Wo: the padded function is the unpadded one, exactly."""
  hp = padded_head_dim(head_dim)
  if hp == head_dim:
    return a
  axis %= a.ndim
  lead, tail = a.shape[:axis], a.shape[axis + 1:]
  a = a.reshape(*lead, num_heads, head_dim, *tail)
  a = F.pad(a, [0, 0] * len(tail) + [0, hp - head_dim])
  return a.reshape(*lead, num_heads * hp, *tail)


def check_partial_out(partial_out: bool) -> None:
  if partial_out:
    raise NotImplementedError(
        'partial_out (tensor parallelism, primer_hybrid) is not ported yet; '
        'see ROADMAP.md, queue 1 items 3 and 13')


GEMM_EPILOGUES = {'qkv': 0, 'act_keep': 1, 'residual': 2, 'chain': 3}


def gemm_bf16(a: torch.Tensor, b: torch.Tensor, *, epilogue: str = 'qkv',
              bias: torch.Tensor | None = None,
              pads: torch.Tensor | None = None,
              residual: torch.Tensor | None = None,
              activation: str | None = None, col_scale: float = 1.0,
              scaled_cols: int = 0, chunks: int = 1) -> torch.Tensor:
  """The product stage of K1, K2, K8a and K8b alone, for measurement and
  for composing the chained blocks from separate launches: ``epilogue(a
  [M, K] @ b [K, N])`` -> [M, N] bf16 through the hand-written wgmma GEMM
  (``csrc/gemm_bf16.cu``), with the blocks' epilogues ('qkv': + bias, x
  ``col_scale`` on the first ``scaled_cols`` columns; 'act_keep': act(+
  bias) x keep, GELU or ReLU; 'residual': (+ bias) [x keep] + residual;
  'chain': 'residual' over ``chunks`` K-slices, the bias in the first, the
  output cast after each and the next slice's residual, in one launch).
  CUDA tensors only: the blocks' twins are its plain versions."""
  m, k = a.shape
  n = b.shape[1]
  _lib.check(a.is_cuda, 'gemm_bf16 runs on CUDA tensors only')
  operands = dict(a=a, b=b, bias=bias, pads=pads, residual=residual)
  _lib.check_tensors(a.device, **{key: t for key, t in operands.items()
                                  if t is not None})
  _lib.check(b.shape[0] == k and n % 8 == 0 and chunks >= 1
             and k % chunks == 0 and (k // chunks) % 8 == 0,
             f'a {tuple(a.shape)} @ b {tuple(b.shape)} in {chunks} slices: '
             'K must agree, N and the slices be multiples of 8')
  _lib.check(chunks == 1 or epilogue == 'chain',
             f"{chunks} K-slices go with epilogue 'chain'")
  _lib.check(epilogue not in ('residual', 'chain') or residual is not None,
             f'epilogue {epilogue!r} needs a residual')
  _lib.check(epilogue != 'act_keep' or activation in ACTIVATIONS,
             "epilogue 'act_keep' takes activation 'gelu' or 'relu'")
  out = torch.empty((m, n), dtype=a.dtype, device=a.device)
  _lib.launch('vp_gemm_bf16', a.device, a, b, bias, pads, residual, out, m, n,
              k, k, GEMM_EPILOGUES[epilogue],
              ACTIVATIONS.get(activation, 0), col_scale, scaled_cols, chunks)
  return out


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
  hp = padded_head_dim(dim_per_head)
  _lib.check(_lib.attention_fits(t, hp),
             f'T={t}, H={dim_per_head}: the attention core takes head dims '
             'of at most 128')
  if hp != dim_per_head:   # off the model path: prepare_for_kernels pads
    wqkv = pad_heads(wqkv, 3 * num_heads, dim_per_head, -1)
    bqkv = pad_heads(bqkv, 3 * num_heads, dim_per_head, -1)
    wo = pad_heads(wo, num_heads, dim_per_head, 0)
    nh, dim_per_head = num_heads * hp, hp
  h = torch.empty((b * t, d), dtype=x.dtype, device=x.device)
  qkv = torch.empty((b * t, 3 * nh), dtype=x.dtype, device=x.device)
  ctx = torch.empty((b * t, nh), dtype=x.dtype, device=x.device)
  out = torch.empty_like(x)
  _lib.launch('vp_attention_block', x.device, x, mask, ln_scale, ln_bias,
              wqkv, bqkv, wo, bo, h, qkv, ctx, out, b, t, d, num_heads,
              dim_per_head, mask.shape[0], mask.shape[1], chunks,
              float(logit_cap), epsilon, float(query_scale))
  return out


def _attention_block_forward(args, static, chunks, impl):
  """K1 (``chunks=None``) or K8a over ``chunks`` head groups, or their
  twin on the CPU / with ``impl='reference'``."""
  if not _lib.use_kernel(impl, args[0]):
    ctx = _reference_attention_ctx(*args[:6], **static)
    return _residual_chain(ctx, args[6], args[7], args[0], chunks or 1)
  out = _launch_attention(*args, chunks=chunks or 1, **static)
  _lib.LAUNCHES['fused_attention_block' if chunks is None
                else 'fused_attention_block_chunked'] += 1
  return out


def attention_block_bwd(args, g, *, num_heads, dim_per_head, logit_cap,
                        epsilon, query_scale, impl='auto'):
  """The backward of K1 and K8a at the output cotangent ``g`` [B, T, D]:
  the port of ``_attention_block_bwd`` (``transformer_block.py``) to the
  fused weight layout.  LN and q|k|v are recomputed with plain products;
  one K7 call (``with_ctx=True``, dispatched by ``impl``) gives the
  context, dq, dk and dv, so the forward kernel is never replayed; then
  dWo = ctx^T g, the query scale on dq, dWqkv, dbqkv and the fp32 LN
  backward plus the residual.  Products run in x's dtype, as the
  reference's XLA einsums do.  Returns the cotangents of ``args`` (None for
  the mask), each in its operand's dtype."""
  from videoprism_tpu_torch.ops.kernels import flash_attention as flash

  x, mask, ln_scale, ln_bias, wqkv, bqkv, wo, bo = args
  b, t, d = x.shape
  n, hd = num_heads, dim_per_head
  nh = n * hd
  h = ln_f32(x, ln_scale, ln_bias, epsilon).to(x.dtype).reshape(b * t, d)
  qkv = torch.addmm(bqkv, h, wqkv)                          # [B*T, 3*N*H]
  heads = lambda a: a.reshape(b, t, n, hd).transpose(1, 2).contiguous()
  rows = lambda a: a.transpose(1, 2).reshape(b * t, nh)
  q, k, v = qkv.split(nh, dim=-1)
  g2 = g.reshape(b * t, d)
  dctx = heads(g2 @ wo.t())
  ctx, dq, dk, dv = flash.fused_attention_bwd(
      heads(q * query_scale), heads(k), heads(v), mask, dctx,
      logit_cap=logit_cap, with_ctx=True, impl=impl)
  dwo = rows(ctx).t() @ g2
  dqkv = torch.cat([rows(dq) * query_scale, rows(dk), rows(dv)], dim=-1)
  dwqkv = h.t() @ dqkv
  dh = dqkv @ wqkv.t()
  dx, dln_scale, dln_bias = ln_backward(x, ln_scale, dh, epsilon)
  dx = dx + g.float()                                       # residual
  cast = lambda val, ref: val.to(ref.dtype)
  return (cast(dx, x), None, cast(dln_scale, ln_scale),
          cast(dln_bias, ln_bias), cast(dwqkv, wqkv),
          cast(dqkv.float().sum(0), bqkv), cast(dwo, wo),
          cast(g2.float().sum(0), bo))


class _AttentionBlock(torch.autograd.Function):
  """K1 / K8a forward, :func:`attention_block_bwd` backward (whatever
  ``chunks``, as the reference's ``attention_block_vjp``); saves only its
  inputs."""

  @staticmethod
  def forward(ctx, static, chunks, impl, *args):
    ctx.save_for_backward(*args)
    ctx.static, ctx.impl = static, impl
    return _attention_block_forward(args, static, chunks, impl)

  @staticmethod
  def backward(ctx, g):
    grads = attention_block_bwd(ctx.saved_tensors, g.contiguous(),
                                **ctx.static, impl=ctx.impl)
    return (None, None, None, *grads)


def _attention_block(args, static, chunks, impl):
  if _lib.needs_grad(impl, *args):
    return _AttentionBlock.apply(static, chunks, impl, *args)
  return _attention_block_forward(args, static, chunks, impl)


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
  builds them once at load time.  Differentiable (``_AttentionBlock``).
  """
  check_partial_out(partial_out)
  static = dict(num_heads=num_heads, dim_per_head=dim_per_head,
                logit_cap=float(logit_cap), epsilon=epsilon,
                query_scale=float(query_scale))
  return _attention_block((x, mask, ln_scale, ln_bias, wqkv, bqkv, wo, bo),
                          static, None, impl)


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
  return _attention_block((x, mask, ln_scale, ln_bias, wqkv, bqkv, wo, bo),
                          static, chunks, impl)


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
  # The chained product reads each F-slice of a [rows, F] in place: its
  # width must keep 16-byte rows (TMA's pitch and alignment).  The GEMM's
  # loads zero-fill a slice that is not a multiple of its 64-deep tile.
  _lib.check((f // chunks) % 8 == 0,
             f'{chunks} chunks of hidden dim {f} must be multiples of 8')
  h = torch.empty_like(x)
  a = torch.empty((rows, f), dtype=x.dtype, device=x.device)
  out = torch.empty_like(x)
  _lib.launch('vp_ffn_block', x.device, x, paddings, ln_scale, ln_bias, w1,
              b1, w2, b2, h, a, out, rows, d, f, chunks,
              ACTIVATIONS[activation], epsilon)
  return out


def _ffn_block_forward(args, static, chunks, impl):
  """K2 (``chunks=None``) or K8b over ``chunks`` F-slices, or their twin
  on the CPU / with ``impl='reference'``."""
  if not _lib.use_kernel(impl, args[0]):
    return _reference_ffn_block(*args, chunks=chunks or 1, **static)
  out = _launch_ffn(*args, chunks=chunks or 1, **static)
  _lib.LAUNCHES['fused_ffn_block' if chunks is None
                else 'fused_ffn_block_chunked'] += 1
  return out


def ffn_block_bwd(args, g, *, activation, epsilon):
  """The backward of K2 and K8b at the output cotangent ``g`` [rows, D]:
  the explicit VJP of the reference's ``_composed_ffn_block`` (what its
  ``ffn_block_vjp`` differentiates, whatever the chunk count).  LN is
  recomputed in fp32; the padding ``keep`` scales both products' paths;
  the activation's derivative is the exact-erf GELU's or the ReLU's; the
  products run in x's dtype where the forward's values are in it.  Returns
  the cotangents of ``args`` (None for the paddings)."""
  x, paddings, ln_scale, ln_bias, w1, b1, w2, b2 = args
  keep = 1.0 - paddings.float()                              # [rows, 1]
  h = ln_f32(x, ln_scale, ln_bias, epsilon).to(x.dtype)
  pre = torch.addmm(b1, h, w1).float()                       # [rows, F]
  act = F.gelu(pre) if activation == 'gelu' else torch.relu(pre)
  a = (act * keep).to(x.dtype)
  gk = g.float() * keep             # cotangent of a @ w2 + b2
  gk_c = gk.to(x.dtype)
  dpre = (gk_c @ w2.t()).float() * keep
  if activation == 'gelu':    # times Phi(pre) + pre * phi(pre), one pass
    dpre = torch.ops.aten.gelu_backward(dpre, pre, approximate='none')
  else:
    dpre = torch.where(pre > 0.0, dpre, 0.0)
  dpre_c = dpre.to(x.dtype)
  dx, dln_scale, dln_bias = ln_backward(x, ln_scale, dpre_c @ w1.t(), epsilon)
  dx = dx + g.float()                                        # residual
  cast = lambda val, ref: val.to(ref.dtype)
  return (cast(dx, x), None, cast(dln_scale, ln_scale),
          cast(dln_bias, ln_bias), cast(h.t() @ dpre_c, w1),
          cast(dpre.sum(0), b1), cast(a.t() @ gk_c, w2), cast(gk.sum(0), b2))


class _FfnBlock(torch.autograd.Function):
  """K2 / K8b forward, :func:`ffn_block_bwd` backward; saves only its
  inputs."""

  @staticmethod
  def forward(ctx, static, chunks, impl, *args):
    ctx.save_for_backward(*args)
    ctx.static = static
    return _ffn_block_forward(args, static, chunks, impl)

  @staticmethod
  def backward(ctx, g):
    return (None, None, None,
            *ffn_block_bwd(ctx.saved_tensors, g.contiguous(), **ctx.static))


def _ffn_block(args, static, chunks, impl):
  if _lib.needs_grad(impl, *args):
    return _FfnBlock.apply(static, chunks, impl, *args)
  return _ffn_block_forward(args, static, chunks, impl)


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
  """Pre-LN FFN half-layer: ``x + keep * FFN(LN(x))`` -> [rows, D].
  Differentiable (``_FfnBlock``)."""
  check_partial_out(partial_out)
  if activation not in ACTIVATIONS:
    raise ValueError(f'activation must be gelu or relu, got {activation!r}')
  return _ffn_block((x, paddings, ln_scale, ln_bias, w1, b1, w2, b2),
                    dict(activation=activation, epsilon=epsilon), None, impl)


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
  if chunks < 1 or w1.shape[1] % chunks:
    raise ValueError(f'{chunks} chunks do not divide F={w1.shape[1]}')
  return _ffn_block((x, paddings, ln_scale, ln_bias, w1, b1, w2, b2),
                    dict(activation=activation, epsilon=epsilon), chunks,
                    impl)


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

"""Transformer layer and layer stack (port of
``videoprism_tpu.ops.transformer``).

A 'pre'-policy layer with bias, gelu/relu and no per-dim scale (every layer
of the video and text towers) runs as two fused half-layers, mirroring the
JAX package's choice in ``_try_fused_layer``:

* attention: K1 ``fused_attention_block``, or K8a
  ``fused_attention_block_chunked`` where the reference chains head groups
  (:func:`chunk_plan`), when T <= 1024, the mask covers T and, on the card,
  K1's attention core takes the head dim (it streams K and V, so any T);
  else the composed attention half (K6 LayerNorm,
  ``multi_head_attention(impl='flash')`` with K5, residual: the 4096-token
  auxiliary encoder);
* FFN: K8b ``fused_ffn_block_chunked`` where the reference chains F-slices,
  else K2 ``fused_ffn_block`` (``ops/kernels/``).

A layer whose weights are int8 (``quantization.quantize_for_serving``)
takes the reference's W8A8 route (``_try_fused_int8_layer``; see
:func:`int8_plan`): K11 ``int8_layer_block`` for the whole layer, or K10
``int8_attention_block_chunked`` (K12a + K5 + K12b
``int8_projected_flash_attention`` past K10's T) and K9
``int8_ffn_block_chunked``; a half (or a layer) the reference does not
take in int8 is dequantized and runs the float path.

Other 'pre' layers run the composed path (``multi_head_attention`` +
:func:`transformer_ffn`).  The stack is a Python loop over the leading
layer axis of ``x_layers`` (or over ``x_layers_{i}`` when ``scan=False``);
the JAX package's ``lax.scan``, remat, 128-row small-sequence packing and
pad to a multiple of 8 tokens have no counterpart here (the chunk plan
still reads the lengths the reference's packing and padding give).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from videoprism_tpu_torch import quantization
from videoprism_tpu_torch.ops import attention as attention_lib
from videoprism_tpu_torch.ops import basic
from videoprism_tpu_torch.ops import masks as mask_lib
from videoprism_tpu_torch.ops.kernels import _lib
from videoprism_tpu_torch.ops.kernels import flash_attention as flash
from videoprism_tpu_torch.ops.kernels import int8_blocks as i8
from videoprism_tpu_torch.ops.kernels import transformer_block as tb

Params = dict[str, Any]

# Longest sequence K1 takes, as in the JAX package's attention_block_supported;
# longer sequences run the composed attention half with K5.
MAX_FUSED_ATTENTION_T = 1024


@dataclasses.dataclass(frozen=True)
class TransformerLayerConfig:
  """The fields of the JAX package's config that the encoder reads."""

  num_layers: int = 0
  hidden_dim: int = 0           # FFN hidden dim
  num_heads: int = 0
  norm_policy: str = 'pre'
  activation: str = 'relu'
  enable_per_dim_scale: bool = True
  logit_cap: float = 0.0
  enable_causal_atten: bool = False
  scan: bool = True             # weights stacked under x_layers
  dtype: torch.dtype = torch.float32


def _check_policy(cfg: TransformerLayerConfig) -> None:
  if cfg.norm_policy != 'pre':
    raise NotImplementedError(
        f'norm_policy={cfg.norm_policy!r} is not ported yet (only "pre"); '
        'see ROADMAP.md, queue 1 item 3')


def transformer_ffn(params: Params, inputs: torch.Tensor,
                    paddings: torch.Tensor | None,
                    cfg: TransformerLayerConfig, *,
                    impl: str = 'auto') -> torch.Tensor:
  """Composed pre-norm FFN with residual and padding zeroing."""
  _check_policy(cfg)
  dtype = cfg.dtype
  if paddings is not None:
    paddings = paddings[..., None].to(inputs.dtype)
  x = basic.layer_norm(params['layer_norm'], inputs, dtype=dtype, impl=impl)
  x = basic.feed_forward(params['ffn_layer1'], x, activation=cfg.activation,
                         dtype=dtype)
  if paddings is not None:
    x = x * (1.0 - paddings)
  x = basic.feed_forward(params['ffn_layer2'], x, activation='identity',
                         dtype=dtype)
  if paddings is not None:
    x = x * (1.0 - paddings)
  return inputs + x


def fused_layer_supported(cfg: TransformerLayerConfig) -> bool:
  """Whether a layer runs as K1 + K2 (the JAX gate of _try_fused_layer)."""
  return (cfg.norm_policy == 'pre' and not cfg.enable_per_dim_scale
          and cfg.activation in ('gelu', 'relu'))


def fused_attention_supported(t: int, atten_mask: torch.Tensor,
                              dim_per_head: int | None = None) -> bool:
  """Whether K1 (or K8a) takes a T-token sequence under ``atten_mask``: the
  JAX gate without its TPU tiling terms (T <= 1024, the mask covers T)
  and, given ``dim_per_head`` (the kernel path on the card), what K1's
  attention core takes (``_lib.attention_fits``: every T at a head dim
  that is a multiple of 8 up to 128; it streams K and V)."""
  return (t <= MAX_FUSED_ATTENTION_T and atten_mask.shape[-1] == t
          and (dim_per_head is None or _lib.attention_fits(t, dim_per_head)))


def _reference_layout(b: int, t: int, *, causal: bool) -> tuple[int, int]:
  """(rows, T) of a [B, T] stack in the reference's layout: T padded to a
  multiple of 8 and, without a causal mask, sequences shorter than 128
  packed 128 // T to a sequence (``stacked_transformer``)."""
  t_ref = t + (-t) % 8
  rows = b * t_ref
  group = 128 // t_ref if t_ref < 128 and 128 % t_ref == 0 else 1
  if not causal and group > 1 and b % group == 0:
    t_ref *= group
  return rows, t_ref


def chunk_plan(b: int, t: int, d: int, num_heads: int, dim_per_head: int,
               f: int, itemsize: int, *, causal: bool
               ) -> tuple[int | None, int | None]:
  """(K8a chunks, K8b chunks): the counts the reference's
  ``_try_fused_layer`` picks for a [B, T, D] layer, None for a half it
  runs unchunked.  It sees T padded to a multiple of 8 and, without a
  causal mask, sequences shorter than 128 packed 128 // T to a sequence
  (``stacked_transformer``); the FFN sees all rows at once.
  """
  rows, t_ref = _reference_layout(b, t, causal=causal)
  nh = num_heads * dim_per_head
  attn_chunks = (None if tb.attention_block_supported(t_ref, d, nh, itemsize)
                 else tb.attention_chunks_for(t_ref, d, num_heads,
                                              dim_per_head, itemsize))
  ffn_chunks = (None if tb.ffn_block_supported(rows, d, f, itemsize)
                else tb.ffn_chunks_for(rows, d, f, itemsize))
  return attn_chunks, ffn_chunks


@dataclasses.dataclass(frozen=True)
class Int8Plan:
  """The reference's W8A8 route for one layer: ``layer`` (head_chunks,
  ffn_chunks) runs K11 for the whole layer; else the attention half runs
  K10 over ``attn_chunks`` head groups, K12a + K5 + K12b where
  ``projected``, or dequantized, and the FFN half K9 over ``ffn_chunks``
  F-chunks, or dequantized (None)."""

  layer: tuple[int, int] | None
  attn_chunks: int | None
  projected: bool
  ffn_chunks: int | None


def int8_plan(b: int, t: int, d: int, num_heads: int, dim_per_head: int,
              f: int, itemsize: int, *, causal: bool,
              mask_covers: bool = True) -> Int8Plan | None:
  """The route ``_try_fused_int8_layer`` takes for a [B, T, D] int8 layer,
  read at the reference's padded and packed lengths (as
  :func:`chunk_plan`); None where it dequantizes the whole layer.
  ``mask_covers``: the attention mask spans T (it does in every stack)."""
  rows, t_ref = _reference_layout(b, t, causal=causal)
  nh = num_heads * dim_per_head
  attn_chunks = (i8.attention_int8_chunks_for(t_ref, d, num_heads,
                                              dim_per_head, itemsize)
                 if mask_covers else None)
  projected = (attn_chunks is None and mask_covers
               and i8.attn_int8_projection_supported(rows, d, nh, itemsize))
  ffn_chunks = i8.ffn_int8_chunks_for(rows, d, f, itemsize)
  if attn_chunks is None and not projected and ffn_chunks is None:
    return None
  layer = None
  if mask_covers and rows <= 16384:
    layer = i8._layer_int8_cfg(t_ref, d, nh, f, num_heads, itemsize)
  return Int8Plan(layer, attn_chunks, projected, ffn_chunks)


def int8_attention_weights(attn: Params) -> dict[str, torch.Tensor]:
  """The int8 attention kernels' operands (K10, K11, K12a and K12b) from
  an int8 ``self_attention`` tree of (D, N, H) weights
  (``int8_blocks.int8_qkv_kmajor`` / ``int8_out_kmajor``): ``wqkv`` [..,
  3*N*H', D] (q|k|v, K-major), ``sqkv`` and ``bqkv`` [.., 3*N*H'] and
  ``wo`` [.., D, N*H'] (K-major: the ``post`` weights flattened, a view
  where H needs no padding), each head zero-padded to H' =
  ``padded_head_dim(H)``; leading (layer) axes are kept."""
  n, h = attn['query']['w'].shape[-2:]
  geometry = dict(num_heads=n, dim_per_head=h)
  qkv = [attn[name][key].flatten(-2) for name in ('query', 'key', 'value')
         for key in ('w', 'w_scale', 'b')]
  wo = attn['post']['w'].flatten(-2).transpose(-1, -2)
  return dict(i8.int8_qkv_kmajor(*qkv, **geometry),
              **i8.int8_out_kmajor(wo, **geometry))


def int8_ffn_weights(ff: Params) -> dict[str, torch.Tensor]:
  """K9's and K11's FFN operands from an int8 ``ff_layer`` tree: ``w1``
  [.., F, D] and ``w2`` [.., D, F], K-major."""
  return i8.int8_ffn_kmajor(ff['ffn_layer1']['linear']['kernel'],
                            ff['ffn_layer2']['linear']['kernel'])


def _int8_layer(params: Params, inputs: torch.Tensor,
                paddings: torch.Tensor | None, atten_mask: torch.Tensor,
                cfg: TransformerLayerConfig, impl: str
                ) -> torch.Tensor | None:
  """An int8 layer through the W8A8 kernels, or None where the reference
  dequantizes the whole layer (a per-dim scale, an activation other than
  gelu/relu, or no int8 route for either half).  On the card, K10's and
  K11's attention core is K1's: a sequence it does not take
  (``_lib.attention_fits``; it takes every T up to the route's 1024 at the
  head dims the port serves) takes K12a + K5 + K12b where that is the same
  arithmetic (one head group; K11 also one
  F-chunk, its FFN half then being K9's), and raises ``ValueError`` naming
  the limit otherwise, or where K5 cannot take the head dim (padded to a
  multiple of 8, past its 128).  The kernels read the K-major operands
  (:func:`int8_attention_weights`, :func:`int8_ffn_weights`), each head
  padded to a multiple of 8.
  The conditions of the reference's route that the port's layer config
  cannot break (inference, the 'pre' policy, residual weight 1, biases)
  are not asked again."""
  if cfg.enable_per_dim_scale or cfg.activation not in ('gelu', 'relu'):
    return None
  b, t, d = inputs.shape
  attn, ff = params['self_attention'], params['ff_layer']
  n, h = attn['query']['w'].shape[-2:]
  f = ff['ffn_layer1']['linear']['kernel'].shape[-1]
  plan = int8_plan(b, t, d, n, h, f, inputs.element_size(),
                   causal=cfg.enable_causal_atten,
                   mask_covers=atten_mask.shape[-1] == t)
  if plan is None:
    return None
  dtype = cfg.dtype
  hp = tb.padded_head_dim(h)
  cast = lambda a: basic.cast_floating(a, dtype)
  # The kernels read the K-major operands (prepare_for_kernels' ``fused``,
  # else built here); the [K, N] weights they replace are not passed.
  attn_k = dict(attn.get('fused') or int8_attention_weights(attn))
  attn_k['bqkv'] = cast(attn_k['bqkv'])
  ffn_k = ff.get('fused') or int8_ffn_weights(ff)
  qkv = (None,) * 9
  out_w = (None, attn['post']['w_scale'].float(), cast(attn['post']['b']))
  lin = lambda name: (None, ff[name]['linear']['kernel_scale'].float(),
                      cast(ff[name]['linear']['bias']))
  ln = lambda p: (cast(p['scale']), cast(p['bias']))
  static = dict(num_heads=n, dim_per_head=h, logit_cap=cfg.logit_cap,
                epsilon=1e-6, query_scale=h ** -0.5, impl=impl)
  mask3 = atten_mask.squeeze(1).float()

  layer, attn_chunks, projected = plan.layer, plan.attn_chunks, plan.projected
  ffn_chunks = plan.ffn_chunks
  on_card = _lib.use_kernel(impl, inputs)
  if (layer or attn_chunks) and on_card and not _lib.attention_fits(t, hp):
    one_chunk = layer == (1, 1) if layer else attn_chunks == 1
    if not one_chunk:
      raise ValueError(
          f"T={t}, H={h}: the int8 attention block's core holds T <= "
          f'{_lib.max_attention_t(h)} at this head dim, and the reference '
          f'chunks this layer ({layer or attn_chunks}), which the '
          'long-sequence route (K12a + K5 + K12b) does not round as')
    if layer:
      ffn_chunks = 1
    layer, attn_chunks, projected = None, None, True
  if projected and on_card and hp > flash.MAX_HEAD_DIM:
    raise ValueError(
        f'T={t} at head dim {h}: the int8 attention block holds T <= '
        f'{min(_lib.max_attention_t(hp), MAX_FUSED_ATTENTION_T)} at this '
        'head dim, and the long-sequence route (K12a + K5 + K12b) takes '
        f'head dims of at most {flash.MAX_HEAD_DIM}')
  if layer:
    pads = (paddings.reshape(b, t, 1).to(dtype) if paddings is not None
            else torch.zeros((b, t, 1), dtype=dtype, device=inputs.device))
    return i8.int8_layer_block(
        inputs, mask3, pads, *ln(params['layer_norm']), *qkv, *out_w,
        *ln(ff['layer_norm']), *lin('ffn_layer1'), *lin('ffn_layer2'),
        activation=cfg.activation, head_chunks=layer[0],
        ffn_chunks=layer[1], kmajor=dict(attn_k, **ffn_k), **static)

  if attn_chunks:
    x = i8.int8_attention_block_chunked(
        inputs, mask3, *ln(params['layer_norm']), *qkv, *out_w,
        chunks=attn_chunks, kmajor=attn_k, **static)
  elif projected:
    x = i8.int8_projected_flash_attention(
        inputs, atten_mask.float(), *ln(params['layer_norm']), *qkv, *out_w,
        kmajor=attn_k, **static)
  else:   # no int8 attention route: the attention half dequantized
    attn_deq = quantization.dequantize({'self_attention': attn},
                                       dtype)['self_attention']
    normed = basic.layer_norm(params['layer_norm'], inputs, dtype=dtype,
                              impl=impl)
    x = inputs + attention_lib.multi_head_attention(
        attn_deq, normed, normed, normed, atten_mask, hidden_dim=d,
        num_heads=cfg.num_heads, logit_cap=cfg.logit_cap,
        enable_per_dim_scale=False, dtype=dtype, impl='flash',
        kernel_impl=impl)

  if ffn_chunks is None:
    ff_deq = quantization.dequantize({'ff_layer': ff}, dtype)['ff_layer']
    return transformer_ffn(ff_deq, x, paddings, cfg, impl=impl)
  pad_rows = (paddings.reshape(b * t, 1).to(dtype) if paddings is not None
              else torch.zeros((b * t, 1), dtype=dtype, device=inputs.device))
  out = i8.int8_ffn_block_chunked(
      x.reshape(b * t, d), pad_rows, *ln(ff['layer_norm']),
      *lin('ffn_layer1'), *lin('ffn_layer2'), chunks=ffn_chunks,
      activation=cfg.activation, epsilon=1e-6, kmajor=ffn_k, impl=impl)
  return out.reshape(b, t, d)


def fused_attention_weights(attn: Params, dtype: torch.dtype
                            ) -> dict[str, torch.Tensor]:
  """Wqkv [D, 3*N*H'], bqkv [3*N*H'] and Wo [N*H', D] from (D, N, H)
  weights, each head zero-padded to H' = ``padded_head_dim(H)`` (the
  kernels' 16-byte rows; the same function, exactly).

  Leading (layer) axes are kept, so this serves one layer or a stack.
  """
  n, h = attn['query']['w'].shape[-2:]
  flat = lambda a: tb.pad_heads(basic.cast_floating(a, dtype).flatten(-2), n,
                                h, -1)
  return {
      'wqkv': torch.cat([flat(attn[n]['w']) for n in
                         ('query', 'key', 'value')], dim=-1),
      'bqkv': torch.cat([flat(attn[n]['b'])
                         for n in ('query', 'key', 'value')], dim=-1),
      'wo': flat(attn['post']['w']).transpose(-1, -2).contiguous(),
  }


def transformer_layer(params: Params, inputs: torch.Tensor,
                      paddings: torch.Tensor | None,
                      atten_mask: torch.Tensor,
                      cfg: TransformerLayerConfig, *,
                      impl: str = 'auto') -> torch.Tensor:
  """One pre-norm self-attention + FFN layer on [B, T, D].

  ``params['self_attention']['fused']`` (from ``prepare_for_kernels``) holds
  the fused projection weights; without it, or when the weights require
  grad (training), they are built from the leaves on every call.  Under
  autograd every kernel wrapper runs through its ``torch.autograd.Function``
  (``ops/kernels/``); an int8 tree raises ``ValueError`` there.
  The halves follow the module docstring.  Where the reference runs its
  composed FFN because no chunking fits its VMEM, the port keeps K2, which
  takes any row count.  On the card, a sequence that K1's attention core
  does not take (``_lib.attention_fits``), or past the route's 1024 tokens,
  takes the composed half (K6 + K5; giant's 88 too), and raises
  ``ValueError`` naming the limit where K5 cannot take the head dim either
  (past its 128).  A head dim that is not a multiple of 8 runs padded to
  one (``fused_attention_weights``; K5 pads q, k and v itself).
  """
  _check_policy(cfg)
  dtype = cfg.dtype
  if quantization.is_quantized(params):
    if torch.is_grad_enabled() and inputs.requires_grad:
      raise ValueError(
          'an int8 (quantized) tree serves only: the W8A8 route has no '
          'backward, as the reference refuses train=True on it')
    out = _int8_layer(params, inputs, paddings, atten_mask, cfg, impl)
    if out is not None:
      return out
    params = quantization.dequantize(params, dtype)
  if not fused_layer_supported(cfg):
    normed = basic.layer_norm(params['layer_norm'], inputs, dtype=dtype,
                              impl=impl)
    x = inputs + attention_lib.multi_head_attention(
        params['self_attention'], normed, normed, normed, atten_mask,
        hidden_dim=inputs.shape[-1], num_heads=cfg.num_heads,
        logit_cap=cfg.logit_cap,
        enable_per_dim_scale=cfg.enable_per_dim_scale, dtype=dtype)
    return transformer_ffn(params['ff_layer'], x, paddings, cfg, impl=impl)

  b, t, d = inputs.shape
  attn, ff = params['self_attention'], params['ff_layer']
  _, n, h = attn['query']['w'].shape
  f = ff['ffn_layer1']['linear']['kernel'].shape[-1]
  attn_chunks, ffn_chunks = chunk_plan(
      b, t, d, n, h, f, inputs.element_size(),
      causal=cfg.enable_causal_atten)
  cast = lambda a: basic.cast_floating(a, dtype)
  on_card = _lib.use_kernel(impl, inputs)
  hp = tb.padded_head_dim(h)
  if fused_attention_supported(t, atten_mask, hp if on_card else None):
    fused = attn.get('fused')
    if fused is None or attn['query']['w'].requires_grad:
      # Under training the cached fused copy is stale after the first
      # update and no gradient reaches it: build it from the leaves.
      fused = fused_attention_weights(attn, dtype)
    kw = dict(num_heads=n, dim_per_head=hp, logit_cap=cfg.logit_cap,
              epsilon=1e-6, query_scale=h ** -0.5, impl=impl)
    if attn_chunks:
      block, kw['chunks'] = tb.fused_attention_block_chunked, attn_chunks
    else:
      block = tb.fused_attention_block
    x = block(
        inputs, atten_mask.squeeze(1).float(),
        cast(params['layer_norm']['scale']),
        cast(params['layer_norm']['bias']),
        cast(fused['wqkv']), cast(fused['bqkv']), cast(fused['wo']),
        cast(attn['post']['b']), **kw)
  else:   # the composed attention half: K6 LN, K5 attention, residual
    if on_card and hp > flash.MAX_HEAD_DIM:
      raise ValueError(
          f'T={t} at head dim {h}: the fused attention kernel holds T <= '
          f'{min(_lib.max_attention_t(hp), MAX_FUSED_ATTENTION_T)} at this '
          'head dim, and the long-sequence attention kernel (K5) takes head '
          f'dims of at most {flash.MAX_HEAD_DIM}')
    normed = basic.layer_norm(params['layer_norm'], inputs, dtype=dtype,
                              impl=impl)
    x = inputs + attention_lib.multi_head_attention(
        attn, normed, normed, normed, atten_mask, hidden_dim=d,
        num_heads=cfg.num_heads, logit_cap=cfg.logit_cap,
        enable_per_dim_scale=False, dtype=dtype, impl='flash',
        kernel_impl=impl)

  pad_rows = (paddings.reshape(b * t, 1).to(dtype) if paddings is not None
              else torch.zeros((b * t, 1), dtype=dtype, device=inputs.device))
  kw = dict(activation=cfg.activation, epsilon=1e-6, impl=impl)
  if ffn_chunks:
    block, kw['chunks'] = tb.fused_ffn_block_chunked, ffn_chunks
  else:
    block = tb.fused_ffn_block
  out = block(
      x.reshape(b * t, d), pad_rows,
      cast(ff['layer_norm']['scale']), cast(ff['layer_norm']['bias']),
      cast(ff['ffn_layer1']['linear']['kernel']),
      cast(ff['ffn_layer1']['linear']['bias']),
      cast(ff['ffn_layer2']['linear']['kernel']),
      cast(ff['ffn_layer2']['linear']['bias']), **kw)
  return out.reshape(b, t, d)


def _layer_slice(tree, i: int):
  if isinstance(tree, dict):
    return {k: _layer_slice(v, i) for k, v in tree.items()}
  return tree[i]


def stacked_transformer(params: Params, inputs: torch.Tensor,
                        paddings: torch.Tensor, cfg: TransformerLayerConfig,
                        *, impl: str = 'auto') -> torch.Tensor:
  """``cfg.num_layers`` layers over [B, T, D].

  With ``cfg.scan`` the weights live under ``x_layers`` with a leading layer
  axis (the "repeated" checkpoint layout), else under ``x_layers_{i}``.
  """
  atten_mask = mask_lib.attention_mask_for_fprop(
      inputs, paddings, causal_attention=cfg.enable_causal_atten)
  out = inputs
  for i in range(cfg.num_layers):
    layer = (_layer_slice(params['x_layers'], i) if cfg.scan
             else params[f'x_layers_{i}'])
    out = transformer_layer(layer, out, paddings, atten_mask, cfg, impl=impl)
  return out


def atten_token_pooling(params: Params, tokens: torch.Tensor,
                        paddings: torch.Tensor | None, *, num_heads: int,
                        hidden_dim: int, dtype: torch.dtype = torch.float32,
                        impl: str = 'auto') -> torch.Tensor:
  """Attention pooling of [B, S, D] tokens with learned queries ->
  [B, Q, D].

  Params: ``{'pooling_attention_query': [Q, D], 'pooling_attention':
  {...MHA with per-dim scale}, 'pooling_attention_layer_norm': {...}}``.
  The attention is plain PyTorch (``impl='xla'`` in the JAX package too);
  the output LayerNorm is K6 on the card.
  """
  batch_size, seq_length = tokens.shape[0], tokens.shape[-2]
  query = basic.cast_floating(params['pooling_attention_query'], dtype)
  query = query[None].expand(batch_size, -1, -1)
  if paddings is None:
    paddings = torch.zeros((batch_size, seq_length), dtype=tokens.dtype,
                           device=tokens.device)
  atten_mask = mask_lib.paddings_to_mask(paddings, paddings.dtype)
  outputs = attention_lib.multi_head_attention(
      params['pooling_attention'], query, tokens, tokens, atten_mask,
      hidden_dim=hidden_dim, num_heads=num_heads, enable_per_dim_scale=True,
      dtype=dtype)
  return basic.layer_norm(params['pooling_attention_layer_norm'], outputs,
                          dtype=dtype, impl=impl)

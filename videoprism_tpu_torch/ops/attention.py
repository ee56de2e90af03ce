"""Multi-head attention with the tanh logit soft-cap (port of the composed
path of ``videoprism_tpu.ops.attention``).

Projection weights keep the checkpoint layout (D, N, H) for q/k/v and post.
The projections are plain PyTorch products (XLA's in the JAX package).  The
attention core is plain PyTorch with ``impl='xla'``; ``impl='flash'`` runs
K5 (``ops/kernels/flash_attention.py``): on the card at every length, off
it where the JAX package's gate takes its Pallas kernel, and the composed
core elsewhere.  Short 'pre'-policy
self-attention runs the fused attention block
(``ops/kernels/transformer_block.py``) instead.  Inference only: no dropout.
"""

from __future__ import annotations

from typing import Any

import torch

from videoprism_tpu_torch.ops import basic
from videoprism_tpu_torch.ops import masks as mask_lib
from videoprism_tpu_torch.ops.kernels import flash_attention as flash

Params = dict[str, Any]


def attention_projection(params: Params, inputs: torch.Tensor, *,
                         is_output_projection: bool = False,
                         dtype: torch.dtype = torch.float32) -> torch.Tensor:
  """``...D, DNH -> ...NH`` (input) or ``...NH, DNH -> ...D`` (output)."""
  w = basic.cast_floating(params['w'], dtype)
  if is_output_projection:
    out = torch.einsum('...nh,dnh->...d', inputs, w)
  else:
    out = torch.einsum('...d,dnh->...nh', inputs, w)
  return out + basic.cast_floating(params['b'], dtype)


def _cap_logits(logits: torch.Tensor, cap: float) -> torch.Tensor:
  """``cap * tanh(logits / cap)``, applied before the mask."""
  if not cap or cap <= 0.0:
    return logits
  cap_t = torch.tensor(cap, dtype=logits.dtype, device=logits.device)
  return cap_t * torch.tanh(logits / cap_t)


def dot_atten(query: torch.Tensor, key: torch.Tensor, value: torch.Tensor,
              atten_mask: torch.Tensor, *, logit_cap: float = 0.0,
              dtype: torch.dtype = torch.float32
              ) -> tuple[torch.Tensor, torch.Tensor]:
  """[B,T,N,H] x [B,S,N,H] attention; returns (encoded [B,T,N,H],
  probs [B,N,T,S]).  Softmax in fp32, select-masking."""
  logits = torch.einsum('btnh,bsnh->bnts', query, key)
  logits = _cap_logits(logits, logit_cap).float()
  logits = mask_lib.apply_mask_to_logits(logits, atten_mask)
  probs = torch.softmax(logits, dim=-1).to(dtype)
  return torch.einsum('bnts,bsnh->btnh', probs, value), probs


def _dot_atten_head_major(query: torch.Tensor, key: torch.Tensor,
                          value: torch.Tensor, atten_mask: torch.Tensor, *,
                          logit_cap: float = 0.0,
                          dtype: torch.dtype = torch.float32) -> torch.Tensor:
  """Head-major twin of :func:`dot_atten` ([B, N, T, H] in and out)."""
  logits = torch.einsum('bnth,bnsh->bnts', query, key)
  logits = _cap_logits(logits, logit_cap).float()
  logits = mask_lib.apply_mask_to_logits(logits, atten_mask)
  probs = torch.softmax(logits, dim=-1).to(dtype)
  return torch.einsum('bnts,bnsh->bnth', probs, value)


def multi_head_attention(
    params: Params,
    query_vec: torch.Tensor,
    key_vec: torch.Tensor,
    value_vec: torch.Tensor,
    atten_mask: torch.Tensor,
    *,
    hidden_dim: int,
    num_heads: int,
    logit_cap: float = 0.0,
    enable_per_dim_scale: bool = True,
    dtype: torch.dtype = torch.float32,
    impl: str = 'xla',
    kernel_impl: str = 'auto',
) -> torch.Tensor:
  """q/k/v projections, capped attention, post projection -> [B, T, Dq].

  Params: ``{'query'|'key'|'value': {'w': [D, N, H], 'b': [N, H]},
  'post': {'w': [Dq, N, H], 'b': [Dq]}, 'per_dim_scale': {...}}``.

  ``impl='flash'`` runs K5, dispatched by ``kernel_impl`` ('auto' |
  'kernel' | 'reference'): on CUDA tensors at every T and S (K5 streams K
  and V; the JAX gate's multiples of 128, ``flash_attention.supports``, are
  TPU tiling, as K6's gate is), else for the shapes the JAX gate takes.
  ``'xla'`` and other shapes run the composed core.
  """
  if impl not in ('xla', 'flash'):
    raise ValueError(f"impl must be 'xla' or 'flash', got {impl!r}")
  dim_per_head = hidden_dim // num_heads
  if dim_per_head * num_heads != hidden_dim:
    raise ValueError(f'{hidden_dim=} is not divisible by {num_heads=}')

  def proj(name, x):
    out = torch.einsum('btd,dnh->bnth', x,
                       basic.cast_floating(params[name]['w'], dtype))
    return out + basic.cast_floating(params[name]['b'], dtype)[:, None, :]

  query = proj('query', query_vec)
  key = proj('key', key_vec)
  value = proj('value', value_vec)
  if enable_per_dim_scale:
    query = basic.per_dim_scale(params['per_dim_scale'], query, dtype=dtype)
  else:
    query = query * dim_per_head ** -0.5

  on_card = query.is_cuda and kernel_impl != 'reference'
  if impl == 'flash' and (on_card
                          or flash.supports(query.shape[2], key.shape[2])):
    encoded = flash.fused_attention(
        query.contiguous(), key.contiguous(), value.contiguous(),
        atten_mask.squeeze(1).float().contiguous(), logit_cap=logit_cap,
        impl=kernel_impl).to(dtype)
  else:
    encoded = _dot_atten_head_major(query, key, value, atten_mask,
                                    logit_cap=logit_cap, dtype=dtype)
  out = torch.einsum('bnth,dnh->btd', encoded,
                     basic.cast_floating(params['post']['w'], dtype))
  return out + basic.cast_floating(params['post']['b'], dtype)

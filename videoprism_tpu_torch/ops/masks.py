"""Attention-mask utilities (port of ``videoprism_tpu.ops.masks``).

Masks are additive-style float tensors: ``0`` means "attend" and
``-0.7 * dtype_max`` means "do not attend".  They are applied to logits by a
``where``-select, never by an add.
"""

from __future__ import annotations

import torch


def get_large_negative_number(dtype: torch.dtype) -> torch.Tensor:
  """Returns ``-0.7 * max(dtype)`` as a 0-d tensor of ``dtype``."""
  if dtype.is_floating_point:
    dtype_max = torch.finfo(dtype).max
  elif not dtype.is_complex and dtype != torch.bool:
    dtype_max = torch.iinfo(dtype).max
  else:
    raise ValueError('Unsupported dtype for masks.')
  return torch.tensor(-0.7 * dtype_max, dtype=dtype)


def apply_mask_to_logits(logits: torch.Tensor,
                         mask: torch.Tensor) -> torch.Tensor:
  """Replaces logits where ``mask`` is below half the large negative value."""
  min_value = get_large_negative_number(logits.dtype).to(logits.device)
  return torch.where(mask >= min_value * 0.5, logits, min_value)


def paddings_to_mask(paddings: torch.Tensor,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
  """[B, T] binary paddings (1 = pad) -> [B, 1, 1, T] additive mask."""
  neg = get_large_negative_number(dtype).to(paddings.device)
  return paddings[:, None, None, :] * neg


def causal_mask(seq_len: int, dtype: torch.dtype = torch.float32,
                device=None) -> torch.Tensor:
  """[1, 1, T, T] additive causal mask."""
  neg = get_large_negative_number(dtype).to(device)
  col = torch.arange(seq_len, device=device)[None, :]
  row = torch.arange(seq_len, device=device)[:, None]
  return ((row < col).to(dtype) * neg)[None, None]


def merge_masks(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """Elementwise minimum of two additive masks.

  A key-only mask [.., 1, S] meeting a [.., T, S] mask is first expanded
  to 2-D by ``min(query_mask, key_mask)``.
  """

  def expand_t(key_mask):
    return torch.minimum(key_mask.transpose(2, 3), key_mask)

  if a.shape[-2] != b.shape[-2]:
    if a.shape[-2] == 1:
      a = expand_t(a)
    elif b.shape[-2] == 1:
      b = expand_t(b)
    else:
      raise ValueError(f'cannot merge masks {a.shape} and {b.shape}')
  if a.shape[-3:] != b.shape[-3:]:
    raise ValueError(f'a.shape={a.shape}, b.shape={b.shape}.')
  return torch.minimum(a, b)


def attention_mask_for_fprop(inputs: torch.Tensor, paddings: torch.Tensor,
                             causal_attention: bool = False) -> torch.Tensor:
  """[1|B, 1, 1|T, T] self-attention mask for a [B, T, D] sequence."""
  mask = paddings_to_mask(paddings, inputs.dtype)
  if causal_attention:
    mask = merge_masks(
        mask, causal_mask(inputs.shape[-2], inputs.dtype, inputs.device))
  return mask

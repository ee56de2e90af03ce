"""Token and positional embeddings and the pos-emb resize (port of
``videoprism_tpu.ops.embeddings``).

The JAX package resizes pos-emb tables with
``jax.image.resize(method='bilinear')``, which antialiases when it
downsamples: the triangle kernel is widened by 1/scale.  PyTorch's
``F.interpolate`` offers no antialias for 1-D linear resizing, so the resize
here builds the same weight matrix explicitly (half-pixel centres, widened
kernel when downsampling, columns normalised, samples outside the input
zeroed) and applies it per axis.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch

from videoprism_tpu_torch.ops import basic

Params = dict[str, Any]


def token_embedding(params: Params, ids: torch.Tensor, *,
                    scale_sqrt_depth: bool = False,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
  """Rows ``ids`` of ``{'emb_var': [V, D]}`` (the JAX package's 'index'
  lookup), times ``sqrt(D)`` with ``scale_sqrt_depth`` (the text tower's
  convention) -> [..., D]."""
  emb_var = basic.cast_floating(params['emb_var'], dtype)
  embs = emb_var[ids]
  return embs * emb_var.shape[-1] ** 0.5 if scale_sqrt_depth else embs


def sinusoidal_positional_embedding(seq_length: int, embedding_dim: int, *,
                                    dtype: torch.dtype = torch.float32,
                                    device=None) -> torch.Tensor:
  """[1, L, D] table ``concat([sin, cos])`` over geometric timescales from
  1 to 10^4.

  Computed in fp32 and cast once, as the JAX package does (its fp32 trig is
  load-bearing for parity).
  """
  f32 = torch.float32
  position = torch.arange(seq_length, dtype=f32, device=device)[None, :]
  num_timescales = embedding_dim // 2
  increment = np.float32(math.log(10_000.0)) / np.float32(
      max(num_timescales - 1, 1))
  inv_timescales = torch.exp(
      torch.arange(num_timescales, dtype=f32, device=device)
      * -float(increment))
  scaled_time = position[:, :, None] * inv_timescales[None, None, :]
  embs = torch.cat([torch.sin(scaled_time), torch.cos(scaled_time)],
                   dim=-1).to(dtype)
  return torch.nn.functional.pad(embs, (0, embedding_dim % 2))


def trainable_positional_embedding(params: Params, seq_length: int, *,
                                   dtype: torch.dtype = torch.float32
                                   ) -> torch.Tensor:
  """[1, L, D] learned table, rows ``0..L-1`` of ``{'emb_var': [Lmax, D]}``.

  The JAX package looks the rows up with a one-hot matmul, which on the CPU
  in fp32 is an exact slice; the port slices.
  """
  return basic.cast_floating(params['emb_var'][:seq_length], dtype)[None]


def _resize_weights(in_size: int, out_size: int) -> np.ndarray:
  """[in, out] triangle-kernel weights of ``jax.image.resize`` (antialias)."""
  f32 = np.float32
  inv_scale = 1.0 / (out_size / in_size)
  kernel_scale = f32(max(inv_scale, 1.0))
  sample = (np.arange(out_size, dtype=f32) + f32(0.5)) * f32(inv_scale) - f32(0.5)
  x = np.abs(sample[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
  w = np.maximum(f32(0.0), f32(1.0) - np.abs(x))
  total = w.sum(axis=0, keepdims=True)
  w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
               w / np.where(total != 0, total, f32(1.0)), f32(0.0))
  inside = (sample >= -0.5) & (sample <= in_size - 0.5)
  return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def _resize_axis(x: torch.Tensor, axis: int, size: int) -> torch.Tensor:
  if x.shape[axis] == size:
    return x
  w = torch.from_numpy(_resize_weights(x.shape[axis], size)).to(
      device=x.device, dtype=x.dtype)
  return torch.movedim(torch.tensordot(x, w, dims=([axis], [0])), -1, axis)


def interpolate_emb_1d(emb: torch.Tensor, target_emb_length: int
                       ) -> torch.Tensor:
  """Bilinear 1-D resize of a [1, N, D] pos-emb to [1, target, D]."""
  if emb.ndim != 3 or emb.shape[0] != 1:
    raise ValueError('The shape of the embedding should be (1, N, D)')
  return _resize_axis(emb, 1, target_emb_length)


def interpolate_emb_2d(emb: torch.Tensor, source_emb_shape: tuple[int, int],
                       target_emb_shape: tuple[int, int]) -> torch.Tensor:
  """Bilinear 2-D resize of a flattened [1, H1*W1, D] pos-emb grid."""
  if emb.ndim != 3 or emb.shape[0] != 1:
    raise ValueError('The shape of the embedding should be (1, H * W, D)')
  if emb.shape[-2] != source_emb_shape[0] * source_emb_shape[1]:
    raise ValueError('The shape of the embedding does NOT match input specs.')
  d = emb.shape[-1]
  grid = emb.reshape(source_emb_shape[0], source_emb_shape[1], d)
  grid = _resize_axis(grid, 0, target_emb_shape[0])
  grid = _resize_axis(grid, 1, target_emb_shape[1])
  return grid.reshape(1, target_emb_shape[0] * target_emb_shape[1], d)


def image_to_patch(inputs: torch.Tensor, patch_size: int) -> torch.Tensor:
  """[..., H, W, C] -> [..., H*W/P^2, P^2*C] non-overlapping square patches,
  flattened in (p1, p2, c) order."""
  if inputs.ndim < 4:
    raise ValueError(
        f'Image should be formatted as 4D [B, H, W, C], Shape: {inputs.shape}')
  height, width, channels = inputs.shape[-3:]
  if height % patch_size or width % patch_size:
    raise ValueError(
        f'Image height ({height}) and width ({width}) should be multiples '
        f'of patch_size ({patch_size}).')
  m, n, p = height // patch_size, width // patch_size, patch_size
  batch = tuple(inputs.shape[:-3])
  x = inputs.reshape(batch + (m, p, n, p, channels))
  nb = len(batch)
  x = x.permute(*range(nb), nb, nb + 2, nb + 1, nb + 3, nb + 4)
  return x.reshape(batch + (m * n, p * p * channels))

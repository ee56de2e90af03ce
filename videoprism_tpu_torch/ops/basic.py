"""Basic functional ops (port of ``videoprism_tpu.ops.basic``).

Pure functions over explicit parameter dicts whose keys follow the
checkpoint schema (a dense layer is ``{'linear': {'kernel': [in, out],
'bias': [out]}}``).  Conventions kept from the reference: exact (erf) GELU,
LayerNorm with ``scale + 1``, and the softplus per-dim query scale.

:func:`layer_norm` routes a CUDA tensor through K6, the standalone LN
kernel (``ops/kernels/layer_norm.py``), as the JAX package routes it
through its Pallas LN on the TPU.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from videoprism_tpu_torch.ops.kernels import _lib
from videoprism_tpu_torch.ops.kernels import layer_norm as ln_kernel

Params = dict[str, Any]


def gelu(x: torch.Tensor) -> torch.Tensor:
  """Exact GELU, ``0.5 * x * (1 + erf(x / sqrt(2)))``."""
  return F.gelu(x, approximate='none')


def relu(x: torch.Tensor) -> torch.Tensor:
  return torch.relu(x)


def identity(x: torch.Tensor) -> torch.Tensor:
  return x


ACTIVATIONS = {'gelu': gelu, 'relu': relu, 'identity': identity}


def cast_floating(x: torch.Tensor | None, dtype: torch.dtype):
  """Casts floating-point tensors to ``dtype``; leaves others untouched."""
  if x is None or not x.is_floating_point() or x.dtype == dtype:
    return x
  return x.to(dtype)


def layer_norm(
    params: Params,
    inputs: torch.Tensor,
    *,
    epsilon: float = 1e-6,
    direct_scale: bool = False,
    dtype: torch.dtype = torch.float32,
    impl: str = 'auto',
) -> torch.Tensor:
  """LayerNorm over the last axis with the reference's ``scale + 1``.

  ``impl`` follows the kernel wrappers' rule (``ops/kernels/_lib.py``): a
  CUDA tensor runs K6 ``fused_layer_norm_2d`` over the flattened rows (fp32
  statistics, one cast), at any row count and any even D: the JAX
  package's ``rows % 8 == 0 and D % 128 == 0`` gate is TPU tiling and is
  not ported.  A CPU tensor, or ``impl='reference'``, takes the plain path
  of the JAX package, with statistics in the input dtype.
  """
  scale = cast_floating(params['scale'], dtype)
  bias = cast_floating(params['bias'], dtype)
  if _lib.use_kernel(impl, inputs):
    d = inputs.shape[-1]
    return ln_kernel.fused_layer_norm_2d(
        inputs.reshape(-1, d).contiguous(), scale, bias, epsilon=epsilon,
        direct_scale=direct_scale, impl=impl).reshape(inputs.shape)
  mean = inputs.mean(-1, keepdim=True)
  var = (inputs - mean).square().mean(-1, keepdim=True)
  normed = (inputs - mean) * torch.rsqrt(var + epsilon)
  if not direct_scale:
    scale = scale + 1.0
  return normed * scale + bias


def dense(params: Params, inputs: torch.Tensor, *,
          dtype: torch.dtype = torch.float32) -> torch.Tensor:
  """``inputs @ kernel + bias`` with ``{'kernel': [in, out], 'bias'}``."""
  return (inputs @ cast_floating(params['kernel'], dtype)
          + cast_floating(params['bias'], dtype))


def feed_forward(params: Params, inputs: torch.Tensor, *,
                 activation: str = 'relu',
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
  """Dense + activation, stored under the ``linear`` sub-key."""
  return ACTIVATIONS[activation](dense(params['linear'], inputs, dtype=dtype))


def per_dim_scale(params: Params, inputs: torch.Tensor, *,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
  """``x * 1.442695041 / sqrt(D) * softplus(w)``; ``{'per_dim_scale': [D]}``."""
  dim = inputs.shape[-1]
  w = cast_floating(params['per_dim_scale'], dtype)
  scale = torch.tensor(1.442695041 / np.sqrt(dim), dtype=dtype,
                       device=inputs.device)
  return inputs * (scale * F.softplus(w))


def l2_normalize(x: torch.Tensor, dim: int = -1,
                 epsilon: float = 1e-12) -> torch.Tensor:
  """L2-normalizes in float32 with eps inside the sqrt, then casts back."""
  xf = x.float()
  norm = torch.sqrt((xf * xf).sum(dim, keepdim=True) + epsilon)
  return (xf / norm).to(x.dtype)

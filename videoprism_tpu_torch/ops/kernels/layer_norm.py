"""K6: the standalone row LayerNorm.

Ports ``videoprism_tpu/ops/pallas/layer_norm.py`` ``fused_layer_norm_2d``
(``_ln_kernel``): [rows, D] -> [rows, D], mean and variance in fp32, eps
1e-6, ``(x - mean) * rsqrt(var + eps) * (scale + 1) + bias`` (``* scale``
with ``direct_scale``), cast once.  On a CUDA tensor it runs
``csrc/ln_rows.cu`` (``vp_layer_norm``, one warp per row held in
registers); on a CPU tensor, or with ``impl='reference'``, the plain twin
beside it, which rounds at the same point.  The kernel takes bf16 and
raises on fp32 CUDA tensors.

The TPU gate ``rows % 8 == 0 and D % 128 == 0`` (``supports``) is the
TPU's (8, 128) tiling and is not ported: any row count and any even D run.

Under autograd it runs through ``_LayerNorm2d``, whose backward is that of
the reference's ``_ln_vjp`` (the VJP of ``_composed_layer_norm_2d``).
"""

from __future__ import annotations

import torch

from videoprism_tpu_torch.ops.kernels import _lib
from videoprism_tpu_torch.ops.kernels.transformer_block import (
    ln_backward,
    ln_f32,
)


def fused_layer_norm_2d(
    x: torch.Tensor,        # [rows, D]
    scale: torch.Tensor,    # [D]
    bias: torch.Tensor,     # [D]
    *,
    epsilon: float = 1e-6,
    direct_scale: bool = False,
    impl: str = 'auto',
) -> torch.Tensor:
  """Row LayerNorm with fp32 statistics -> [rows, D] in x's dtype."""
  if _lib.needs_grad(impl, x, scale, bias):
    return _LayerNorm2d.apply(epsilon, direct_scale, impl, x, scale, bias)
  return _layer_norm_2d(x, scale, bias, epsilon, direct_scale, impl)


def _layer_norm_2d(x, scale, bias, epsilon, direct_scale, impl):
  if not _lib.use_kernel(impl, x):
    return ln_f32(x, scale, bias, epsilon, direct_scale).to(x.dtype)
  rows, d = x.shape
  _lib.check_tensors(x.device, x=x, scale=scale, bias=bias)
  if scale.shape != (d,) or bias.shape != (d,) or d % 2 or rows == 0:
    _lib.check(rows > 0, 'x has no rows')
    raise ValueError(
        f'scale and bias must be [D] with D even; x is {tuple(x.shape)}')
  out = torch.empty_like(x)
  _lib.launch('vp_layer_norm', x.device, x, scale, bias, out, rows, d,
              int(direct_scale), epsilon)
  _lib.LAUNCHES['fused_layer_norm_2d'] += 1
  return out


class _LayerNorm2d(torch.autograd.Function):
  """K6 forward; the fp32 LN backward (``_ln_vjp``)."""

  @staticmethod
  def forward(ctx, epsilon, direct_scale, impl, x, scale, bias):
    ctx.save_for_backward(x, scale)
    ctx.static = (epsilon, direct_scale, bias.dtype)
    return _layer_norm_2d(x, scale, bias, epsilon, direct_scale, impl)

  @staticmethod
  def backward(ctx, g):
    x, scale = ctx.saved_tensors
    epsilon, direct_scale, bias_dtype = ctx.static
    dx, dscale, dbias = ln_backward(x, scale, g, epsilon, direct_scale)
    return (None, None, None, dx.to(x.dtype), dscale.to(scale.dtype),
            dbias.to(bias_dtype))

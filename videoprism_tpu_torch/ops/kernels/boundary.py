"""K3 and K4: the factorized encoder's two stack boundaries, one pass each.

Ports ``videoprism_tpu/ops/pallas/boundary.py`` ``spatial_to_temporal``
(K3: spatial_ln + temporal pos-emb + regroup ``(b t) n d -> (b n) t d``) and
``temporal_to_output`` (K4: temporal_ln + regroup ``(b n) t d -> b (t n) d``).
On a CUDA tensor each runs ``csrc/ln_rows.cu``; on a CPU tensor, or with
``impl='reference'``, the plain twin.  Both round like the TPU kernel
(``_st_kernel``): LN in fp32, plus the pos-emb in fp32, one cast.  The
kernels take bf16 and raise on fp32 CUDA tensors.

Under autograd each runs through a ``torch.autograd.Function`` whose
backward is the VJP of the reference's composed twin (``_composed_st``,
``_composed_ts``): the regroup undone, the fp32 LN backward and, for K3,
the pos-emb's cotangent summed over the B*N sequences.
"""

from __future__ import annotations

import torch

from videoprism_tpu_torch.ops.kernels import _lib
from videoprism_tpu_torch.ops.kernels.transformer_block import (
    ln_backward,
    ln_f32,
)


def _reference_spatial_to_temporal(features, ln_scale, ln_bias, pos, *, b, t,
                                   epsilon):
  _, n, d = features.shape
  y = ln_f32(features, ln_scale, ln_bias, epsilon)
  y = y.reshape(b, t, n, d).transpose(1, 2).reshape(b * n, t, d)
  return (y + pos.float()).to(features.dtype)


def spatial_to_temporal(
    features: torch.Tensor,   # [B*T, N, D] spatial-stack output
    ln_scale: torch.Tensor, ln_bias: torch.Tensor,   # [D] spatial_ln
    pos_emb: torch.Tensor,    # [T, D] or [1, T, D] temporal pos-emb
    *,
    b: int, t: int,
    epsilon: float = 1e-6,
    impl: str = 'auto',
) -> torch.Tensor:
  """LN + pos-emb + regroup ``(b t) n d -> (b n) t d`` -> [B*N, T, D]."""
  bt, n, d = features.shape
  pos = pos_emb.reshape(-1, pos_emb.shape[-1])
  if bt != b * t or tuple(pos.shape) != (t, d):
    raise ValueError(f'features {tuple(features.shape)} / pos_emb '
                     f'{tuple(pos_emb.shape)} do not match b={b}, t={t}')
  if _lib.needs_grad(impl, features, ln_scale, ln_bias, pos_emb):
    return _SpatialToTemporal.apply(b, t, epsilon, impl, features, ln_scale,
                                    ln_bias, pos_emb)
  return _spatial_to_temporal(features, ln_scale, ln_bias, pos, b, t,
                              epsilon, impl)


def _spatial_to_temporal(features, ln_scale, ln_bias, pos, b, t, epsilon,
                         impl):
  _, n, d = features.shape
  if not _lib.use_kernel(impl, features):
    return _reference_spatial_to_temporal(features, ln_scale, ln_bias, pos,
                                          b=b, t=t, epsilon=epsilon)
  pos = pos.contiguous()
  _lib.check_tensors(features.device, features=features, ln_scale=ln_scale,
                     ln_bias=ln_bias, pos_emb=pos)
  _lib.check(ln_scale.shape == (d,) and ln_bias.shape == (d,) and d % 2 == 0,
             'LN parameters must be [D] with D even')
  out = torch.empty((b * n, t, d), dtype=features.dtype,
                    device=features.device)
  _lib.launch('vp_spatial_to_temporal', features.device,
              features, ln_scale, ln_bias, pos, out, b, t, n, d, epsilon)
  _lib.LAUNCHES['spatial_to_temporal'] += 1
  return out


class _SpatialToTemporal(torch.autograd.Function):
  """K3 forward; the VJP of ``_composed_st`` backward."""

  @staticmethod
  def forward(ctx, b, t, epsilon, impl, features, ln_scale, ln_bias,
              pos_emb):
    ctx.save_for_backward(features, ln_scale)
    ctx.static = (b, t, epsilon, pos_emb.shape, pos_emb.dtype)
    pos = pos_emb.reshape(-1, pos_emb.shape[-1])
    return _spatial_to_temporal(features, ln_scale, ln_bias, pos, b, t,
                                epsilon, impl)

  @staticmethod
  def backward(ctx, g):
    features, ln_scale = ctx.saved_tensors
    b, t, epsilon, pos_shape, pos_dtype = ctx.static
    _, n, d = features.shape
    dpos = g.float().sum(0)                                  # [T, D]
    dy = g.reshape(b, n, t, d).transpose(1, 2).reshape(b * t, n, d)
    dx, dscale, dbias = ln_backward(features, ln_scale, dy, epsilon)
    return (None, None, None, None, dx.to(features.dtype),
            dscale.to(ln_scale.dtype), dbias.to(ln_scale.dtype),
            dpos.reshape(pos_shape).to(pos_dtype))


def _reference_temporal_to_output(features, ln_scale, ln_bias, *, b, n,
                                  epsilon):
  _, t, d = features.shape
  y = ln_f32(features, ln_scale, ln_bias, epsilon).to(features.dtype)
  return y.reshape(b, n, t, d).transpose(1, 2).reshape(b, t * n, d)


def temporal_to_output(
    features: torch.Tensor,   # [B*N, T, D] temporal-stack output
    ln_scale: torch.Tensor, ln_bias: torch.Tensor,   # [D] temporal_ln
    *,
    b: int, n: int,
    epsilon: float = 1e-6,
    impl: str = 'auto',
) -> torch.Tensor:
  """LN + regroup ``(b n) t d -> b (t n) d`` -> [B, T*N, D]."""
  bn, t, d = features.shape
  if bn != b * n:
    raise ValueError(
        f'features {tuple(features.shape)} do not match b={b}, n={n}')
  if _lib.needs_grad(impl, features, ln_scale, ln_bias):
    return _TemporalToOutput.apply(b, n, epsilon, impl, features, ln_scale,
                                   ln_bias)
  return _temporal_to_output(features, ln_scale, ln_bias, b, n, epsilon,
                             impl)


def _temporal_to_output(features, ln_scale, ln_bias, b, n, epsilon, impl):
  _, t, d = features.shape
  if not _lib.use_kernel(impl, features):
    return _reference_temporal_to_output(features, ln_scale, ln_bias, b=b,
                                         n=n, epsilon=epsilon)
  _lib.check_tensors(features.device, features=features, ln_scale=ln_scale,
                     ln_bias=ln_bias)
  _lib.check(ln_scale.shape == (d,) and ln_bias.shape == (d,) and d % 2 == 0,
             'LN parameters must be [D] with D even')
  out = torch.empty((b, t * n, d), dtype=features.dtype,
                    device=features.device)
  _lib.launch('vp_temporal_to_output', features.device,
              features, ln_scale, ln_bias, out, b, n, t, d, epsilon)
  _lib.LAUNCHES['temporal_to_output'] += 1
  return out


class _TemporalToOutput(torch.autograd.Function):
  """K4 forward; the VJP of ``_composed_ts`` backward."""

  @staticmethod
  def forward(ctx, b, n, epsilon, impl, features, ln_scale, ln_bias):
    ctx.save_for_backward(features, ln_scale)
    ctx.static = (b, n, epsilon)
    return _temporal_to_output(features, ln_scale, ln_bias, b, n, epsilon,
                               impl)

  @staticmethod
  def backward(ctx, g):
    features, ln_scale = ctx.saved_tensors
    b, n, epsilon = ctx.static
    _, t, d = features.shape
    dy = g.reshape(b, t, n, d).transpose(1, 2).reshape(b * n, t, d)
    dx, dscale, dbias = ln_backward(features, ln_scale, dy, epsilon)
    return (None, None, None, None, dx.to(features.dtype),
            dscale.to(ln_scale.dtype), dbias.to(ln_scale.dtype))

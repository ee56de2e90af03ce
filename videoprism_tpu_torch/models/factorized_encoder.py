"""ViViT model-2 factorized space-time video encoder (port of
``videoprism_tpu.models.factorized_encoder``).

Pipeline for a ``[B, T, H, W, 3]`` clip (P = patch size, N = H*W/P^2):

    patches [B*T, N, P^2*3] -> patch_projection            [B*T, N, D]
      -> + spatial pos-emb (bilinear-resized if the grid differs)
      -> spatial stack (K1 + K2 per layer)
      -> K3 spatial_to_temporal: spatial_ln, + temporal pos-emb, regroup
      -> temporal stack (K1 + K2 per layer)
      -> K4 temporal_to_output: temporal_ln, regroup          [B, T*N, D]

``impl`` ('auto' | 'kernel' | 'reference') reaches every kernel wrapper:
'auto' runs the hand-written kernels for CUDA tensors and their plain twins
for CPU tensors; 'reference' runs the twins anywhere.  The patch embed is
outside the TPU kernels in the JAX package too and stays a plain matmul.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Collection
from typing import Any

import numpy as np
import torch

from videoprism_tpu_torch.ops import basic
from videoprism_tpu_torch.ops import embeddings as emb_lib
from videoprism_tpu_torch.ops.kernels import boundary as boundary_lib
from videoprism_tpu_torch.ops.transformer import (
    TransformerLayerConfig,
    stacked_transformer,
)

Params = dict[str, Any]


def contains(collection: Collection[str] | bool, key: str) -> bool:
  """True if ``collection`` is True or contains ``key``."""
  return collection if isinstance(collection, bool) else key in collection


@dataclasses.dataclass(frozen=True)
class FactorizedEncoderConfig:
  patch_size: int = 18
  pos_emb_shape: tuple[int, int, int] = (16, 16, 16)
  model_dim: int = 768
  num_spatial_layers: int = 12
  num_temporal_layers: int = 4
  num_heads: int = 12
  mlp_dim: int = 3072
  atten_logit_cap: float = 0.0
  norm_policy: str = 'pre'
  scan: bool = True
  dtype: torch.dtype = torch.float32

  def vit_layer_config(self, num_layers: int) -> TransformerLayerConfig:
    """ViT stack config: gelu, per-dim scale off, non-causal."""
    return TransformerLayerConfig(
        num_layers=num_layers,
        hidden_dim=self.mlp_dim,
        num_heads=self.num_heads,
        norm_policy=self.norm_policy,
        activation='gelu',
        enable_per_dim_scale=False,
        logit_cap=self.atten_logit_cap,
        enable_causal_atten=False,
        scan=self.scan,
        dtype=self.dtype,
    )


def vision_transformer(params: Params, inputs: torch.Tensor,
                       cfg: TransformerLayerConfig, *,
                       paddings: torch.Tensor | None = None,
                       impl: str = 'auto') -> torch.Tensor:
  """ViT = stacked transformer under the ``transformers_stack`` key."""
  if paddings is None:
    paddings = torch.zeros(inputs.shape[:-1], dtype=inputs.dtype,
                           device=inputs.device)
  return stacked_transformer(params['transformers_stack'], inputs, paddings,
                             cfg, impl=impl)


def _embed_patches(params: Params, inputs: torch.Tensor,
                   cfg: FactorizedEncoderConfig) -> torch.Tensor:
  """Video [B, T, H, W, 3] -> projected patch tokens [B*T, N, D]."""
  b, t, h, w, c = inputs.shape
  frames = inputs.to(cfg.dtype).reshape(b * t, h, w, c)
  patches = emb_lib.image_to_patch(frames, cfg.patch_size)
  return basic.feed_forward(params['patch_projection'], patches,
                            activation='identity', dtype=cfg.dtype)


def _spatial_pos_emb(params: Params, cfg: FactorizedEncoderConfig, h: int,
                     w: int) -> torch.Tensor:
  grid = tuple(cfg.pos_emb_shape[-2:])
  pos = emb_lib.trainable_positional_embedding(
      params['spatial_pos_emb'], int(np.prod(grid)), dtype=cfg.dtype)
  target = (h // cfg.patch_size, w // cfg.patch_size)
  if grid != target:
    pos = emb_lib.interpolate_emb_2d(pos, grid, target)
  return pos


def _temporal_pos_emb(params: Params, cfg: FactorizedEncoderConfig,
                      t: int) -> torch.Tensor:
  pos = emb_lib.trainable_positional_embedding(
      params['temporal_pos_emb'], cfg.pos_emb_shape[0], dtype=cfg.dtype)
  if cfg.pos_emb_shape[0] != t:
    pos = emb_lib.interpolate_emb_1d(pos, t)
  return pos


def _frame_to_patch_paddings(frame_paddings, b, t, num_patches):
  if frame_paddings is None:
    return None
  if tuple(frame_paddings.shape) != (b, t):
    raise ValueError(
        f'frame_paddings {tuple(frame_paddings.shape)} != {(b, t)}')
  return frame_paddings.reshape(b * t, 1).expand(b * t, num_patches)


def apply(params: Params, inputs: torch.Tensor, cfg: FactorizedEncoderConfig,
          *, return_intermediate: bool | Collection[str] = False,
          frame_paddings: torch.Tensor | None = None,
          impl: str = 'auto') -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
  """Video [B, T, H, W, 3] -> (embeddings [B, T*N, D], intermediates)."""
  b, t, h, w, _ = inputs.shape
  if h != w:
    raise ValueError(f'frames must be square, got {h}x{w}')
  patches = _embed_patches(params, inputs, cfg)
  return _encode_projected(
      params, patches, (t, h, w), cfg,
      return_intermediate=return_intermediate,
      patches_paddings=_frame_to_patch_paddings(
          frame_paddings, b, t, patches.shape[1]),
      impl=impl)


def encode_with_patches(
    params: Params, patches: torch.Tensor, image_shape: tuple[int, int, int],
    cfg: FactorizedEncoderConfig, *,
    return_intermediate: bool | Collection[str] = False,
    patches_paddings: torch.Tensor | None = None,
    impl: str = 'auto') -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
  """Raw patches [B*T, N, P^2*C] -> embeddings [B, T*N, D]."""
  projected = basic.feed_forward(
      params['patch_projection'], patches.to(cfg.dtype),
      activation='identity', dtype=cfg.dtype)
  return _encode_projected(params, projected, image_shape, cfg,
                           return_intermediate=return_intermediate,
                           patches_paddings=patches_paddings, impl=impl)


def _encode_projected(params, patches, image_shape, cfg, *,
                      return_intermediate, patches_paddings, impl):
  dtype = cfg.dtype
  t, h, w = image_shape
  b = patches.shape[0] // t
  patches = patches + _spatial_pos_emb(params, cfg, h, w)
  if patches_paddings is not None:
    patches_paddings = patches_paddings.to(dtype)

  features = vision_transformer(
      params['spatial_encoder'], patches,
      cfg.vit_layer_config(cfg.num_spatial_layers),
      paddings=patches_paddings, impl=impl)
  n, d = features.shape[1], features.shape[2]

  temporal_paddings = None
  if patches_paddings is not None:
    temporal_paddings = patches_paddings.reshape(b, t, n).transpose(
        1, 2).reshape(b * n, t)
  temporal_pos_emb = _temporal_pos_emb(params, cfg, t)

  cast = lambda a: basic.cast_floating(a, dtype)
  outputs = {}
  if contains(return_intermediate, 'spatial_features'):
    # The composed boundary, as in the JAX package when the spatial
    # features are asked for: LN (in dtype), regroup, + pos-emb.
    features = basic.layer_norm(params['spatial_ln'], features, dtype=dtype,
                                impl=impl)
    outputs['spatial_features'] = features.reshape(b, t * n, d)
    features = features.reshape(b, t, n, d).transpose(1, 2).reshape(
        b * n, t, d) + temporal_pos_emb
  else:
    features = boundary_lib.spatial_to_temporal(
        features, cast(params['spatial_ln']['scale']),
        cast(params['spatial_ln']['bias']), temporal_pos_emb, b=b, t=t,
        impl=impl)

  features = vision_transformer(
      params['temporal_encoder'], features,
      cfg.vit_layer_config(cfg.num_temporal_layers),
      paddings=temporal_paddings, impl=impl)
  features = boundary_lib.temporal_to_output(
      features, cast(params['temporal_ln']['scale']),
      cast(params['temporal_ln']['bias']), b=b, n=n, impl=impl)
  return features, outputs


def encode_spatial(params: Params, inputs: torch.Tensor,
                   cfg: FactorizedEncoderConfig, *,
                   frame_paddings: torch.Tensor | None = None,
                   impl: str = 'auto') -> torch.Tensor:
  """Spatial half only: video [B, T, H, W, 3] -> per-frame features
  [B, T, N, D] (after spatial_ln, before the temporal pos-emb)."""
  b, t, h, w, _ = inputs.shape
  if h != w:
    raise ValueError(f'frames must be square, got {h}x{w}')
  patches = _embed_patches(params, inputs, cfg)
  paddings = _frame_to_patch_paddings(frame_paddings, b, t, patches.shape[1])
  patches = patches + _spatial_pos_emb(params, cfg, h, w)
  features = vision_transformer(
      params['spatial_encoder'], patches,
      cfg.vit_layer_config(cfg.num_spatial_layers),
      paddings=None if paddings is None else paddings.to(cfg.dtype),
      impl=impl)
  features = basic.layer_norm(params['spatial_ln'], features, dtype=cfg.dtype,
                              impl=impl)
  return features.reshape(b, t, features.shape[1], features.shape[2])


def encode_temporal(params: Params, spatial_features: torch.Tensor,
                    cfg: FactorizedEncoderConfig, *,
                    frame_paddings: torch.Tensor | None = None,
                    impl: str = 'auto') -> torch.Tensor:
  """Temporal half only: [B, T, N, D] from :func:`encode_spatial` ->
  embeddings [B, T*N, D]."""
  dtype = cfg.dtype
  b, t, n, d = spatial_features.shape
  features = spatial_features.to(dtype).transpose(1, 2).reshape(b * n, t, d)
  features = features + _temporal_pos_emb(params, cfg, t)
  paddings = None
  if frame_paddings is not None:
    if tuple(frame_paddings.shape) != (b, t):
      raise ValueError(
          f'frame_paddings {tuple(frame_paddings.shape)} != {(b, t)}')
    paddings = frame_paddings[:, None, :].expand(b, n, t).reshape(
        b * n, t).to(dtype)
  features = vision_transformer(
      params['temporal_encoder'], features,
      cfg.vit_layer_config(cfg.num_temporal_layers),
      paddings=paddings, impl=impl)
  features = basic.layer_norm(params['temporal_ln'], features, dtype=dtype,
                              impl=impl)
  return features.reshape(b, n, t, d).transpose(1, 2).reshape(b, t * n, d)

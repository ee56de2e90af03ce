"""Dual-tower video-text CLIP with a factorized vision encoder (port of
``videoprism_tpu.models.clip``).

Vision: the factorized encoder (K1-K4) -> an auxiliary ViT over all T*N
tokens (K6 + K5 for the attention half, K2 for the FFN) -> a one-query
attention pooler (plain attention, K6 output LN) -> l2-normalize -> [B, D].
Text: the causal text tower (K1, K2, K6) -> last (class) token ->
l2-normalize -> [B, D].  Either modality can be skipped by passing
``None``.  ``impl`` ('auto' | 'kernel' | 'reference') reaches every kernel
wrapper, as in ``factorized_encoder``.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Collection
from typing import Any

import torch

from videoprism_tpu_torch.models import factorized_encoder as fe
from videoprism_tpu_torch.models import text_encoder as te
from videoprism_tpu_torch.ops import basic
from videoprism_tpu_torch.ops.transformer import atten_token_pooling

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class VideoCLIPConfig:
  # Vision parameters.
  patch_size: int = 18
  pos_emb_shape: tuple[int, int, int] = (16, 16, 16)
  num_spatial_layers: int = 12
  num_temporal_layers: int = 4
  mlp_dim: int = 3072
  num_auxiliary_layers: int = 0
  # Text parameters.
  vocabulary_size: int = 128
  enable_causal_atten: bool = True
  num_unimodal_layers: int = 12
  norm_policy: str = 'pre'
  # Shared parameters.
  model_dim: int = 768
  num_heads: int = 12
  atten_logit_cap: float = 0.0
  scan: bool = True
  dtype: torch.dtype = torch.float32

  def vision_config(self) -> fe.FactorizedEncoderConfig:
    """The vision tower always uses pre-norm."""
    return fe.FactorizedEncoderConfig(
        patch_size=self.patch_size,
        pos_emb_shape=self.pos_emb_shape,
        model_dim=self.model_dim,
        num_spatial_layers=self.num_spatial_layers,
        num_temporal_layers=self.num_temporal_layers,
        num_heads=self.num_heads,
        mlp_dim=self.mlp_dim,
        atten_logit_cap=self.atten_logit_cap,
        norm_policy='pre',
        scan=self.scan,
        dtype=self.dtype,
    )

  def text_config(self) -> te.TextEncoderConfig:
    """Text tower with one class token and mlp = 4 * D."""
    return te.TextEncoderConfig(
        vocabulary_size=self.vocabulary_size,
        num_class_tokens=1,
        enable_causal_atten=self.enable_causal_atten,
        model_dim=self.model_dim,
        num_layers=self.num_unimodal_layers,
        num_heads=self.num_heads,
        mlp_dim=self.model_dim * 4,
        atten_logit_cap=self.atten_logit_cap,
        norm_policy=self.norm_policy,
        scan=self.scan,
        dtype=self.dtype,
    )


def _auxiliary(params: Params, tokens: torch.Tensor, cfg: VideoCLIPConfig,
               impl: str) -> torch.Tensor:
  if cfg.num_auxiliary_layers <= 0:
    return tokens
  aux_cfg = cfg.vision_config().vit_layer_config(cfg.num_auxiliary_layers)
  return fe.vision_transformer(params['auxiliary_encoder'], tokens, aux_cfg,
                               impl=impl)


def _pool(params: Params, tokens: torch.Tensor, cfg: VideoCLIPConfig,
          impl: str) -> torch.Tensor:
  """[B', S, D] tokens -> [B', D] through the contrastive pooler."""
  return atten_token_pooling(
      params['contrastive_vision_pooler'], tokens, None,
      num_heads=cfg.num_heads, hidden_dim=cfg.model_dim * 4,
      dtype=cfg.dtype, impl=impl).squeeze(-2)


def _frame_pool(params, tokens, cfg, num_frames, normalize, impl):
  b, d = tokens.shape[0], tokens.shape[-1]
  # b (t n) d -> (b t) n d
  frames = _pool(params, tokens.reshape(b * num_frames, -1, d), cfg, impl)
  frames = frames.reshape(b, num_frames, d)
  return basic.l2_normalize(frames) if normalize else frames


def encode_vision(params: Params, inputs: torch.Tensor, cfg: VideoCLIPConfig,
                  *, normalize: bool = True,
                  return_intermediate: bool | Collection[str] = False,
                  frame_paddings: torch.Tensor | None = None,
                  impl: str = 'auto'
                  ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
  """Video [B, T, H, W, 3] -> contrastive embeddings [B, D]."""
  num_frames = inputs.shape[-4]
  features, outputs = fe.apply(
      params['vision_encoder'], inputs, cfg.vision_config(),
      return_intermediate=return_intermediate,
      frame_paddings=frame_paddings, impl=impl)
  if fe.contains(return_intermediate, 'spatiotemporal_features'):
    outputs['spatiotemporal_features'] = features
  features = _auxiliary(params, features, cfg, impl)
  video_embeddings = _pool(params, features, cfg, impl)
  if normalize:
    video_embeddings = basic.l2_normalize(video_embeddings)
  if fe.contains(return_intermediate, 'frame_embeddings'):
    outputs['frame_embeddings'] = _frame_pool(
        params, features, cfg, num_frames, normalize, impl)
  return video_embeddings, outputs


def pool_vision_tokens(params: Params, vision_features: torch.Tensor,
                       cfg: VideoCLIPConfig, *, normalize: bool = True,
                       impl: str = 'auto') -> torch.Tensor:
  """Encoder tokens [B, T*N, D] -> contrastive embeddings [B, D] (the tail
  of :func:`encode_vision`: auxiliary ViT, pooler, l2-normalize)."""
  pooled = _pool(params, _auxiliary(params, vision_features, cfg, impl), cfg,
                 impl)
  return basic.l2_normalize(pooled) if normalize else pooled


def frame_embeddings_from_tokens(params: Params,
                                 vision_features: torch.Tensor,
                                 cfg: VideoCLIPConfig, *, num_frames: int,
                                 normalize: bool = True,
                                 impl: str = 'auto') -> torch.Tensor:
  """Encoder tokens [B, T*N, D] -> per-frame embeddings [B, T, D]: the
  auxiliary ViT over the whole sequence, then the pooler per frame."""
  return _frame_pool(params, _auxiliary(params, vision_features, cfg, impl),
                     cfg, num_frames, normalize, impl)


def encode_text(params: Params, text_token_ids: torch.Tensor,
                text_paddings: torch.Tensor, cfg: VideoCLIPConfig, *,
                normalize: bool = True, impl: str = 'auto') -> torch.Tensor:
  """Text ids [B, L] -> contrastive embeddings [B, D] (the last, class,
  token)."""
  features = te.apply(params['text_encoder'], text_token_ids, text_paddings,
                      cfg.text_config(), impl=impl)
  text_embeddings = features[:, -1]
  return basic.l2_normalize(text_embeddings) if normalize else text_embeddings


def apply(params: Params, inputs: torch.Tensor | None = None,
          text_token_ids: torch.Tensor | None = None,
          text_paddings: torch.Tensor | None = None,
          cfg: VideoCLIPConfig = VideoCLIPConfig(), *,
          normalize: bool = True,
          return_intermediate: bool | Collection[str] = False,
          frame_paddings: torch.Tensor | None = None,
          impl: str = 'auto'
          ) -> tuple[torch.Tensor | None, torch.Tensor | None,
                     dict[str, torch.Tensor]]:
  """Full CLIP forward -> (video [B, D] | None, text [B, D] | None,
  intermediates); either modality may be ``None``."""
  video_embeddings, text_embeddings, outputs = None, None, {}
  if inputs is not None:
    video_embeddings, outputs = encode_vision(
        params, inputs, cfg, normalize=normalize,
        return_intermediate=return_intermediate,
        frame_paddings=frame_paddings, impl=impl)
  if text_token_ids is not None:
    if text_paddings is None:
      raise ValueError('text_paddings are required with text_token_ids')
    text_embeddings = encode_text(params, text_token_ids, text_paddings, cfg,
                                  normalize=normalize, impl=impl)
  return video_embeddings, text_embeddings, outputs

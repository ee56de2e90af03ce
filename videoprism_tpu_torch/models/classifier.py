"""Video classifier: factorized encoder backbone + attention pooling + head
(port of ``videoprism_tpu.models.classifier``).

    video [B, T, H, W, 3] -> factorized encoder (K1/K8a, K2/K8b, K3, K4)
      -> one-query attention pooler (hidden = model_dim, the encoder's heads,
         per-dim scale, output LN: K6 on the card)   [B, D]
      -> projection dense                            [B, num_classes]

The pooler follows the Flax ground truth (layer norm and per-dim scale on),
as the JAX package does.  ``impl`` ('auto' | 'kernel' | 'reference')
reaches every kernel wrapper, as in ``factorized_encoder``.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Collection
from typing import Any

import torch

from videoprism_tpu_torch.models import factorized_encoder as fe
from videoprism_tpu_torch.ops import basic
from videoprism_tpu_torch.ops.transformer import atten_token_pooling

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class VideoClassifierConfig:
  encoder: fe.FactorizedEncoderConfig = fe.FactorizedEncoderConfig()
  num_classes: int = 0

  @property
  def dtype(self) -> torch.dtype:
    return self.encoder.dtype


def apply(params: Params, inputs: torch.Tensor, cfg: VideoClassifierConfig,
          *, return_intermediate: bool | Collection[str] = False,
          frame_paddings: torch.Tensor | None = None,
          impl: str = 'auto') -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
  """Video [B, T, H, W, 3] -> (logits [B, num_classes], intermediates).

  Param tree: ``{'encoder': ..., 'atten_pooler': ..., 'projection': ...}``.
  ``return_intermediate`` adds the encoder's, and ``spatiotemporal_features``
  [B, T*N, D] and ``global_embeddings`` [B, D].
  """
  dtype = cfg.dtype
  features, outputs = fe.apply(
      params['encoder'], inputs, cfg.encoder,
      return_intermediate=return_intermediate,
      frame_paddings=frame_paddings, impl=impl)
  if fe.contains(return_intermediate, 'spatiotemporal_features'):
    outputs['spatiotemporal_features'] = features
  embeddings = atten_token_pooling(
      params['atten_pooler'], features, None,
      num_heads=cfg.encoder.num_heads, hidden_dim=cfg.encoder.model_dim,
      dtype=dtype, impl=impl).squeeze(-2)
  if fe.contains(return_intermediate, 'global_embeddings'):
    outputs['global_embeddings'] = embeddings
  logits = basic.feed_forward(params['projection'], embeddings,
                              activation='identity', dtype=dtype)
  return logits, outputs

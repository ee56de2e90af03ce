"""CoCa-style causal text encoder (port of
``videoprism_tpu.models.text_encoder``).

Token ids [B, L] -> sqrt(D)-scaled token embedding + sinusoidal pos-emb,
learned class tokens appended (also sqrt(D)-scaled), a causal relu
transformer stack, and a final LayerNorm.  On the card the stack runs K1
and K2 per layer and the final LN runs K6.  The JAX package pads the
65-token sequence (64 + the class token) to 72 for the TPU's sublane tiling
when it runs its kernels; K1 and K2 take any length, so the port runs it
unpadded (padded tokens never reach a real token's output either way).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from videoprism_tpu_torch.ops import basic
from videoprism_tpu_torch.ops import embeddings as emb_lib
from videoprism_tpu_torch.ops.transformer import (
    TransformerLayerConfig,
    stacked_transformer,
)

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class TextEncoderConfig:
  vocabulary_size: int = 128
  num_class_tokens: int = 0
  enable_causal_atten: bool = True
  model_dim: int = 768
  num_layers: int = 12
  mlp_dim: int = 3072
  num_heads: int = 12
  atten_logit_cap: float = 0.0
  norm_policy: str = 'pre'
  scan: bool = True
  dtype: torch.dtype = torch.float32

  def layer_config(self) -> TransformerLayerConfig:
    """Causal relu stack."""
    return TransformerLayerConfig(
        num_layers=self.num_layers,
        hidden_dim=self.mlp_dim,
        num_heads=self.num_heads,
        norm_policy=self.norm_policy,
        activation='relu',
        enable_per_dim_scale=False,
        logit_cap=self.atten_logit_cap,
        enable_causal_atten=self.enable_causal_atten,
        scan=self.scan,
        dtype=self.dtype,
    )


def apply(params: Params, inputs: torch.Tensor, paddings: torch.Tensor,
          cfg: TextEncoderConfig, *, impl: str = 'auto') -> torch.Tensor:
  """Token ids [B, L] + paddings [B, L] -> features [B, L(+cls), D]."""
  dtype = cfg.dtype
  batch_size, seq_length = inputs.shape
  pos_emb = emb_lib.sinusoidal_positional_embedding(
      seq_length, cfg.model_dim, dtype=dtype, device=inputs.device)
  features = emb_lib.token_embedding(
      params['token_emb'], inputs, scale_sqrt_depth=True,
      dtype=dtype) + pos_emb
  if cfg.num_class_tokens > 0:
    cls_emb = basic.cast_floating(params['cls_emb'], dtype)
    cls_emb = cls_emb.expand(batch_size, -1, -1) * cfg.model_dim ** 0.5
    features = torch.cat([features, cls_emb], dim=-2)
    paddings = torch.cat([paddings, paddings.new_zeros(
        (batch_size, cfg.num_class_tokens))], dim=-1)
  features = stacked_transformer(params['unimodal_transformer'], features,
                                 paddings, cfg.layer_config(), impl=impl)
  return basic.layer_norm(params['unimodal_ln'], features, dtype=dtype,
                          impl=impl)

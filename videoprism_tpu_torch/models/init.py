"""Random parameter trees for the factorized encoder, the video-text CLIP
model and the video classifier (port of ``videoprism_tpu.models.init``).

Each tree has the nesting, leaf names and shapes of the JAX package's
``init_factorized_encoder`` / ``init_video_clip`` /
``init_video_classifier`` (and so of the public
"repeated" checkpoints), including the stacked leading layer axis.  Values
come from ``numpy.random.default_rng(seed)``: truncated-normal LeCun
kernels as in flax, normal(1/sqrt(D)) token and class embeddings, zero
biases and LN parameters unless ``norm_bias_std`` asks for non-zero ones
(tests use that so a dropped bias or LN term shows).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from videoprism_tpu_torch.io.checkpoints import params_from_numpy
from videoprism_tpu_torch.models import classifier as classifier_lib
from videoprism_tpu_torch.models import clip as clip_lib
from videoprism_tpu_torch.models import factorized_encoder as fe
from videoprism_tpu_torch.models import text_encoder as te
from videoprism_tpu_torch.ops.transformer import TransformerLayerConfig

Params = dict[str, Any]


class _Init:
  """Draws every leaf from one generator, in tree order."""

  def __init__(self, seed: int | tuple[int, ...], norm_bias_std: float):
    self.rng = np.random.default_rng(seed)
    self.std = norm_bias_std

  def lecun(self, shape: tuple[int, ...]) -> np.ndarray:
    """flax lecun_normal: truncated normal in [-2, 2], fan-in variance."""
    fan_in = shape[-2] * int(np.prod(shape[:-2]))
    x = self.rng.standard_normal(shape, dtype=np.float32)
    bad = np.abs(x) > 2.0
    while bad.any():
      x[bad] = self.rng.standard_normal(int(bad.sum()), dtype=np.float32)
      bad = np.abs(x) > 2.0
    return x * np.float32(np.sqrt(1.0 / fan_in) / 0.87962566103423978)

  def small(self, shape: tuple[int, ...]) -> np.ndarray:
    """A bias or LN parameter: zeros, or normal(0, std) when std > 0."""
    if self.std > 0.0:
      return (self.std * self.rng.standard_normal(shape)).astype(np.float32)
    return np.zeros(shape, np.float32)

  def embedding(self, shape: tuple[int, ...]) -> np.ndarray:
    """normal(0, 1/sqrt(D)), the token and class embeddings' init."""
    return (self.rng.standard_normal(shape, dtype=np.float32)
            * np.float32(shape[-1] ** -0.5))

  def dense(self, d_in: int, d_out: int) -> Params:
    return {'linear': {'kernel': self.lecun((d_in, d_out)),
                       'bias': self.small((d_out,))}}

  def layer_norm(self, d: int) -> Params:
    return {'scale': self.small((d,)), 'bias': self.small((d,))}

  def attention(self, d: int, n: int, h: int, per_dim_scale: bool) -> Params:
    proj = lambda: {'w': self.lecun((d, n, h)), 'b': self.small((n, h))}
    attn = {'query': proj(), 'key': proj(), 'value': proj(),
            'post': {'w': self.lecun((d, n, h)), 'b': self.small((d,))}}
    if per_dim_scale:
      attn['per_dim_scale'] = {'per_dim_scale': self.small((h,))}
    return attn

  def layer(self, d: int, cfg: TransformerLayerConfig) -> Params:
    if cfg.norm_policy != 'pre':
      raise NotImplementedError(
          f'norm_policy={cfg.norm_policy!r} is not ported yet; see ROADMAP.md')
    n = cfg.num_heads
    attn = self.attention(d, n, d // n, cfg.enable_per_dim_scale)
    return {
        'layer_norm': self.layer_norm(d),
        'self_attention': attn,
        'ff_layer': {'layer_norm': self.layer_norm(d),
                     'ffn_layer1': self.dense(d, cfg.hidden_dim),
                     'ffn_layer2': self.dense(cfg.hidden_dim, d)},
    }

  def stacked_transformer(self, d: int,
                          cfg: TransformerLayerConfig) -> Params:
    layers = [self.layer(d, cfg) for _ in range(cfg.num_layers)]
    if cfg.scan:
      return {'x_layers': _stack(layers)}
    return {f'x_layers_{i}': layer for i, layer in enumerate(layers)}

  def vision_transformer(self, d: int, cfg: TransformerLayerConfig) -> Params:
    return {'transformers_stack': self.stacked_transformer(d, cfg)}

  def atten_pooling(self, d: int, hidden_dim: int, num_heads: int) -> Params:
    """One learned query, per-dim scale, output LN."""
    return {
        'pooling_attention_query': self.lecun((1, d)),
        'pooling_attention': self.attention(d, num_heads,
                                            hidden_dim // num_heads, True),
        'pooling_attention_layer_norm': self.layer_norm(d),
    }

  def factorized_encoder(self, cfg: fe.FactorizedEncoderConfig) -> Params:
    d = cfg.model_dim
    t, gh, gw = cfg.pos_emb_shape
    return {
        'patch_projection': self.dense(cfg.patch_size ** 2 * 3, d),
        'spatial_pos_emb': {'emb_var': self.lecun((gh * gw, d))},
        'spatial_encoder': self.vision_transformer(
            d, cfg.vit_layer_config(cfg.num_spatial_layers)),
        'spatial_ln': self.layer_norm(d),
        'temporal_pos_emb': {'emb_var': self.lecun((t, d))},
        'temporal_encoder': self.vision_transformer(
            d, cfg.vit_layer_config(cfg.num_temporal_layers)),
        'temporal_ln': self.layer_norm(d),
    }

  def text_encoder(self, cfg: te.TextEncoderConfig) -> Params:
    d = cfg.model_dim
    params = {
        'token_emb': {'emb_var': self.embedding((cfg.vocabulary_size, d))},
        'unimodal_transformer': self.stacked_transformer(
            d, cfg.layer_config()),
        'unimodal_ln': self.layer_norm(d),
    }
    if cfg.num_class_tokens > 0:
      params['cls_emb'] = self.embedding((1, cfg.num_class_tokens, d))
    return params


def _stack(trees: list[Params]) -> Params:
  if isinstance(trees[0], dict):
    return {k: _stack([t[k] for t in trees]) for k in trees[0]}
  return np.stack(trees)


def numpy_factorized_encoder(seed: int, cfg: fe.FactorizedEncoderConfig, *,
                             norm_bias_std: float = 0.0) -> Params:
  """The encoder's param tree as float32 numpy arrays."""
  return _Init(seed, norm_bias_std).factorized_encoder(cfg)


def numpy_video_clip(seed: int, cfg: clip_lib.VideoCLIPConfig, *,
                     norm_bias_std: float = 0.0) -> Params:
  """The CLIP model's param tree as float32 numpy arrays: the keys and
  shapes of the JAX package's ``init_video_clip``."""
  init = _Init(seed, norm_bias_std)
  d = cfg.model_dim
  params = {
      'vision_encoder': init.factorized_encoder(cfg.vision_config()),
      'contrastive_vision_pooler': init.atten_pooling(d, 4 * d,
                                                      cfg.num_heads),
      'text_encoder': init.text_encoder(cfg.text_config()),
  }
  if cfg.num_auxiliary_layers > 0:
    params['auxiliary_encoder'] = init.vision_transformer(
        d, cfg.vision_config().vit_layer_config(cfg.num_auxiliary_layers))
  return params


def numpy_classifier_head(seed: int,
                          cfg: classifier_lib.VideoClassifierConfig, *,
                          norm_bias_std: float = 0.0) -> Params:
  """The classifier's pooler and projection (its tree without
  ``encoder``) as float32 numpy arrays, drawn from a stream of their own so
  that they do not depend on the encoder's size."""
  init = _Init((seed, 1), norm_bias_std)
  d = cfg.encoder.model_dim
  return {'atten_pooler': init.atten_pooling(d, d, cfg.encoder.num_heads),
          'projection': init.dense(d, cfg.num_classes)}


def numpy_video_classifier(seed: int,
                           cfg: classifier_lib.VideoClassifierConfig, *,
                           norm_bias_std: float = 0.0) -> Params:
  """The classifier's param tree as float32 numpy arrays: the keys and
  shapes of the JAX package's ``init_video_classifier``."""
  return {
      'encoder': numpy_factorized_encoder(seed, cfg.encoder,
                                          norm_bias_std=norm_bias_std),
      **numpy_classifier_head(seed, cfg, norm_bias_std=norm_bias_std),
  }


def init_factorized_encoder(seed: int, cfg: fe.FactorizedEncoderConfig, *,
                            device: torch.device | str = 'cuda',
                            dtype: torch.dtype = torch.float32,
                            norm_bias_std: float = 0.0) -> Params:
  """Param tree for ``factorized_encoder.apply``, as tensors on ``device``."""
  return params_from_numpy(
      numpy_factorized_encoder(seed, cfg, norm_bias_std=norm_bias_std),
      device=device, dtype=dtype)


def init_video_clip(seed: int, cfg: clip_lib.VideoCLIPConfig, *,
                    device: torch.device | str = 'cuda',
                    dtype: torch.dtype = torch.float32,
                    norm_bias_std: float = 0.0) -> Params:
  """Param tree for ``clip.apply``, as tensors on ``device``."""
  return params_from_numpy(
      numpy_video_clip(seed, cfg, norm_bias_std=norm_bias_std),
      device=device, dtype=dtype)


def init_video_classifier(seed: int,
                          cfg: classifier_lib.VideoClassifierConfig, *,
                          device: torch.device | str = 'cuda',
                          dtype: torch.dtype = torch.float32,
                          norm_bias_std: float = 0.0) -> Params:
  """Param tree for ``classifier.apply``, as tensors on ``device``."""
  return params_from_numpy(
      numpy_video_classifier(seed, cfg, norm_bias_std=norm_bias_std),
      device=device, dtype=dtype)

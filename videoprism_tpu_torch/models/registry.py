"""Model registry and loaders for the video encoders and the video-text
CLIP models (port of ``videoprism_tpu.models.registry``).

``get_model(name)`` returns a :class:`Model` whose ``apply(variables, ...)``
takes the JAX package's calling convention, with a bare param tree or a
``{'params': tree}`` wrapper:

* an encoder: ``apply(variables, video)`` with a ``[B, T, H, W, 3]`` clip
  -> ``(embeddings [B, T*N, D], intermediates)``;
* a CLIP model: ``apply(variables, inputs=None, text_token_ids=None,
  text_paddings=None, **kw)`` -> ``(video [B, D] | None, text [B, D] |
  None, intermediates)``.

The classifier models are not ported yet.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Callable, Mapping
from typing import Any

import torch

from videoprism_tpu_torch.io import checkpoints as ckpt_lib
from videoprism_tpu_torch.models import clip as clip_lib
from videoprism_tpu_torch.models import factorized_encoder as fe
from videoprism_tpu_torch.models import init as init_lib

# Vocabulary of the c4_en SentencePiece model the CLIP text towers use.
TEXT_VOCAB_SIZE = 32_000

# HuggingFace checkpoints: (repository, filename).
CHECKPOINTS = {
    'videoprism_public_v1_base': (
        'google/videoprism-base-f16r288', 'flax_base_f16r288_repeated.npz'),
    'videoprism_public_v1_large': (
        'google/videoprism-large-f8r288', 'flax_large_f8r288_repeated.npz'),
    'videoprism_lvt_public_v1_base': (
        'google/videoprism-lvt-base-f16r288',
        'flax_lvt_base_f16r288_repeated.npz'),
    'videoprism_lvt_public_v1_large': (
        'google/videoprism-lvt-large-f8r288',
        'flax_lvt_large_f8r288_repeated.npz'),
}

# Architecture hyperparameters, identical to the JAX package's CONFIGS.
CONFIGS = {
    'videoprism_v1_base': dict(
        patch_size=18,
        pos_emb_shape=(16, 16, 16),
        model_dim=768,
        num_spatial_layers=12,
        num_temporal_layers=4,
        num_heads=12,
        mlp_dim=3072,
        atten_logit_cap=50.0,
        scan=True,
    ),
    'videoprism_v1_large': dict(
        patch_size=18,
        pos_emb_shape=(8, 16, 16),
        model_dim=1024,
        num_spatial_layers=24,
        num_temporal_layers=4,
        num_heads=16,
        mlp_dim=4096,
        atten_logit_cap=50.0,
        scan=True,
    ),
    'videoprism_lvt_v1_base': dict(
        patch_size=18,
        pos_emb_shape=(16, 16, 16),
        num_spatial_layers=12,
        num_temporal_layers=4,
        mlp_dim=3072,
        num_auxiliary_layers=2,
        enable_causal_atten=True,
        num_unimodal_layers=12,
        norm_policy='pre',
        model_dim=768,
        num_heads=12,
        atten_logit_cap=50.0,
        scan=True,
    ),
    'videoprism_lvt_v1_large': dict(
        patch_size=18,
        pos_emb_shape=(8, 16, 16),
        num_spatial_layers=24,
        num_temporal_layers=4,
        mlp_dim=4096,
        num_auxiliary_layers=2,
        enable_causal_atten=True,
        num_unimodal_layers=12,
        norm_policy='pre',
        model_dim=1024,
        num_heads=16,
        atten_logit_cap=50.0,
        scan=True,
    ),
}

_NOT_PORTED = (
    'the classifier models are not ported to PyTorch yet; see ROADMAP.md, '
    'queue 1 item 8')


@dataclasses.dataclass
class Model:
  """Static config + apply/init of an encoder or a CLIP model (by the type
  of ``config``)."""

  config: fe.FactorizedEncoderConfig | clip_lib.VideoCLIPConfig
  name: str | None = None

  @staticmethod
  def _unwrap(variables):
    if isinstance(variables, Mapping) and set(variables.keys()) == {'params'}:
      return variables['params']
    return variables

  @property
  def is_clip(self) -> bool:
    return isinstance(self.config, clip_lib.VideoCLIPConfig)

  def apply(self, variables, *args, **kwargs):
    """``clip.apply`` (inputs, text_token_ids, text_paddings, normalize,
    return_intermediate, frame_paddings, impl) or ``fe.apply`` (inputs,
    return_intermediate, frame_paddings, impl)."""
    fn = clip_lib.apply if self.is_clip else fe.apply
    return fn(self._unwrap(variables), *args, cfg=self.config, **kwargs)

  def init(self, seed: int, *, device: torch.device | str = 'cuda',
           norm_bias_std: float = 0.0) -> dict[str, Any]:
    """Seeded random params as tensors on ``device`` (the card unless
    asked otherwise; raises without one)."""
    fn = (init_lib.init_video_clip if self.is_clip
          else init_lib.init_factorized_encoder)
    return {'params': fn(seed, self.config, device=device,
                         dtype=self.config.dtype,
                         norm_bias_std=norm_bias_std)}

  def replace_config(self, **updates) -> 'Model':
    return dataclasses.replace(
        self, config=dataclasses.replace(self.config, **updates))


def _encoder_model(config_name: str) -> Model:
  return Model(fe.FactorizedEncoderConfig(**CONFIGS[config_name]),
               name=config_name)


def videoprism_v1_base() -> Model:
  return _encoder_model('videoprism_v1_base')


def videoprism_v1_large() -> Model:
  return _encoder_model('videoprism_v1_large')


def _clip_model(config_name: str) -> Model:
  return Model(clip_lib.VideoCLIPConfig(**CONFIGS[config_name],
                                        vocabulary_size=TEXT_VOCAB_SIZE),
               name=config_name)


def videoprism_lvt_v1_base() -> Model:
  return _clip_model('videoprism_lvt_v1_base')


def videoprism_lvt_v1_large() -> Model:
  return _clip_model('videoprism_lvt_v1_large')


MODELS: dict[str, Callable[[], Model]] = {
    'videoprism_public_v1_base': videoprism_v1_base,
    'videoprism_public_v1_large': videoprism_v1_large,
    'videoprism_lvt_public_v1_base': videoprism_lvt_v1_base,
    'videoprism_lvt_public_v1_large': videoprism_lvt_v1_large,
}


def _resolve_name(model_name: str) -> str | None:
  if not model_name.startswith('google/'):
    return model_name
  for name, (repo, _) in CHECKPOINTS.items():
    if repo == model_name:
      return name
  return None


def has_model(model_name: str) -> bool:
  """Whether a model (registry name or HF id) is available in the port."""
  name = _resolve_name(model_name)
  return name is not None and name in MODELS


def get_model(model_name: str,
              fprop_dtype: torch.dtype | None = None) -> Model:
  """The :class:`Model` by registry name or HF id.

  ``fprop_dtype`` (e.g. ``torch.bfloat16``, the served dtype) sets the
  activation dtype.
  """
  name = _resolve_name(model_name)
  if name is None or name not in MODELS:
    if model_name.startswith('videoprism_vc'):
      raise NotImplementedError(f'{model_name}: {_NOT_PORTED}')
    raise ValueError(f'Model `{model_name}` not found.')
  model = MODELS[name]()
  if fprop_dtype is not None:
    model = model.replace_config(dtype=fprop_dtype)
  return model


def load_pretrained_weights(model_name: str | None,
                            checkpoint_path: str | None = None, *,
                            device: torch.device | str = 'cuda',
                            dtype: torch.dtype = torch.float32) -> dict:
  """Weights from a local npz checkpoint, as tensors on ``device`` (the
  card unless asked otherwise; raises without one).

  Loading by name would download from HuggingFace, which needs the network:
  download the file and pass ``checkpoint_path``.
  """
  if checkpoint_path is None:
    raise ValueError(
        f'loading {model_name!r} by name needs a download from HuggingFace '
        f'({CHECKPOINTS.get(model_name, "unknown repository")}); fetch the '
        'npz and pass checkpoint_path=')
  return ckpt_lib.params_from_numpy(ckpt_lib.load_checkpoint(checkpoint_path),
                                    device=device, dtype=dtype)

"""Model registry and loaders for the video encoders, the video-text CLIP
models and the video classifiers (port of
``videoprism_tpu.models.registry``).

``get_model(name)`` returns a :class:`Model` whose ``apply(variables, ...)``
takes the JAX package's calling convention, with a bare param tree or a
``{'params': tree}`` wrapper:

* an encoder: ``apply(variables, video)`` with a ``[B, T, H, W, 3]`` clip
  -> ``(embeddings [B, T*N, D], intermediates)``;
* a CLIP model: ``apply(variables, inputs=None, text_token_ids=None,
  text_paddings=None, **kw)`` -> ``(video [B, D] | None, text [B, D] |
  None, intermediates)``;
* a classifier (``videoprism_vc_v1_*(num_classes)``, or
  :func:`load_classifier`): ``apply(variables, video)`` -> ``(logits
  [B, num_classes], intermediates)``.  As in the JAX package, classifiers
  are built by their functions and are not in ``MODELS``.
"""

from __future__ import annotations

import dataclasses
import warnings
from collections.abc import Callable, Mapping
from pathlib import Path
from typing import Any

import torch

from videoprism_tpu_torch import quantization
from videoprism_tpu_torch.io import checkpoints as ckpt_lib
from videoprism_tpu_torch.models import classifier as classifier_lib
from videoprism_tpu_torch.models import clip as clip_lib
from videoprism_tpu_torch.models import factorized_encoder as fe
from videoprism_tpu_torch.models import init as init_lib

# Vocabulary of the c4_en SentencePiece model the CLIP text towers use.
TEXT_VOCAB_SIZE = 32_000
K400_NUM_CLASSES = 400

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
    'videoprism_v1_giant': dict(
        patch_size=18,
        pos_emb_shape=(8, 16, 16),
        model_dim=1408,
        num_spatial_layers=40,
        num_temporal_layers=4,
        num_heads=16,
        mlp_dim=6144,
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

@dataclasses.dataclass
class Model:
  """Static config + apply/init of an encoder, a CLIP model or a
  classifier (by the type of ``config``)."""

  config: (fe.FactorizedEncoderConfig | clip_lib.VideoCLIPConfig
           | classifier_lib.VideoClassifierConfig)
  name: str | None = None

  @staticmethod
  def _unwrap(variables):
    if isinstance(variables, Mapping) and set(variables.keys()) == {'params'}:
      return variables['params']
    return variables

  @property
  def is_clip(self) -> bool:
    return isinstance(self.config, clip_lib.VideoCLIPConfig)

  @property
  def is_classifier(self) -> bool:
    return isinstance(self.config, classifier_lib.VideoClassifierConfig)

  def apply(self, variables, *args, **kwargs):
    """``clip.apply`` (inputs, text_token_ids, text_paddings, normalize,
    return_intermediate, frame_paddings, impl), ``classifier.apply`` or
    ``fe.apply`` (inputs, return_intermediate, frame_paddings, impl)."""
    fn = (clip_lib.apply if self.is_clip else
          classifier_lib.apply if self.is_classifier else fe.apply)
    return fn(self._unwrap(variables), *args, cfg=self.config, **kwargs)

  def init(self, seed: int, *, device: torch.device | str = 'cuda',
           norm_bias_std: float = 0.0) -> dict[str, Any]:
    """Seeded random params as tensors on ``device`` (the card unless
    asked otherwise; raises without one)."""
    fn = (init_lib.init_video_clip if self.is_clip else
          init_lib.init_video_classifier if self.is_classifier else
          init_lib.init_factorized_encoder)
    return {'params': fn(seed, self.config, device=device,
                         dtype=self.config.dtype,
                         norm_bias_std=norm_bias_std)}

  def replace_config(self, **updates) -> 'Model':
    return dataclasses.replace(
        self, config=dataclasses.replace(self.config, **updates))


@dataclasses.dataclass
class BoundModel:
  """A model with its weights attached, callable as ``model(video)``."""

  model: Model
  params: Any

  def __call__(self, *args, **kwargs):
    return self.model.apply(self.params, *args, **kwargs)

  @property
  def config(self):
    return self.model.config


def _encoder_model(config_name: str) -> Model:
  return Model(fe.FactorizedEncoderConfig(**CONFIGS[config_name]),
               name=config_name)


def videoprism_v1_base() -> Model:
  return _encoder_model('videoprism_v1_base')


def videoprism_v1_large() -> Model:
  return _encoder_model('videoprism_v1_large')


def videoprism_v1_giant() -> Model:
  return _encoder_model('videoprism_v1_giant')


def _clip_model(config_name: str) -> Model:
  return Model(clip_lib.VideoCLIPConfig(**CONFIGS[config_name],
                                        vocabulary_size=TEXT_VOCAB_SIZE),
               name=config_name)


def videoprism_lvt_v1_base() -> Model:
  return _clip_model('videoprism_lvt_v1_base')


def videoprism_lvt_v1_large() -> Model:
  return _clip_model('videoprism_lvt_v1_large')


def _classifier_model(config_name: str, num_classes: int,
                      **overrides) -> Model:
  """``overrides`` (e.g. ``dtype``) replace fields of the encoder config."""
  return Model(classifier_lib.VideoClassifierConfig(
      encoder=fe.FactorizedEncoderConfig(**{**CONFIGS[config_name],
                                            **overrides}),
      num_classes=num_classes), name=config_name)


def videoprism_vc_v1_base(num_classes: int, **overrides) -> Model:
  return _classifier_model('videoprism_v1_base', num_classes, **overrides)


def videoprism_vc_v1_large(num_classes: int, **overrides) -> Model:
  return _classifier_model('videoprism_v1_large', num_classes, **overrides)


def videoprism_vc_v1_giant(num_classes: int, **overrides) -> Model:
  return _classifier_model('videoprism_v1_giant', num_classes, **overrides)


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


def _resolve_weights(model_name: str, weights_path: str | None) -> dict:
  """The checkpoint as a numpy tree: ``weights_path`` if given, else the
  first of the local ``weights/`` files the JAX package looks for.

  There is no download (it needs the network): a missing file raises
  naming the paths tried.  safetensors files and the reference's MLX
  converter's ``*_mlx`` files are not ported yet (ROADMAP.md, queue 1
  item 1) and raise ``ValueError``.
  """

  def load(path: str) -> dict:
    name = Path(path).name
    if '_mlx' in name or name.endswith('.safetensors'):
      raise ValueError(
          f'{path}: safetensors and *_mlx checkpoints are not ported yet '
          '(ROADMAP.md, queue 1 item 1); pass an npz checkpoint')
    return ckpt_lib.load_checkpoint(path)

  if weights_path is not None:
    return load(weights_path)
  candidates = [Path('weights') / f'{model_name}{suffix}' for suffix in (
      '.safetensors', '.npz', '_mlx.safetensors', '_mlx.npz')]
  for candidate in candidates:
    if candidate.exists():
      return load(str(candidate))
  raise FileNotFoundError(
      f'no weights for {model_name!r}: tried '
      f'{", ".join(str(c) for c in candidates)}; downloading from '
      f'HuggingFace ({CHECKPOINTS.get(model_name, "unknown repository")}) '
      'needs the network: fetch the npz and pass weights_path=')


def _maybe_quantize(params: dict, quantize: str | None) -> dict:
  if quantize is None:
    return params
  if quantize != 'int8':
    raise ValueError(f'unknown quantize mode {quantize!r}')
  return quantization.quantize_for_serving(params)


def _quantize_attention_impl(attention_impl: str | None,
                             quantize: str | None) -> str | None:
  """int8 runs through its kernels only on the 'flash' path: default to
  it when quantizing, and warn if 'xla' was asked for."""
  if quantize != 'int8':
    return attention_impl
  if attention_impl is None:
    return 'flash'
  if attention_impl == 'xla':
    warnings.warn(
        "quantize='int8' with attention_impl='xla' dequantizes the weights "
        '(int8 buys nothing then); use '
        "attention_impl='flash' to engage the int8 kernels.",
        stacklevel=3)
  return attention_impl


def _bind(model: Model, model_name: str, weights_path: str | None,
          attention_impl: str | None, quantize: str | None,
          device: torch.device | str) -> BoundModel:
  """The weights loaded, quantized, on ``device`` in the model's dtype
  (int8 weights and their fp32 scales kept) and laid out for the kernels.

  The port has one float route, so ``attention_impl`` tells only an int8
  tree's: None or 'flash' takes the int8 kernels; 'xla' dequantizes the
  weights, as the reference's int8 route needs 'flash'.
  """
  if attention_impl not in (None, 'flash', 'xla'):
    raise ValueError(
        f"attention_impl must be None, 'flash' or 'xla', got "
        f'{attention_impl!r}')
  tree = _maybe_quantize(_resolve_weights(model_name, weights_path), quantize)
  params = ckpt_lib.params_from_numpy(tree, device=device,
                                      dtype=model.config.dtype)
  if attention_impl == 'xla':
    params = quantization.dequantize(params, model.config.dtype)
  return BoundModel(model, ckpt_lib.prepare_for_kernels(params))


def load_model(model_name: str, weights_path: str | None = None, *,
               fprop_dtype: torch.dtype | None = None,
               attention_impl: str | None = None,
               quantize: str | None = None,
               device: torch.device | str = 'cuda') -> BoundModel:
  """A pretrained video-text (lvt) CLIP model with its weights bound, on
  ``device`` (the card unless asked otherwise; raises without one).

  The JAX package's signature and refusals: ``fprop_dtype`` sets the
  activation dtype, ``quantize='int8'`` converts the transformer matmul
  weights for the W8A8 kernels (``quantization``), ``attention_impl`` as
  in :func:`_bind`.  The weights come from ``weights_path`` or the local
  ``weights/`` directory (npz only).
  """
  if 'lvt' not in model_name:
    raise ValueError(
        f'`{model_name}` is not a video-text (lvt) model; use '
        'load_video_encoder() for vision-only backbones.')
  attention_impl = _quantize_attention_impl(attention_impl, quantize)
  model = get_model(model_name, fprop_dtype=fprop_dtype)
  return _bind(model, model_name, weights_path, attention_impl, quantize,
               device)


def load_video_encoder(model_name: str, weights_path: str | None = None, *,
                       fprop_dtype: torch.dtype | None = None,
                       attention_impl: str | None = None,
                       quantize: str | None = None,
                       device: torch.device | str = 'cuda') -> BoundModel:
  """A pretrained vision-only backbone with its weights bound; see
  :func:`load_model`."""
  if 'lvt' in model_name:
    raise ValueError(
        f'`{model_name}` is a video-text model; use load_model() instead.')
  attention_impl = _quantize_attention_impl(attention_impl, quantize)
  model = get_model(model_name, fprop_dtype=fprop_dtype)
  return _bind(model, model_name, weights_path, attention_impl, quantize,
               device)


def _flat_keys(tree, prefix: str = '') -> set[str]:
  keys = set()
  for k, v in tree.items():
    if isinstance(v, Mapping):
      keys |= _flat_keys(v, f'{prefix}{k}/')
    else:
      keys.add(prefix + k)
  return keys


def load_classifier(model_name: str, num_classes: int,
                    checkpoint_path: str | None = None, *, seed: int = 0,
                    device: torch.device | str = 'cuda',
                    dtype: torch.dtype = torch.float32) -> BoundModel:
  """A classifier whose encoder comes from a pretrained checkpoint (a local
  npz) and whose pooler and ``num_classes``-way projection are freshly
  drawn from ``seed``; tensors on ``device`` (the card unless asked
  otherwise).

  The backbone is the checkpoint's ``vision_encoder`` subtree for lvt
  names and the whole tree otherwise; the encoder config is the large or
  giant one when the name says so, else base.  A missing subtree raises
  ``KeyError`` and a tree whose keys differ from the encoder's raises
  ``ValueError``: it never proceeds on random weights.  ``dtype`` sets the
  params' and the activations' dtype.
  """
  config_name = ('videoprism_v1_large' if 'large' in model_name else
                 'videoprism_v1_giant' if 'giant' in model_name else
                 'videoprism_v1_base')
  model = _classifier_model(config_name, num_classes, dtype=dtype)
  if checkpoint_path is None:
    raise ValueError(
        f'loading {model_name!r} by name needs a download from HuggingFace '
        f'({CHECKPOINTS.get(model_name, "unknown repository")}); fetch the '
        'npz and pass checkpoint_path=')
  pretrained = Model._unwrap(ckpt_lib.load_checkpoint(checkpoint_path))
  backbone = pretrained
  if model_name.startswith('videoprism_lvt'):
    if 'vision_encoder' not in pretrained:
      raise KeyError(
          f'Checkpoint for {model_name} has no `vision_encoder` subtree; '
          f'top-level keys: {sorted(pretrained)}')
    backbone = pretrained['vision_encoder']
  # The encoder's keys depend on its layer layout, not on its widths: a
  # narrow copy of the config gives them without drawing the full tree.
  narrow = dataclasses.replace(model.config.encoder, model_dim=8, num_heads=1,
                               mlp_dim=8, patch_size=1)
  expected = _flat_keys(init_lib.numpy_factorized_encoder(0, narrow))
  got = _flat_keys(backbone)
  if got != expected:
    raise ValueError(
        'Backbone checkpoint structure does not match the classifier '
        f'encoder: missing {sorted(expected - got)}, unexpected '
        f'{sorted(got - expected)}')
  tree = {'encoder': backbone,
          **init_lib.numpy_classifier_head(seed, model.config)}
  return BoundModel(model, ckpt_lib.params_from_numpy(tree, device=device,
                                                      dtype=dtype))

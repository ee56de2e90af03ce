"""The video classifier of videoprism_tpu_torch against the JAX package's
``classifier.apply``, its param tree, registry builders and
``load_classifier``, at a tiny size on the CPU.

The same numpy param tree (the port's seeded init, non-zero LN scales and
biases) drives both.  fp32 tolerance: atol 2e-5 (ROADMAP.md).  The JAX side
runs ``attention_impl='xla'``, the composed path; on the CPU the port's
kernel wrappers run their plain twins.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videoprism_tpu.io import checkpoints as jckpt
from videoprism_tpu.models import classifier as jvc
from videoprism_tpu.models import factorized_encoder as jfe
from videoprism_tpu.models import init as jinit
from videoprism_tpu.models import registry as jreg
import videoprism_tpu_torch as vpt
from videoprism_tpu_torch.io.checkpoints import (
    params_from_numpy,
    prepare_for_kernels,
)
from videoprism_tpu_torch.models import classifier as tvc
from videoprism_tpu_torch.models import factorized_encoder as tfe
from videoprism_tpu_torch.models import init as tinit
from videoprism_tpu_torch.models import registry as treg

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(_ROOT, 'scripts'))

import make_torch_classifier_golden as golden  # noqa: E402

ATOL = 2e-5
ENCODER = dict(patch_size=6, pos_emb_shape=(4, 4, 4), model_dim=128,
               num_spatial_layers=1, num_temporal_layers=1, num_heads=2,
               mlp_dim=256, atten_logit_cap=50.0)
NUM_CLASSES = 10


def _configs(**overrides):
  kw = {**ENCODER, **overrides}
  return (jvc.VideoClassifierConfig(jfe.FactorizedEncoderConfig(**kw),
                                    NUM_CLASSES),
          tvc.VideoClassifierConfig(tfe.FactorizedEncoderConfig(**kw),
                                    NUM_CLASSES))


def _flat(tree, prefix=''):
  out = {}
  for k, v in tree.items():
    if isinstance(v, dict):
      out.update(_flat(v, f'{prefix}{k}/'))
    else:
      out[prefix + k] = tuple(v.shape)
  return out


def _video(seed, b=2):
  return np.random.default_rng(seed).standard_normal(
      (b, 4, 24, 24, 3)).astype(np.float32)


def _apply_both(model_dim, fp=None):
  jcfg, tcfg = _configs(model_dim=model_dim)
  tree = tinit.numpy_video_classifier(0, tcfg, norm_bias_std=0.1)
  video = _video(1)
  keys = ('global_embeddings', 'spatiotemporal_features')
  want = jvc.apply(
      jax.tree.map(jnp.asarray, tree), jnp.asarray(video), jcfg,
      return_intermediate=keys,
      frame_paddings=None if fp is None else jnp.asarray(fp))
  got = tvc.apply(
      prepare_for_kernels(params_from_numpy(tree, device='cpu')),
      torch.from_numpy(video), tcfg, return_intermediate=keys,
      frame_paddings=None if fp is None else torch.from_numpy(fp))
  return got, want


@pytest.mark.parametrize('model_dim', [128, 64])
def test_apply_matches_jax(model_dim):
  """Logits, global embeddings and spatiotemporal features at atol 2e-5.
  At width 64 the reference's plan chains the FFN (the K8b twin)."""
  (got, touts), (want, jouts) = _apply_both(model_dim)
  assert tuple(got.shape) == (2, NUM_CLASSES)
  np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                             rtol=0)
  for key in ('global_embeddings', 'spatiotemporal_features'):
    np.testing.assert_allclose(touts[key].numpy(), np.asarray(jouts[key]),
                               atol=ATOL, rtol=0)


def test_frame_paddings_match_jax_on_real_tokens():
  """With a padded frame the features of the real tokens match.  The
  logits do not: the pooler takes every token, and the reference packs the
  fully padded frame's 16 tokens with other frames, so they attend over the
  pack rather than over themselves (ROADMAP.md §3, a deviation the port
  does not copy)."""
  fp = np.array([[0, 0, 0, 1], [0, 0, 0, 0]], np.float32)
  (_, touts), (_, jouts) = _apply_both(128, fp)
  real = np.repeat(fp == 0, 16, axis=1)          # [B, T*N]
  got = touts['spatiotemporal_features'].numpy()
  want = np.asarray(jouts['spatiotemporal_features'])
  np.testing.assert_allclose(got[real], want[real], atol=ATOL, rtol=0)
  assert np.abs(got[~real] - want[~real]).max() > 1e-3


def test_init_tree_matches_jax():
  """The large classifier's tree, key for key and shape for shape, against
  the JAX package's init_video_classifier."""
  jm = jreg.videoprism_vc_v1_large(jreg.K400_NUM_CLASSES)
  want = jax.eval_shape(
      lambda: jinit.init_video_classifier(jax.random.PRNGKey(0), jm.config))
  narrow = treg.videoprism_vc_v1_large(
      treg.K400_NUM_CLASSES, num_spatial_layers=1, num_temporal_layers=1)
  got = tinit.numpy_video_classifier(0, narrow.config)
  flat_want = _flat(want)
  for k in [k for k in flat_want if k.startswith('encoder/')
            and '/x_layers/' in k]:
    flat_want[k] = (1, *flat_want[k][1:])   # one layer per stack here
  assert _flat(got) == flat_want
  _, tcfg = _configs()
  a = tinit.numpy_video_classifier(3, tcfg, norm_bias_std=0.1)
  b = tinit.numpy_video_classifier(3, tcfg, norm_bias_std=0.1)
  for k, v in jckpt.tree_flatten_with_names(a):
    np.testing.assert_array_equal(v, dict(jckpt.tree_flatten_with_names(b))[k])


def test_builders_match_jax():
  for size in ('base', 'large', 'giant'):
    jm = getattr(jreg, f'videoprism_vc_v1_{size}')(400)
    tm = getattr(vpt, f'videoprism_vc_v1_{size}')(400)
    assert tm.is_classifier and not tm.is_clip
    assert tm.config.num_classes == jm.config.num_classes == 400
    for field in ('patch_size', 'pos_emb_shape', 'model_dim',
                  'num_spatial_layers', 'num_temporal_layers', 'num_heads',
                  'mlp_dim', 'atten_logit_cap', 'scan'):
      assert getattr(tm.config.encoder, field) == getattr(
          jm.config.encoder, field), (size, field)
  assert treg.CONFIGS['videoprism_v1_giant'] == \
      jreg.CONFIGS['videoprism_v1_giant']
  assert vpt.K400_NUM_CLASSES == jreg.K400_NUM_CLASSES == 400
  bf = vpt.videoprism_vc_v1_giant(400, dtype=torch.bfloat16)
  assert bf.config.dtype == torch.bfloat16 and bf.config.num_classes == 400
  assert bf.replace_config(num_classes=7).config.num_classes == 7


def test_model_init_and_apply():
  _, tcfg = _configs()
  model = treg.Model(tcfg)
  variables = model.init(0, device='cpu', norm_bias_std=0.1)
  assert set(variables['params']) == {'encoder', 'atten_pooler',
                                      'projection'}
  logits, _ = model.apply(variables, torch.from_numpy(_video(2)))
  assert tuple(logits.shape) == (2, NUM_CLASSES)
  assert bool(torch.isfinite(logits).all())


@pytest.fixture
def backbone_npz(tmp_path):
  """A tiny encoder checkpoint (its keys are those of every scan-stacked
  encoder) and an lvt-style one with it under vision_encoder."""
  _, tcfg = _configs()
  tree = tinit.numpy_factorized_encoder(5, tcfg.encoder, norm_bias_std=0.1)
  plain, lvt = str(tmp_path / 'enc.npz'), str(tmp_path / 'lvt.npz')
  jckpt.save_checkpoint(plain, tree)
  jckpt.save_checkpoint(lvt, {'vision_encoder': tree,
                              'text_encoder': {'w': np.zeros(3, np.float32)}})
  return tree, plain, lvt


def test_load_classifier(backbone_npz):
  """As the JAX package's: the backbone from the checkpoint (the
  vision_encoder subtree for lvt names), a fresh head of the named size,
  and loud failures instead of random weights."""
  tree, plain, lvt = backbone_npz
  for name, path in (('videoprism_public_v1_base', plain),
                     ('videoprism_lvt_public_v1_base', lvt)):
    bound = vpt.load_classifier(name, 7, checkpoint_path=path, seed=1,
                                device='cpu')
    assert isinstance(bound, treg.BoundModel) and bound.config.num_classes == 7
    assert bound.config.encoder.model_dim == 768
    np.testing.assert_array_equal(
        bound.params['encoder']['spatial_ln']['bias'].numpy(),
        tree['spatial_ln']['bias'])
    assert tuple(bound.params['projection']['linear']['kernel'].shape) == \
        (768, 7)
  large = vpt.load_classifier('videoprism_public_v1_large', 4,
                              checkpoint_path=plain, device='cpu',
                              dtype=torch.bfloat16)
  assert large.config.encoder.model_dim == 1024
  assert large.config.dtype == torch.bfloat16
  assert large.params['projection']['linear']['kernel'].dtype == \
      torch.bfloat16
  with pytest.raises(KeyError, match='vision_encoder'):
    vpt.load_classifier('videoprism_lvt_public_v1_base', 7,
                        checkpoint_path=plain, device='cpu')
  with pytest.raises(ValueError, match='structure'):
    vpt.load_classifier('videoprism_public_v1_base', 7, checkpoint_path=lvt,
                        device='cpu')
  with pytest.raises(ValueError, match='checkpoint_path'):
    vpt.load_classifier('videoprism_public_v1_base', 7)


def test_load_classifier_matches_jax_structure_rule(backbone_npz):
  """The JAX package accepts and refuses the same checkpoints."""
  _, plain, lvt = backbone_npz
  jax_bound = jreg.load_classifier('videoprism_public_v1_base', 7,
                                   weights_path=plain)
  assert jax_bound.config.num_classes == 7
  with pytest.raises(KeyError):
    jreg.load_classifier('videoprism_lvt_public_v1_base', 7,
                         weights_path=plain)
  with pytest.raises(ValueError):
    jreg.load_classifier('videoprism_public_v1_base', 7, weights_path=lvt)


def test_classifier_golden_fixture_regenerates_and_port_matches():
  """tests/data/torch_port_classifier_golden.npz (JAX fp32 logits of a
  tiny config) regenerates, and the port's fp32 twins match it."""
  stored = np.load(golden.OUT)
  assert json.loads(str(stored['config'])) == golden.ENCODER
  fresh = golden.make_golden()
  cfg = tvc.VideoClassifierConfig(
      tfe.FactorizedEncoderConfig(**golden.encoder_kwargs(golden.ENCODER)),
      int(stored['num_classes']))
  params = prepare_for_kernels(tinit.init_video_classifier(
      int(stored['param_seed']), cfg, device='cpu',
      norm_bias_std=float(stored['norm_bias_std'])))
  video = np.random.default_rng(int(stored['video_seed'])).standard_normal(
      tuple(stored['video_shape'])).astype(np.float32)
  logits, outs = tvc.apply(params, torch.from_numpy(video), cfg,
                           return_intermediate=('global_embeddings',))
  for key, got in (('logits', logits),
                   ('global_embeddings', outs['global_embeddings'])):
    np.testing.assert_allclose(fresh[key], stored[key], atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), stored[key], atol=ATOL, rtol=0)
  assert os.path.getsize(golden.OUT) < 20_000

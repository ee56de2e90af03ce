"""The video-text CLIP model of videoprism_tpu_torch against the JAX
package's ``clip.apply`` at a tiny size on the CPU.

The same numpy param tree (the port's seeded init, non-zero LN scales and
biases) drives both.  fp32 tolerance: atol 2e-5 for layers and the model,
1e-5 for ops (ROADMAP.md).  The JAX side runs ``attention_impl='xla'``, the
composed path; on the CPU the port's kernel wrappers run their plain twins
(K1, K2, K5 and K6 here), which is what is held against it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videoprism_tpu.models import clip as jclip
from videoprism_tpu.models import init as jinit
from videoprism_tpu.models import text_encoder as jte
from videoprism_tpu.ops import embeddings as jemb
from videoprism_tpu.ops import masks as jmasks
from videoprism_tpu.ops import transformer as jtr
from videoprism_tpu_torch.io.checkpoints import (
    params_from_numpy,
    prepare_for_kernels,
)
from videoprism_tpu_torch.models import clip as tclip
from videoprism_tpu_torch.models import init as tinit
from videoprism_tpu_torch.models import registry as treg
from videoprism_tpu_torch.models import text_encoder as tte
from videoprism_tpu_torch.ops import embeddings as temb
from videoprism_tpu_torch.ops import masks as tmasks
from videoprism_tpu_torch.ops import transformer as ttr

ATOL = 2e-5
OP_ATOL = 1e-5
TINY = dict(patch_size=6, pos_emb_shape=(4, 4, 4), num_spatial_layers=1,
            num_temporal_layers=1, mlp_dim=128, num_auxiliary_layers=2,
            vocabulary_size=128, enable_causal_atten=True,
            num_unimodal_layers=2, model_dim=64, num_heads=2,
            atten_logit_cap=50.0)
B, FRAMES, SIZE, TEXT_LEN = 2, 4, 24, 8


def _configs(**overrides):
  kw = {**TINY, **overrides}
  return jclip.VideoCLIPConfig(**kw), tclip.VideoCLIPConfig(**kw)


def _flat(tree, prefix=''):
  out = {}
  for k, v in tree.items():
    if isinstance(v, dict):
      out.update(_flat(v, f'{prefix}{k}/'))
    else:
      out[prefix + k] = tuple(v.shape)
  return out


@pytest.fixture(scope='module')
def tree():
  _, tcfg = _configs()
  return tinit.numpy_video_clip(0, tcfg, norm_bias_std=0.1)


def _video(seed):
  rng = np.random.default_rng(seed)
  return rng.standard_normal((B, FRAMES, SIZE, SIZE, 3)).astype(np.float32)


def _text(seed, length=TEXT_LEN, vocab=TINY['vocabulary_size']):
  """Seeded ids and paddings with ragged real lengths (one full row)."""
  rng = np.random.default_rng(seed)
  ids = rng.integers(0, vocab, size=(B, length)).astype(np.int32)
  lengths = np.array([length, 3])
  pads = (np.arange(length)[None, :] >= lengths[:, None]).astype(np.float32)
  return ids, pads


def _np(x):
  return None if x is None else np.asarray(x, np.float32)


@pytest.mark.parametrize('config', ['videoprism_lvt_v1_base',
                                    'videoprism_lvt_v1_large'])
def test_param_tree_matches_jax(config):
  """The CLIP tree is key-for-key and shape-for-shape the JAX
  ``init_video_clip`` tree (the checkpoint schema), at the lvt configs'
  depths with narrow widths (full widths would allocate ~1 GB here)."""
  kw = dict(treg.CONFIGS[config], model_dim=64, mlp_dim=96, num_heads=4,
            vocabulary_size=100)
  want = jax.eval_shape(lambda: jinit.init_video_clip(
      jax.random.PRNGKey(0), jclip.VideoCLIPConfig(**kw)))
  got = tinit.numpy_video_clip(0, tclip.VideoCLIPConfig(**kw))
  assert _flat(got) == _flat(want)
  assert 'auxiliary_encoder' in got and 'cls_emb' in got['text_encoder']


def test_token_embedding_and_sinusoid():
  rng = np.random.default_rng(0)
  table = rng.standard_normal((50, 24)).astype(np.float32)
  ids = rng.integers(0, 50, size=(3, 7))
  for scale in (True, False):
    want = jemb.token_embedding({'emb_var': jnp.asarray(table)},
                                jnp.asarray(ids), num_classes=50,
                                scale_sqrt_depth=scale)
    got = temb.token_embedding({'emb_var': torch.from_numpy(table)},
                               torch.from_numpy(ids), scale_sqrt_depth=scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=OP_ATOL,
                               rtol=0)
  for length, dim in ((65, 768), (9, 15)):
    want = jemb.sinusoidal_positional_embedding(length, dim)
    got = temb.sinusoidal_positional_embedding(length, dim)
    assert tuple(got.shape) == (1, length, dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=OP_ATOL,
                               rtol=0)
  got32 = temb.sinusoidal_positional_embedding(65, 768)
  got16 = temb.sinusoidal_positional_embedding(65, 768, dtype=torch.bfloat16)
  assert got16.dtype == torch.bfloat16
  np.testing.assert_array_equal(got16.float().numpy(),
                                got32.to(torch.bfloat16).float().numpy())


@pytest.mark.parametrize('causal', [True, False])
def test_text_encoder_matches_jax(tree, causal):
  """The text tower, padded ids, causal or not; every real token."""
  jcfg, tcfg = _configs(enable_causal_atten=causal)
  ids, pads = _text(1)
  sub = tree['text_encoder']
  want = jte.apply(jax.tree.map(jnp.asarray, sub), jnp.asarray(ids),
                   jnp.asarray(pads), jcfg.text_config())
  got = tte.apply(params_from_numpy(sub, device='cpu'), torch.from_numpy(ids),
                  torch.from_numpy(pads), tcfg.text_config())
  assert tuple(got.shape) == (B, TEXT_LEN + 1, TINY['model_dim'])
  real = np.concatenate([pads, np.zeros((B, 1), np.float32)], -1) == 0
  np.testing.assert_allclose(got.numpy()[real], np.asarray(want)[real],
                             atol=ATOL, rtol=0)


def test_atten_token_pooling_matches_jax(tree):
  sub = tree['contrastive_vision_pooler']
  tokens = np.random.default_rng(2).standard_normal(
      (B, 40, TINY['model_dim'])).astype(np.float32)
  want = jtr.atten_token_pooling(
      jax.tree.map(jnp.asarray, sub), jnp.asarray(tokens), None,
      num_heads=TINY['num_heads'], hidden_dim=4 * TINY['model_dim'])
  got = ttr.atten_token_pooling(
      params_from_numpy(sub, device='cpu'), torch.from_numpy(tokens), None,
      num_heads=TINY['num_heads'], hidden_dim=4 * TINY['model_dim'])
  assert tuple(got.shape) == (B, 1, TINY['model_dim'])
  np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                             rtol=0)


def _both(tree, video, ids, pads, **kwargs):
  jcfg, tcfg = _configs()
  jp = jax.tree.map(jnp.asarray, tree)
  want = jclip.apply(jp, None if video is None else jnp.asarray(video),
                     None if ids is None else jnp.asarray(ids),
                     None if pads is None else jnp.asarray(pads), jcfg,
                     **kwargs)
  tp = prepare_for_kernels(params_from_numpy(tree, device='cpu'))
  got = tclip.apply(tp, None if video is None else torch.from_numpy(video),
                    None if ids is None else torch.from_numpy(ids),
                    None if pads is None else torch.from_numpy(pads), tcfg,
                    **kwargs)
  return got, want


@pytest.mark.parametrize('request_kind', ['video', 'text', 'both'])
def test_clip_apply_matches_jax(tree, request_kind):
  video = _video(3) if request_kind != 'text' else None
  ids, pads = _text(4) if request_kind != 'video' else (None, None)
  (gv, gt, _), (wv, wt, _) = _both(tree, video, ids, pads)
  for got, want in ((gv, wv), (gt, wt)):
    assert (got is None) == (want is None)
    if got is not None:
      assert tuple(got.shape) == (B, TINY['model_dim'])
      np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                 rtol=0)


def test_clip_intermediates_match_jax(tree):
  """frame_embeddings, spatiotemporal_features and normalize=False."""
  video = _video(5)
  keys = ('frame_embeddings', 'spatiotemporal_features')
  (gv, _, gouts), (wv, _, wouts) = _both(
      tree, video, None, None, return_intermediate=keys, normalize=False)
  assert set(gouts) == set(wouts) == set(keys)
  assert tuple(gouts['frame_embeddings'].shape) == (B, FRAMES,
                                                   TINY['model_dim'])
  for k in keys:
    np.testing.assert_allclose(gouts[k].numpy(), np.asarray(wouts[k]),
                               atol=ATOL, rtol=0)
  np.testing.assert_allclose(gv.numpy(), np.asarray(wv), atol=ATOL, rtol=0)
  jcfg, tcfg = _configs()
  tp = params_from_numpy(tree, device='cpu')
  feats = gouts['spatiotemporal_features']
  pooled = tclip.pool_vision_tokens(tp, feats, tcfg)
  frames = tclip.frame_embeddings_from_tokens(tp, feats, tcfg,
                                              num_frames=FRAMES)
  jp = jax.tree.map(jnp.asarray, tree)
  jfeats = jnp.asarray(feats.numpy())
  np.testing.assert_allclose(
      pooled.numpy(), np.asarray(jclip.pool_vision_tokens(jp, jfeats, jcfg)),
      atol=ATOL, rtol=0)
  np.testing.assert_allclose(
      frames.numpy(),
      np.asarray(jclip.frame_embeddings_from_tokens(jp, jfeats, jcfg,
                                                    num_frames=FRAMES)),
      atol=ATOL, rtol=0)


def test_aux_layer_composed_route_matches_jax():
  """A layer over T > 1024 tokens (the auxiliary encoder's 4096 at base)
  takes the composed attention half: K6 LayerNorm and K5 attention (their
  twins here), then K2; held against the JAX composed route."""
  d, heads, t = 32, 2, 1152
  jlayer = jtr.TransformerLayerConfig(
      num_layers=1, hidden_dim=64, num_heads=heads, activation='gelu',
      enable_per_dim_scale=False, logit_cap=50.0)
  tlayer = ttr.TransformerLayerConfig(
      num_layers=1, hidden_dim=64, num_heads=heads, activation='gelu',
      enable_per_dim_scale=False, logit_cap=50.0)
  init = tinit._Init(7, 0.1)
  params = init.layer(d, tlayer)
  x = np.random.default_rng(8).standard_normal((1, t, d)).astype(np.float32)
  pads = np.zeros((1, t), np.float32)
  pads[0, -5:] = 1.0
  want = jtr.transformer_layer(
      jax.tree.map(jnp.asarray, params), jnp.asarray(x), jnp.asarray(pads),
      jmasks.paddings_to_mask(jnp.asarray(pads)), jlayer)
  tx = torch.from_numpy(x)
  got = ttr.transformer_layer(
      params_from_numpy(params, device='cpu'), tx, torch.from_numpy(pads),
      tmasks.paddings_to_mask(torch.from_numpy(pads)), tlayer)
  assert not ttr.fused_attention_supported(
      t, tmasks.paddings_to_mask(torch.from_numpy(pads)))
  np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                             rtol=0)


def test_bf16_clip_stays_near_jax_bf16(tree):
  """The served dtype: the port's bf16 twins against the JAX package's bf16
  'xla' path.  Both round to bf16 at different points (the twins keep
  fp32 logits and LN statistics, as the TPU kernels do), so the embeddings
  are held at the kernel cases' atol = rtol = 2e-2 and a per-embedding
  cosine of 0.999."""
  jcfg, tcfg = _configs(dtype=jnp.bfloat16)
  jcfg = dataclasses.replace(jcfg, dtype=jnp.bfloat16)
  tcfg = dataclasses.replace(tcfg, dtype=torch.bfloat16)
  video, (ids, pads) = _video(9), _text(10)
  want_v, want_t, _ = jclip.apply(
      jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), tree),
      jnp.asarray(video), jnp.asarray(ids), jnp.asarray(pads), jcfg)
  got_v, got_t, _ = tclip.apply(
      params_from_numpy(tree, device='cpu', dtype=torch.bfloat16),
      torch.from_numpy(video), torch.from_numpy(ids), torch.from_numpy(pads),
      tcfg)
  for got, want in ((got_v, want_v), (got_t, want_t)):
    assert got.dtype == torch.bfloat16
    want = torch.from_numpy(_np(want))
    np.testing.assert_allclose(got.float().numpy(), want.numpy(), atol=2e-2,
                               rtol=2e-2)
    cos = torch.nn.functional.cosine_similarity(got.float(), want, dim=-1)
    assert cos.min().item() >= 0.999, cos


def test_clip_model_handle(tree):
  """get_model builds a CLIP Model with the JAX calling convention; init
  is seeded and lands on the device asked for."""
  _, tcfg = _configs()
  model = treg.Model(tcfg)
  assert model.is_clip
  variables = model.init(0, device='cpu', norm_bias_std=0.1)
  video, (ids, pads) = _video(11), _text(12)
  a = model.apply(variables, torch.from_numpy(video), torch.from_numpy(ids),
                  torch.from_numpy(pads))
  b = tclip.apply(params_from_numpy(tree, device='cpu'),
                  torch.from_numpy(video), torch.from_numpy(ids),
                  torch.from_numpy(pads), tcfg, impl='reference')
  assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
  _, t_only, outs = model.apply(variables, text_token_ids=torch.from_numpy(ids),
                                text_paddings=torch.from_numpy(pads))
  assert torch.equal(t_only, a[1]) and outs == {}
  with pytest.raises(ValueError, match='text_paddings'):
    model.apply(variables, text_token_ids=torch.from_numpy(ids))


def test_clip_golden_fixture_regenerates_and_port_matches():
  """tests/data/torch_port_clip_golden.npz (JAX fp32 embeddings of a tiny
  config whose auxiliary encoder sees 1152 tokens) regenerates, and the
  port's CPU path matches it in fp32."""
  import json
  import os
  import sys

  root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
  sys.path.insert(0, os.path.join(root, 'scripts'))
  import make_torch_clip_golden as golden

  path = os.path.join(root, 'tests', 'data', 'torch_port_clip_golden.npz')
  stored = np.load(path)
  assert json.loads(str(stored['config'])) == golden.CONFIG
  fresh = golden.make_golden()
  pos_emb_shape = tuple(golden.CONFIG['pos_emb_shape'])
  cfg = tclip.VideoCLIPConfig(
      **golden.CONFIG | {'pos_emb_shape': pos_emb_shape})
  params = prepare_for_kernels(tinit.init_video_clip(
      int(stored['param_seed']), cfg, device='cpu',
      norm_bias_std=float(stored['norm_bias_std'])))
  video, ids, pads = golden.make_inputs(
      int(stored['input_seed']), tuple(stored['video_shape']),
      tuple(stored['text_lengths']), cfg.vocabulary_size)
  assert video.shape[1] * (video.shape[2] // cfg.patch_size) ** 2 > \
      ttr.MAX_FUSED_ATTENTION_T
  got_v, got_t, outs = tclip.apply(
      params, torch.from_numpy(video), torch.from_numpy(ids),
      torch.from_numpy(pads), cfg, return_intermediate=('frame_embeddings',))
  for key, got in (('video_embeddings', got_v), ('text_embeddings', got_t),
                   ('frame_embeddings', outs['frame_embeddings'])):
    np.testing.assert_allclose(fresh[key], stored[key], atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), stored[key], atol=ATOL, rtol=0)
  assert os.path.getsize(path) < 50_000

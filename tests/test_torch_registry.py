"""videoprism_tpu_torch's param tree, weight bridge, registry and golden
fixture against the JAX package, on the CPU."""

import inspect
import json
import os
import subprocess
import sys

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from videoprism_tpu.io import checkpoints as jckpt
from videoprism_tpu.models import factorized_encoder as jfe
from videoprism_tpu.models import init as jinit
from videoprism_tpu.models import registry as jreg
import videoprism_tpu_torch as vpt
from videoprism_tpu_torch.io import checkpoints as tckpt
from videoprism_tpu_torch.models import factorized_encoder as tfe
from videoprism_tpu_torch.models import init as tinit
from videoprism_tpu_torch.models import registry as treg

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(_ROOT, 'scripts'))

import make_torch_port_golden as golden  # noqa: E402

GOLDEN = os.path.join(_ROOT, 'tests', 'data', 'torch_port_golden.npz')
TINY = tfe.FactorizedEncoderConfig(
    **golden.CONFIG | {'pos_emb_shape': tuple(golden.CONFIG['pos_emb_shape'])})


def _flat(tree, prefix=''):
  out = {}
  for k, v in tree.items():
    if isinstance(v, dict):
      out.update(_flat(v, f'{prefix}{k}/'))
    else:
      out[prefix + k] = tuple(v.shape)
  return out


def test_param_tree_matches_jax():
  """Base config: leaf names and shapes equal the JAX init's
  (scan-stacked layout)."""
  name = 'videoprism_v1_base'
  jcfg = jfe.FactorizedEncoderConfig(**jreg.CONFIGS[name])
  want = jax.eval_shape(
      lambda: jinit.init_factorized_encoder(jax.random.PRNGKey(0), jcfg))
  got = tinit.numpy_factorized_encoder(
      0, tfe.FactorizedEncoderConfig(**treg.CONFIGS[name]))
  assert _flat(got) == _flat(want)


def test_configs_match_jax():
  for name, cfg in treg.CONFIGS.items():
    assert cfg == jreg.CONFIGS[name]
  assert set(treg.MODELS) <= set(jreg.MODELS)


def test_init_is_seeded():
  cfg = TINY
  a = tinit.numpy_factorized_encoder(3, cfg, norm_bias_std=0.1)
  b = tinit.numpy_factorized_encoder(3, cfg, norm_bias_std=0.1)
  c = tinit.numpy_factorized_encoder(4, cfg)
  ka = jckpt.tree_flatten_with_names(a)
  kb = dict(jckpt.tree_flatten_with_names(b))
  for k, v in ka:
    np.testing.assert_array_equal(v, kb[k])
  ln = c['spatial_ln']
  assert not ln['scale'].any() and not ln['bias'].any()
  assert a['spatial_ln']['scale'].any()


def test_bridge_round_trips():
  cfg = TINY
  tree = tinit.numpy_factorized_encoder(0, cfg, norm_bias_std=0.1)
  tree['step'] = np.array(7, np.int32)
  params = tckpt.params_from_numpy(tree, device='cpu')
  back = {k: v.numpy() for k, v in
          jckpt.tree_flatten_with_names(jax.tree.map(lambda t: t, params))}
  for k, v in jckpt.tree_flatten_with_names(tree):
    np.testing.assert_array_equal(back[k], v)
  assert params['step'].dtype == torch.int32
  # bf16 numpy leaves (as JAX hands them out) go through float32.
  bf = tckpt.params_from_numpy({'w': np.ones(3, ml_dtypes.bfloat16)},
                               device='cpu', dtype=torch.bfloat16)
  assert bf['w'].dtype == torch.bfloat16 and bf['w'].sum().item() == 3.0


def test_load_checkpoint_npz_and_pretrained(tmp_path):
  cfg = TINY
  tree = tinit.numpy_factorized_encoder(0, cfg, norm_bias_std=0.1)
  path = str(tmp_path / 'ckpt.npz')
  jckpt.save_checkpoint(path, tree)   # the JAX package's flat-key writer
  loaded = tckpt.load_checkpoint(path)
  assert jckpt.tree_flatten_with_names(loaded)[0][0] == \
      jckpt.tree_flatten_with_names(tree)[0][0]
  params = treg.load_pretrained_weights('videoprism_public_v1_base',
                                        checkpoint_path=path, device='cpu')
  np.testing.assert_array_equal(
      params['spatial_encoder']['transformers_stack']['x_layers'][
          'self_attention']['query']['w'].numpy(),
      tree['spatial_encoder']['transformers_stack']['x_layers'][
          'self_attention']['query']['w'])
  with pytest.raises(ValueError, match='checkpoint_path'):
    treg.load_pretrained_weights('videoprism_public_v1_base')


def test_prepare_for_kernels_fuses_projections():
  cfg = TINY
  params = tinit.init_factorized_encoder(0, cfg, device='cpu',
                                         dtype=torch.bfloat16)
  prepared = tckpt.prepare_for_kernels(params)
  attn = prepared['temporal_encoder']['transformers_stack']['x_layers'][
      'self_attention']
  assert tuple(attn['fused']['wqkv'].shape) == (2, 128, 3 * 128)
  assert tuple(attn['fused']['bqkv'].shape) == (2, 3 * 128)
  assert tuple(attn['fused']['wo'].shape) == (2, 128, 128)
  assert attn['fused']['wqkv'].dtype == torch.bfloat16
  wq = attn['query']['w'][1].reshape(128, 128)
  assert torch.equal(attn['fused']['wqkv'][1, :, :128], wq)
  assert 'fused' not in params['temporal_encoder']['transformers_stack'][
      'x_layers']['self_attention']


def test_registry_surface(tmp_path, monkeypatch):
  assert vpt.has_model('videoprism_public_v1_base')
  assert vpt.has_model('google/videoprism-large-f8r288')
  model = vpt.get_model('google/videoprism-base-f16r288',
                        fprop_dtype=torch.bfloat16)
  assert model.config.dtype == torch.bfloat16 and not model.is_clip
  assert model.config.model_dim == 768 and model.config.atten_logit_cap == 50.0
  for name, hf_id, width in (
      ('videoprism_lvt_public_v1_base', 'google/videoprism-lvt-base-f16r288',
       768),
      ('videoprism_lvt_public_v1_large',
       'google/videoprism-lvt-large-f8r288', 1024)):
    assert vpt.has_model(name) and vpt.has_model(hf_id)
    for key in (name, hf_id):
      clip = vpt.get_model(key, fprop_dtype=torch.bfloat16)
      assert clip.is_clip and clip.config.dtype == torch.bfloat16
      assert clip.config.model_dim == width
      assert clip.config.vocabulary_size == 32_000
      assert clip.config.num_auxiliary_layers == 2
  # Classifiers are built by their functions, not looked up by name, in
  # the JAX package as here.
  assert not vpt.has_model('videoprism_vc_v1_base')
  assert not jreg.has_model('videoprism_vc_v1_base')
  with pytest.raises(ValueError, match='not found'):
    jreg.get_model('videoprism_vc_v1_base')
  with pytest.raises(ValueError, match='not found'):
    vpt.get_model('videoprism_vc_v1_base')
  vc = vpt.videoprism_vc_v1_large(400)
  assert vc.is_classifier and not vc.is_clip
  assert vc.config.num_classes == 400 and vc.config.encoder.model_dim == 1024
  with pytest.raises(ValueError, match='not found'):
    vpt.get_model('videoprism_public_v9')
  # load_model / load_video_encoder: the JAX signatures (the port adds only
  # the device) and the JAX refusals, given an npz so that no download is
  # tried: a non-lvt name to load_model, an lvt name to
  # load_video_encoder, an unknown quantize mode.
  for name in ('load_model', 'load_video_encoder'):
    want = inspect.signature(getattr(jreg, name)).parameters
    got = inspect.signature(getattr(vpt, name)).parameters
    assert list(got)[:len(want)] == list(want) and list(got)[len(want):] == [
        'device'], (name, list(got))
    for key, param in want.items():
      assert (got[key].kind, got[key].default) == (param.kind,
                                                   param.default), key
  path = str(tmp_path / 'ckpt.npz')
  jckpt.save_checkpoint(path, tinit.numpy_factorized_encoder(0, TINY))
  for call, match in (
      (lambda m: m.load_model('videoprism_public_v1_base', path),
       'not a video-text'),
      (lambda m: m.load_video_encoder('videoprism_lvt_public_v1_base', path),
       'is a video-text model'),
      (lambda m: m.load_video_encoder('videoprism_public_v1_base', path,
                                      quantize='int4'),
       "unknown quantize mode 'int4'")):
    for module in (jreg, treg):
      with pytest.raises(ValueError, match=match):
        call(module)
  # The port has no download: a missing file names the paths tried, and
  # the files the JAX package reads besides npz are not ported yet.
  monkeypatch.chdir(tmp_path)
  with pytest.raises(FileNotFoundError, match=r'weights/videoprism_public_v1'
                     r'_base\.npz'):
    treg.load_video_encoder('videoprism_public_v1_base', device='cpu')
  for bad in ('ckpt.safetensors', 'ckpt_mlx.npz'):
    with pytest.raises(ValueError, match='item 1'):
      treg.load_video_encoder('videoprism_public_v1_base', bad, device='cpu')


def test_entry_points_default_to_the_card(tmp_path):
  """Params land on the card unless the caller asks for the CPU; with no
  card the default raises instead of running on the CPU."""
  tree = tinit.numpy_factorized_encoder(0, TINY)
  path = str(tmp_path / 'ckpt.npz')
  jckpt.save_checkpoint(path, tree)
  calls = (
      lambda: tckpt.params_from_numpy(tree),
      lambda: tinit.init_factorized_encoder(0, TINY),
      lambda: treg.Model(TINY).init(0),
      lambda: treg.load_pretrained_weights(None, checkpoint_path=path),
      lambda: treg.load_video_encoder('videoprism_public_v1_base', path,
                                      quantize='int8').params,
  )
  for call in calls:
    if torch.cuda.is_available():
      leaf = jckpt.tree_flatten_with_names(call())[0][1]
      assert leaf.is_cuda
    else:
      with pytest.raises(RuntimeError, match="device='cpu'"):
        call()


def test_model_apply_takes_params_wrapper():
  model = treg.Model(TINY)
  variables = model.init(0, device='cpu', norm_bias_std=0.1)
  video = torch.from_numpy(np.random.default_rng(0).standard_normal(
      (1, 4, 24, 24, 3)).astype(np.float32))
  a, _ = model.apply(variables, video)
  b, _ = model.apply(variables['params'], video, impl='reference')
  assert tuple(a.shape) == (1, 64, 128) and torch.equal(a, b)


def test_package_imports_without_jax():
  code = ('import sys, videoprism_tpu_torch, videoprism_tpu_torch.ops.kernels.'
          'cases; assert "jax" not in sys.modules, sorted(sys.modules); '
          'assert not any(m.startswith("videoprism_tpu.") or '
          'm == "videoprism_tpu" for m in sys.modules)')
  subprocess.run([sys.executable, '-c', code], check=True, cwd=_ROOT,
                 timeout=120)


def test_golden_fixture_regenerates_and_port_matches():
  stored = np.load(GOLDEN)
  fresh = golden.make_golden()
  assert json.loads(str(stored['config'])) == golden.CONFIG
  np.testing.assert_allclose(fresh['output'], stored['output'], atol=2e-5,
                             rtol=0)
  cfg = TINY
  params = tinit.init_factorized_encoder(
      int(stored['param_seed']), cfg, device='cpu',
      norm_bias_std=float(stored['norm_bias_std']))
  video = np.random.default_rng(int(stored['video_seed'])).standard_normal(
      tuple(stored['video_shape'])).astype(np.float32)
  got, _ = tfe.apply(params, torch.from_numpy(video), cfg)
  np.testing.assert_allclose(got.numpy(), stored['output'], atol=2e-5, rtol=0)
  assert os.path.getsize(GOLDEN) < 200_000


def test_load_int8_matches_jax(tmp_path, monkeypatch):
  """load_video_encoder and load_model with quantize='int8' from a seeded
  fp32 npz against the JAX functions of the same name, on tiny configs put
  in both registries under the base names: the JAX int8 kernels in
  interpret mode against the port's twins (the encoder in fp32 and bf16,
  the lvt model in fp32; tolerances of tests/test_torch_int8.py: fp32
  tokens 90 % within 1e-5, every cosine >= 0.9999, bf16 >= 0.999), and
  attention_impl='xla' warning on both sides and giving the dequantized
  float path (fp32 atol 2e-5, the port's model gate)."""
  import jax.numpy as jnp

  sys.path.insert(0, os.path.join(_ROOT, 'scripts'))
  import make_torch_int8_golden as int8_golden

  tiny = lambda cfg: dict(cfg, pos_emb_shape=tuple(cfg['pos_emb_shape']))
  enc_cfg, clip_cfg = (tiny(int8_golden.ENCODER_CONFIG),
                       tiny(int8_golden.CLIP_CONFIG))
  clip_cfg.pop('vocabulary_size')
  for reg in (jreg, treg):
    monkeypatch.setitem(reg.CONFIGS, 'videoprism_v1_base', enc_cfg)
    monkeypatch.setitem(reg.CONFIGS, 'videoprism_lvt_v1_base', clip_cfg)
  video, ids, pads, enc_video, *_ = int8_golden.make_inputs()

  def cosines(got, want):
    got, want = got.reshape(-1, got.shape[-1]), want.reshape(-1,
                                                            want.shape[-1])
    return np.sum(got * want, -1) / (np.linalg.norm(got, axis=-1)
                                     * np.linalg.norm(want, axis=-1))

  def run(name, inputs, dtype=None, **kw):
    """(port, JAX) outputs of the loader ``name`` on a seeded npz."""
    jax_dtype = {torch.bfloat16: jnp.bfloat16}.get(dtype)
    bound = getattr(jreg, name)(model_key, path, fprop_dtype=jax_dtype, **kw)
    jax_out = jreg.BoundModel(
        bound.model.replace_config(kernel_interpret=True), bound.params)(
            *map(jnp.asarray, inputs))
    port_out = getattr(treg, name)(model_key, path, fprop_dtype=dtype,
                                   device='cpu', **kw)(
                                       *map(torch.from_numpy, inputs))
    pick = lambda out: [o for o in out if o is not None and not isinstance(
        o, dict)]
    return ([o.float().numpy() for o in pick(port_out)],
            [np.asarray(jnp.asarray(o, jnp.float32)) for o in pick(jax_out)])

  model_key = 'videoprism_public_v1_base'
  path = str(tmp_path / 'encoder.npz')
  tckpt.save_checkpoint(path, tinit.numpy_factorized_encoder(
      0, tfe.FactorizedEncoderConfig(**enc_cfg), norm_bias_std=0.1))
  for dtype in (None, torch.bfloat16):
    (got,), (want,) = run('load_video_encoder', (enc_video,), dtype,
                          quantize='int8')
    if dtype is None:
      assert (np.abs(got - want) <= 1e-5).mean() >= 0.9
      assert cosines(got, want).min() >= 0.9999
    else:
      assert cosines(got, want).min() >= 0.999
  for module in (jreg, treg):
    with pytest.warns(UserWarning, match="attention_impl='flash'"):
      module.load_video_encoder(model_key, path, quantize='int8',
                                attention_impl='xla',
                                **({'device': 'cpu'} if module is treg
                                   else {}))
  with pytest.warns(UserWarning):
    (got,), (want,) = run('load_video_encoder', (enc_video,),
                          quantize='int8', attention_impl='xla')
  np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)

  model_key = 'videoprism_lvt_public_v1_base'
  path = str(tmp_path / 'lvt.npz')
  tckpt.save_checkpoint(path, tinit.numpy_video_clip(
      0, treg.get_model(model_key).config, norm_bias_std=0.1))
  got, want = run('load_model', (video, ids, pads), quantize='int8')
  assert len(got) == len(want) == 2
  for g, w in zip(got, want):
    assert cosines(g, w).min() >= 0.9999
